"""Synthetic genomes, HiFi reads and Hi-C pairs, from a numpy Generator.

Frozen for the benchmark from the repository's test generators
(``tests/synth.py`` ``make_genome``, ``sample_reads_hifi``,
``inject_errors``, ``inject_errors_hifi``; ``tests/synth_human.py``
``make_human_proxy_genome``): the same genome architectures and error
models, with the error injection done in array operations (a read at a
time for HiFi, the whole library at once for Hi-C mates), so that a
run's set-up makes 18 Mb of reads in under a second.  NumPy only;
nothing here imports the program.
"""

from __future__ import annotations

import numpy as np


def unique_genome(rng, length: int, repeat_frac: float = 0.0):
    """A uniform random genome with, if ``repeat_frac`` > 0, three exact
    copies of its first ``length * repeat_frac / 4`` bases planted at
    random places (``make_genome``)."""
    g = rng.integers(0, 4, length).astype(np.uint8)
    if repeat_frac > 0:
        rep_len = max(200, int(length * repeat_frac / 4))
        src = g[:rep_len].copy()
        for _ in range(3):
            p = int(rng.integers(rep_len, length - rep_len))
            g[p:p + rep_len] = src
    return g


def _mutate(rng, seq: np.ndarray, div: float) -> np.ndarray:
    out = seq.copy()
    m = rng.random(len(out)) < div
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return out


def revcomp(seq: np.ndarray) -> np.ndarray:
    return (3 - seq[::-1]).astype(np.uint8)


def proxy_genome(rng, length: int) -> np.ndarray:
    """A genome with the repeat architecture of a pericentromeric human
    slice (``make_human_proxy_genome``): an alpha-satellite higher-order
    repeat array (~10%: 171 bp monomers 10% apart, six to a ~1 kb unit,
    units 1% apart), 5'-truncated copies of a 6 kb LINE at 80-95%
    identity (~12%), STR and VNTR runs (~3%), and segmental duplications
    of 10-30 kb at 96-99% identity, some inverted (~8%), planted last."""
    g = rng.integers(0, 4, length).astype(np.uint8)

    def plant(arr, pos):
        end = min(pos + len(arr), length)
        g[pos:end] = arr[:end - pos]

    sat_len = int(length * 0.10)
    base = rng.integers(0, 4, 171).astype(np.uint8)
    hor = np.concatenate([_mutate(rng, base, 0.10) for _ in range(6)])
    sat = np.concatenate([_mutate(rng, hor, 0.01)
                          for _ in range(max(sat_len // len(hor), 4))])
    sat_pos = int(length * 0.45)
    plant(sat, sat_pos)

    line = rng.integers(0, 4, 6000).astype(np.uint8)
    used = 0
    while used < int(length * 0.12):
        cut = 0 if rng.random() < 0.1 else int(rng.integers(1000, 5500))
        frag = _mutate(rng, line[cut:], float(rng.uniform(0.05, 0.20)))
        if rng.random() < 0.5:
            frag = revcomp(frag)
        pos = int(rng.integers(0, length - len(frag)))
        if abs(pos - sat_pos) < sat_len:
            continue
        plant(frag, pos)
        used += len(frag)

    for motif_len, copies in ((2, 400), (3, 300), (4, 200), (32, 40),
                              (2, 600), (3, 250)):
        motif = rng.integers(0, 4, motif_len).astype(np.uint8)
        arr = _mutate(rng, np.tile(motif, copies), 0.02)
        pos = int(rng.integers(0, length - len(arr)))
        if abs(pos - sat_pos) < sat_len:
            continue
        plant(arr, pos)

    used = 0
    while used < int(length * 0.08):
        dlen = int(rng.integers(10_000, 30_000))
        src = int(rng.integers(0, length - dlen))
        dst = int(rng.integers(0, length - dlen))
        if abs(src - dst) < dlen * 2:
            continue
        dup = _mutate(rng, g[src:src + dlen], float(rng.uniform(0.01, 0.04)))
        if rng.random() < 0.3:
            dup = revcomp(dup)
        plant(dup, dst)
        used += dlen
    return g


def add_snps(rng, g: np.ndarray, het_rate: float) -> np.ndarray:
    """A second haplotype: ``g`` with a substitution at each base with
    probability ``het_rate``."""
    h2 = g.copy()
    sites = rng.random(len(g)) < het_rate
    h2[sites] = (h2[sites] + rng.integers(1, 4, int(sites.sum()))) % 4
    return h2


def _uniform_errors(rng, seq: np.ndarray, bounds: np.ndarray,
                    rate: float):
    """``inject_errors`` on every record of a concatenated library at
    once: Poisson(``rate`` x length) uniform sites a record, 20%
    substitutions, 40% duplications of the base, 40% deletions.
    ``bounds`` holds the records' start offsets and the total; returns
    the new library and its bounds."""
    lens = np.diff(bounds)
    rec = np.repeat(np.arange(len(lens)), rng.poisson(rate * lens))
    sites = np.unique(bounds[:-1][rec] +
                      (rng.random(len(rec)) * lens[rec]).astype(np.int64))
    kind = rng.random(len(sites))
    out = seq.copy()
    sub = sites[kind < 0.2]
    out[sub] = (out[sub] + rng.integers(1, 4, len(sub))) % 4
    count = np.ones(len(seq), np.int64)
    count[sites[(kind >= 0.2) & (kind < 0.6)]] = 2
    count[sites[kind >= 0.6]] = 0
    new_bounds = np.concatenate([[0], np.cumsum(count)])[bounds]
    return np.repeat(out, count), new_bounds


def _hifi_errors(rng, seg: np.ndarray, rate: float) -> np.ndarray:
    """``inject_errors_hifi``: Poisson(``rate`` x length) sites, each
    weighted by the length of its homopolymer run (at most 8; 0.12
    outside runs); 10% substitutions, 45% duplications of the base, 45%
    deletions."""
    n_err = int(rng.poisson(rate * len(seg)))
    if n_err == 0:
        return seg
    same = np.concatenate([[False], seg[1:] == seg[:-1]])
    run_id = np.cumsum(~same) - 1
    run_len = np.bincount(run_id)[run_id]
    cw = np.cumsum(np.where(run_len >= 2, np.minimum(run_len, 8), 0.12))
    sites = np.unique(np.minimum(
        np.searchsorted(cw, rng.random(n_err) * cw[-1], side="right"),
        len(seg) - 1))
    kind = rng.random(len(sites))
    out = seg.copy()
    sub = sites[kind < 0.10]
    out[sub] = (out[sub] + rng.integers(1, 4, len(sub))) % 4
    count = np.ones(len(seg), np.int64)
    count[sites[(kind >= 0.10) & (kind < 0.55)]] = 2
    count[sites[kind >= 0.55]] = 0
    return np.repeat(out, count)


def _segment(genome: np.ndarray, start: int, n: int, strand: int):
    seg = genome[start:start + n]
    return revcomp(seg) if strand else seg.copy()


def hifi_reads(rng, genome: np.ndarray, depth: float, mean_len: int,
               err_rate: float, chimera_frac: float, sigma: float):
    """A HiFi library of ``genome`` (``sample_reads_hifi``): log-normal
    lengths of mean ``mean_len`` (CV about ``sigma``, clipped to 800 bp
    and the genome), either strand, until ``depth`` x the genome is
    drawn; a ``chimera_frac`` share of reads are two random segments of
    either strand joined (halves of at least 400 bp); errors at
    ``err_rate`` (``_hifi_errors``).  Returns the reads as uint8 code
    arrays, and where each was drawn from: an int64 array (reads, 2, 3)
    of (start, length, strand) for its first and second segment, the
    second of length 0 unless the read is chimeric."""
    L = len(genome)
    total = int(depth * L)
    mu = np.log(mean_len) - 0.5 * sigma * sigma
    n = int(total / mean_len * 1.3) + 16
    lens = np.clip(rng.lognormal(mu, sigma, n), 800, L - 1).astype(np.int64)
    lens = lens[:int(np.searchsorted(np.cumsum(lens), total)) + 1]
    chim = rng.random(len(lens)) < chimera_frac
    strand = rng.integers(0, 2, (len(lens), 2))
    frac = rng.random((len(lens), 2))
    reads = []
    origins = np.zeros((len(lens), 2, 3), np.int64)
    for i, rl in enumerate(lens.tolist()):
        parts = [rl]
        if chim[i]:
            parts = [max(400, rl // 2)]
            parts.append(max(400, rl - parts[0]))
        segs = []
        for j, p in enumerate(parts):
            start = int(frac[i, j] * (L - p + 1))
            origins[i, j] = (start, p, strand[i, j])
            segs.append(_segment(genome, start, p, strand[i, j]))
        reads.append(_hifi_errors(rng, np.concatenate(segs), err_rate))
    return reads, origins


def hic_pairs(rng, hap: np.ndarray, n_pairs: int, mate_len: int,
              err_rate: float):
    """Hi-C pairs of one haplotype: both mates forward-strand
    ``mate_len``-base copies from uniform positions, with errors at
    ``err_rate`` (20% substitutions, 40% insertions, 40% deletions, at
    uniform sites).  Returns two (codes, bounds) libraries, mate 1 and
    mate 2."""
    pos = rng.integers(0, len(hap) - mate_len, (2, n_pairs))
    out = []
    for m in range(2):
        raw = hap[pos[m][:, None] + np.arange(mate_len)].ravel()
        bounds = np.arange(n_pairs + 1, dtype=np.int64) * mate_len
        out.append(_uniform_errors(rng, raw, bounds, err_rate))
    return out
