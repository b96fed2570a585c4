"""The general generator of this benchmark's inputs: a dataset of the
configuration's size and ploidy, with the traffic's architecture (a
genome, HiFi reads of every haplotype and, where the traffic asks for
them, Hi-C pairs), and from it one input for each Generator it is given.

The dataset is the traffic's own, made from its ``dataset_seed``, as a
user assembles one sample's reads: every run of a cell times the same
work.  Each input holds that dataset's reads in the order, and each read
on the strand, that its Generator draws (and its Hi-C pairs in the order
drawn), so no two assemblies see the same input.  Each input also holds
the truth that the comparison reads and the program never sees: the
haplotypes, and where each read was drawn from.  The limits of the
comparison are set on datasets of other seeds as well
(``make(..., dataset_seed=...)``).

Configuration keys read: ``genome_size``, ``ploidy`` (1 or 2),
``het_rate``.  Traffic keys read: ``genome`` (``proxy`` or ``unique``),
``dataset_seed``, ``repeat_frac`` (``unique`` only), ``depth`` (a
haplotype), ``mean_len``, ``sigma``, ``err_rate``, ``chimera_frac``,
``hic_pairs`` (a haplotype, 0 for none), ``hic_mate_len``,
``hic_err_rate``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from benchmark.inputs import synth

_ACGT = np.frombuffer(b"ACGTN", np.uint8)


@dataclass
class Input:
    reads: List[np.ndarray]          # HiFi reads, uint8 codes
    haps: List[np.ndarray]           # the truth the reads were drawn from
    hic: Optional[Tuple[str, str]]   # mate 1 and mate 2 FASTQ paths
    # int64 (reads, 2, 4): (haplotype, start, length, strand) of each
    # read's segments in the order it reads them, the second of length
    # 0 unless the read is chimeric
    origins: Optional[np.ndarray] = None

    def truth(self, i: int) -> np.ndarray:
        """The error-free sequence of read ``i``, as it reads."""
        return np.concatenate([
            synth.revcomp(self.haps[h][a:a + n]) if s else
            self.haps[h][a:a + n]
            for h, a, n, s in self.origins[i].tolist() if n] or
            [np.zeros(0, np.uint8)])


def _fastq(path: str, records: List[bytes], order) -> None:
    with open(path, "wb") as f:
        f.writelines(b"@p%d\n%s\n+\n%s\n" % (n, records[i],
                                               b"I" * len(records[i]))
                     for n, i in enumerate(order))


def _records(libs) -> List[bytes]:
    """ACGT text of every record of (codes, bounds) libraries."""
    out = []
    for seq, bounds in libs:
        text = _ACGT[seq].tobytes()
        out += [text[a:b] for a, b in zip(bounds[:-1].tolist(),
                                          bounds[1:].tolist())]
    return out


def _flip(origins: np.ndarray) -> np.ndarray:
    """The origins of reverse-complemented reads: segments in reverse
    order, each on the other strand."""
    out = origins.copy()
    two = origins[:, 1, 2] > 0
    out[two] = origins[two, ::-1]
    out[:, :, 3] ^= 1
    out[~two, 1] = 0
    return out


def make(rngs, config: dict, traffic: dict, scale: float,
         workdir: str, dataset_seed: Optional[int] = None) -> List[Input]:
    """One input for each Generator of ``rngs``, from the dataset at
    ``scale`` x the configuration's genome size (the Hi-C pairs scale
    with it); FASTQ files go to ``workdir``.  ``dataset_seed`` replaces
    the traffic's own."""
    size = int(config["genome_size"] * scale)
    ds = np.random.default_rng(traffic["dataset_seed"] if dataset_seed is
                               None else dataset_seed)
    if traffic["genome"] == "proxy":
        g = synth.proxy_genome(ds, size)
    elif traffic["genome"] == "unique":
        g = synth.unique_genome(ds, size, traffic["repeat_frac"])
    else:
        raise ValueError(f"unknown genome architecture {traffic['genome']!r}")
    haps = [g]
    if config["ploidy"] == 2:
        haps.append(synth.add_snps(ds, g, config["het_rate"]))
    reads, origins = [], []
    for k, h in enumerate(haps):
        r, o = synth.hifi_reads(ds, h, traffic["depth"], traffic["mean_len"],
                                traffic["err_rate"], traffic["chimera_frac"],
                                traffic["sigma"])
        reads += r
        origins.append(np.concatenate(
            [np.full(o.shape[:2] + (1,), k, np.int64), o], axis=2))
    origins = np.concatenate(origins)
    origins[origins[:, :, 2] == 0] = 0
    n_pairs = int(traffic["hic_pairs"] * scale)
    mates = None
    if n_pairs:
        libs = [synth.hic_pairs(ds, h, n_pairs, traffic["hic_mate_len"],
                                traffic["hic_err_rate"]) for h in haps]
        mates = [_records([lib[m] for lib in libs]) for m in range(2)]
    out = []
    for k, rng in enumerate(rngs):
        flip = rng.random(len(reads)) < 0.5
        perm = rng.permutation(len(reads))
        mine = [synth.revcomp(reads[i]) if flip[i] else reads[i]
                for i in perm]
        orig = np.where(flip[:, None, None], _flip(origins), origins)[perm]
        hic = None
        if mates:
            order = rng.permutation(len(mates[0]))
            hic = tuple(os.path.join(workdir, f"hic{k}_{m + 1}.fq")
                        for m in range(2))
            for path, recs in zip(hic, mates):
                _fastq(path, recs, order)
        out.append(Input(mine, haps, hic, orig))
    return out
