"""Exact k-mer comparison of an assembly's outputs with the true genome.

An assembler's answers are sequences: the corrected reads that error
correction leaves for the graph, and the contigs.  Each is held to the
haplotypes it was sampled from by its canonical 31-mers, the way
Merqury (Rhie et al., Genome Biology 2020) and yak judge assemblies
against k-mers of the truth:

- ``err_ppm``: of a sequence set's 31-mers, the share (per million) that
  occur in no haplotype: a base error puts up to 31 such k-mers in it;
- ``missed_pct``: of the haplotypes' distinct 31-mers, the share (%) that
  no contig holds: sequence the assembly left out or collapsed;
- ``phase_err_pct``: of the haplotype-specific 31-mers that the phased
  contigs hold, the share (%) from the haplotype that holds fewer of
  them in the same contig (yak's hamming error rate).

Codes are 0-3 for A, C, G, T; a window with any other code is skipped.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

K = 31
_NT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT[_c] = _i
    _NT[_c + 32] = _i


def codes_of(seq: bytes) -> np.ndarray:
    """ACGT text to codes 0-3 (anything else 4)."""
    return _NT[np.frombuffer(seq, np.uint8)]


def _forward(c: np.ndarray, k: int) -> np.ndarray:
    """2-bit codes of every k-window of ``c`` (uint64 codes 0-3), built
    by doubling: ``run[m][i]`` codes ``c[i:i + m]``."""
    run = {1: c}
    m = 1
    while 2 * m <= k:
        r = run[m]
        run[2 * m] = (r[:len(r) - m] << np.uint64(2 * m)) | r[m:]
        m *= 2
    acc, a = None, 0
    while m:
        if k & m:
            r = run[m]
            acc = r if acc is None else \
                (acc[:len(acc) - m] << np.uint64(2 * m)) | r[a:]
            a += m
        m //= 2
    return acc


def canonical_kmers(codes: np.ndarray, k: int = K) -> np.ndarray:
    """Canonical (min of forward and reverse-complement) 2-bit k-mers of
    every window of ``codes`` that holds only codes 0-3, uint64."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    c = (codes & 3).astype(np.uint64)
    fwd = _forward(c, k)
    rev = _forward(np.uint64(3) - c[::-1], k)[::-1]
    bad = np.convolve((codes > 3).astype(np.int32), np.ones(k, np.int32),
                      "valid") > 0
    return np.minimum(fwd, rev)[~bad]


def kmer_set(seqs: Iterable[np.ndarray]) -> np.ndarray:
    """Sorted distinct canonical k-mers of every sequence."""
    parts = [canonical_kmers(s) for s in seqs]
    return np.unique(np.concatenate(parts)) if parts else \
        np.zeros(0, np.uint64)


def member(q: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    """Whether each of ``q`` is in ``sorted_set``."""
    if len(sorted_set) == 0:
        return np.zeros(len(q), bool)
    i = np.minimum(np.searchsorted(sorted_set, q), len(sorted_set) - 1)
    return sorted_set[i] == q


class Truth:
    """The haplotypes an input was sampled from, as k-mer sets."""

    def __init__(self, haps: Sequence[np.ndarray]):
        self.hap_sets = [kmer_set([h]) for h in haps]
        self.all = np.unique(np.concatenate(self.hap_sets))
        if len(haps) == 2:
            a, b = self.hap_sets
            self.only = [a[~member(a, b)], b[~member(b, a)]]
        else:
            self.only = None

    def err_ppm(self, seqs: Iterable[np.ndarray]) -> float:
        """Per million of the sequences' k-mers, those in no haplotype."""
        bad = tot = 0
        for s in seqs:
            km = canonical_kmers(s)
            bad += int((~member(km, self.all)).sum())
            tot += len(km)
        return 1e6 * bad / tot if tot else 1e6

    def missed_pct(self, contigs: Iterable[np.ndarray]) -> float:
        """Per cent of the haplotypes' distinct k-mers in no contig."""
        held = kmer_set(contigs)
        return 100.0 * float((~member(self.all, held)).sum()) / len(self.all)

    def phase_err_pct(self, phased: List[List[np.ndarray]]) -> float:
        """Hamming error (%) of the contigs of every phased output: a
        contig's haplotype-specific k-mers of its minority haplotype,
        over all its haplotype-specific k-mers, summed over contigs."""
        if self.only is None:
            raise ValueError("phasing needs two haplotypes")
        minor = tot = 0
        for contigs in phased:
            for s in contigs:
                km = canonical_kmers(s)
                a = int(member(km, self.only[0]).sum())
                b = int(member(km, self.only[1]).sum())
                minor += min(a, b)
                tot += a + b
        return 100.0 * minor / tot if tot else 100.0
