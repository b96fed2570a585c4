"""Per-base errors of a corrected read against the sequence it was drawn
from.

A read after error correction should spell the bases of the genome it
was sampled from, at the place and on the strand it was sampled from
(its truth, which the benchmark knows and the program does not).  The
number of errors left in it is the edit distance between the two:
substitutions, insertions and deletions, each one.  A read corrected
toward another copy of a repeat (a satellite unit, a segmental
duplication) keeps the differences between the copies as errors, where
a count of k-mers absent from the genome would read none.

The distance is computed exactly between exact-match blocks: 24-mers
that occur once in the truth anchor the read on it, runs of anchors on
one diagonal make blocks, the chain of blocks increasing in both
sequences that covers the most 24-mers is copied without edits, and the
stretch between two blocks (and before the first and after the last) is
aligned by a dynamic program: in full up to ``FULL_CELLS`` cells, else
in a band of ``BAND`` diagonals either side of the straight line between
its ends (a read inside a satellite array holds few 24-mers that occur
once).
Where blocks are chosen badly, or an alignment leaves the band, the
result is an upper bound on the distance, never below it.  NumPy only.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.kmers import _forward

K = 24
FULL_CELLS = 250_000
BAND = 48
_INF = 1 << 40


def _kmers(seq: np.ndarray) -> np.ndarray:
    """Forward 2-bit ``K``-mers of ``seq`` (codes above 3 read as 3)."""
    return _forward(np.minimum(seq, 3).astype(np.uint64), K)


def _dp(a: np.ndarray, b: np.ndarray) -> int:
    """Edit distance between ``a`` and ``b``."""
    if len(a) > len(b):
        a, b = b, a
    if len(a) == 0:
        return len(b)
    if len(a) == len(b) and np.array_equal(a, b):
        return 0
    if len(a) * len(b) > FULL_CELLS:
        return _banded(a, b, BAND)
    idx = np.arange(len(b) + 1)
    prev = idx.copy()
    cur = np.empty_like(prev)
    for i in range(len(a)):
        cur[0] = i + 1
        np.minimum(prev[:-1] + (b != a[i]), prev[1:] + 1, out=cur[1:])
        cur = np.minimum.accumulate(cur - idx) + idx
        prev, cur = cur, prev
    return int(prev[-1])


def _banded(a: np.ndarray, b: np.ndarray, w: int) -> int:
    """Edit distance between ``a`` and ``b`` over the alignments whose
    diagonal (``j - i``) stays within ``w`` of the range between 0 and
    ``len(b) - len(a)``: row ``i`` of ``a`` holds the cells ``j = i + d``
    for each such ``d``."""
    la, lb = len(a), len(b)
    lo = min(0, lb - la) - w
    d = np.arange(lo, max(0, lb - la) + w + 1)
    k = np.arange(len(d))
    prev = np.where((d >= 0) & (d <= lb), d, _INF)
    bb = b.astype(np.int16)
    for i in range(1, la + 1):
        j = i + d
        inside = (j >= 0) & (j <= lb)
        diag = prev + (bb[np.clip(j - 1, 0, lb - 1)] != a[i - 1])
        diag[j < 1] = _INF
        up = np.empty_like(prev)
        up[:-1] = prev[1:] + 1
        up[-1] = _INF
        cur = np.minimum(diag, up)
        cur[~inside] = _INF
        prev = np.minimum.accumulate(cur - k) + k
        prev[~inside] = _INF
    return int(prev[lb - la - lo])


def _blocks(read: np.ndarray, truth: np.ndarray):
    """Exact-match blocks (read start, truth start, length), increasing
    and disjoint in both sequences."""
    if len(read) < K or len(truth) < K:
        return []
    tk = _kmers(truth)
    order = np.argsort(tk, kind="stable")
    srt = tk[order]
    once = np.ones(len(srt), bool)
    dup = srt[1:] == srt[:-1]
    once[1:] &= ~dup
    once[:-1] &= ~dup
    keys, pos = srt[once], order[once]
    rk = _kmers(read)
    j = np.minimum(np.searchsorted(keys, rk), max(len(keys) - 1, 0))
    hit = np.flatnonzero(keys[j] == rk) if len(keys) else np.zeros(0, int)
    if len(hit) == 0:
        return []
    tpos = pos[j[hit]]
    diag = tpos - hit
    # a new run where the read position or the diagonal jumps
    brk = np.flatnonzero((np.diff(hit) != 1) | (np.diff(diag) != 0)) + 1
    first = np.concatenate([[0], brk])
    r0 = hit[first]
    t0 = tpos[first]
    n = np.diff(np.concatenate([first, [len(hit)]]))
    # the chain of runs, increasing in both sequences, that covers the
    # most k-mers: a 24-mer of a satellite unit that matches another
    # unit (where a read error or variant makes it) falls out
    best = n.copy()
    back = np.full(len(n), -1)
    for i in range(1, len(n)):
        ok = (t0[:i] < t0[i]) & (r0[:i] < r0[i])
        if ok.any():
            j = int(np.argmax(np.where(ok, best[:i], -1)))
            best[i] += best[j]
            back[i] = j
    chain = []
    i = int(np.argmax(best))
    while i >= 0:
        chain.append(i)
        i = int(back[i])
    out = []
    r_end = t_end = 0
    for i in chain[::-1]:
        a, b = int(r0[i]), int(t0[i])
        r1 = a + int(n[i]) - 1 + K
        cut = max(r_end - a, t_end - b, 0)
        a += cut
        b += cut
        if a >= r1:
            continue
        out.append((a, b, r1 - a))
        r_end, t_end = r1, b + r1 - a
    return out


def edit_distance(read: np.ndarray, truth: np.ndarray) -> int:
    """Edits (substitutions, insertions, deletions) between a read and
    its truth, end to end; exact unless the blocks are chosen badly."""
    if len(read) == len(truth) and np.array_equal(read, truth):
        return 0
    dist = 0
    r_end = t_end = 0
    for r0, t0, n in _blocks(read, truth):
        dist += _dp(read[r_end:r0], truth[t_end:t0])
        r_end, t_end = r0 + n, t0 + n
    return dist + _dp(read[r_end:], truth[t_end:])
