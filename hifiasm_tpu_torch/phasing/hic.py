"""Hi-C integration: only the k-mer helper the host purge
confirmation needs (graph/tovlp.py); the Hi-C branch itself is not
ported yet (ROADMAP.md Queue 1)."""

from __future__ import annotations

import numpy as np

from hifiasm_tpu_torch.trio import yak_hash64_masked, sliding_all


def _seq_kmers(codes: np.ndarray, k: int,
               with_pos: bool = False):
    """Canonical k-mer hashes at each end position (N-free windows only)."""
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.uint64)
        return (np.zeros(0, np.int64), z) if with_pos else z
    mask = np.uint64((1 << (2 * k)) - 1)
    valid = codes < 4
    c = np.where(valid, codes, 0).astype(np.uint64)
    # rolling accumulation: k O(n) passes with O(n) memory — the
    # sliding-window product materialized an [n, k] u64 plane (3.7 GB
    # for one 15 Mb unitig), the wall of UnitigIndex at genome scale
    m = n - k + 1
    two = np.uint64(2)
    fwd = np.zeros(m, np.uint64)
    for t in range(k):
        fwd = ((fwd << two) | c[t:t + m]) & mask
    d = (np.uint64(3) - c)[::-1]
    rcr = np.zeros(m, np.uint64)
    for t in range(k):
        rcr = ((rcr << two) | d[t:t + m]) & mask
    rc = rcr[::-1]
    canon = np.minimum(fwd, rc)
    ok = sliding_all(valid, k)
    h = yak_hash64_masked(canon[ok], mask)
    if with_pos:
        ends = np.arange(k - 1, n, dtype=np.int64)[ok]
        return ends, h
    return h
