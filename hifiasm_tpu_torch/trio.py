"""Trio binning: classify reads as paternal / maternal / ambiguous.

Re-expresses Trio.cpp: the yak k-mer dump reader (``yak_ch_restore_core``
:66 — YAK\\2 magic, 10-bit counters, ``pre``-bit bucketing), hap-specific
k-mer flags (count >= mid_cnt -> 2, >= min_cnt -> 1; pat in bits 0-1, mat
in bits 2-3), and the per-read streak classifier (``tb_worker`` :193,
``tb_classify`` :173 with ratio_thres = 0.33 :268).

The TPU-native re-design: the merged pat+mat table is ONE sorted uint64
array + uint8 flags queried by vectorized binary search, and each read's
k-mer stream is a vectorized rolling-window computation — per-read work is
a handful of array ops instead of a scalar base loop.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.utils.logging import log

YAK_MAGIC = b"YAK\2"
YAK_COUNTER_BITS = 10
YAK_MAX_COUNT = (1 << YAK_COUNTER_BITS) - 1

AMBIGU, FATHER, MOTHER, DROP = 0, 1, 2, 5  # Process_Read.h:103-108


def yak_hash64_masked(key: np.ndarray, mask: np.uint64) -> np.ndarray:
    """yak_hash64 (htab.h) — the masked invertible scrambler for k < 32."""
    key = np.asarray(key, dtype=np.uint64)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint64(21))) & mask
        key = key ^ (key >> np.uint64(24))
        key = (key + (key << np.uint64(3)) + (key << np.uint64(8))) & mask
        key = key ^ (key >> np.uint64(14))
        key = (key + (key << np.uint64(2)) + (key << np.uint64(4))) & mask
        key = key ^ (key >> np.uint64(28))
        key = (key + (key << np.uint64(31))) & mask
    return key


@dataclass
class TrioTable:
    """Merged pat/mat hap-specific k-mer table (sorted hash + 4-bit flags)."""

    k: int
    hashes: np.ndarray   # sorted uint64 (scrambled k-mer hash)
    flags: np.ndarray    # uint8: pat strength bits 0-1, mat bits 2-3

    def lookup(self, h: np.ndarray) -> np.ndarray:
        if len(self.hashes) == 0:
            return np.zeros(len(h), np.uint8)
        idx = np.searchsorted(self.hashes, h)
        idx = np.minimum(idx, len(self.hashes) - 1)
        hit = self.hashes[idx] == h
        return np.where(hit, self.flags[idx], 0).astype(np.uint8)


def _read_yak_dump(path: str, min_cnt: int, mid_cnt: int
                   ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Parse one yak dump -> (k, kmer_hashes, strength 0/1/2)."""
    with open(path, "rb") as f:
        if f.read(4) != YAK_MAGIC:
            raise ValueError(f"{path}: bad yak magic")
        k, pre, cbits = struct.unpack("<3i", f.read(12))
        if cbits != YAK_COUNTER_BITS:
            raise ValueError(f"{path}: counter bits {cbits} != 10")
        hashes, strengths = [], []
        for bucket in range(1 << pre):
            _, size = struct.unpack("<2i", f.read(8))
            if size == 0:
                continue
            keys = np.fromfile(f, dtype="<u8", count=size)
            cnt = keys & np.uint64(YAK_MAX_COUNT)
            strength = np.where(cnt >= mid_cnt, 2,
                                np.where(cnt >= min_cnt, 1, 0)).astype(np.uint8)
            keep = strength > 0
            # reconstruct the full hash: stored key is y >> pre << 10 | cnt
            y = ((keys[keep] >> np.uint64(YAK_COUNTER_BITS))
                 << np.uint64(pre)) | np.uint64(bucket)
            hashes.append(y)
            strengths.append(strength[keep])
    h = np.concatenate(hashes) if hashes else np.zeros(0, np.uint64)
    s = np.concatenate(strengths) if strengths else np.zeros(0, np.uint8)
    return k, h, s


def load_trio_table(pat_path: str, mat_path: str, min_cnt: int = 2,
                    mid_cnt: int = 5) -> TrioTable:
    kp, hp, sp = _read_yak_dump(pat_path, min_cnt, mid_cnt)
    km, hm, sm = _read_yak_dump(mat_path, min_cnt, mid_cnt)
    if kp != km:
        raise ValueError(f"k mismatch between dumps: {kp} vs {km}")
    allh = np.concatenate([hp, hm])
    allf = np.concatenate([sp.astype(np.uint8),
                           (sm.astype(np.uint8) << 2)])
    order = np.argsort(allh, kind="stable")
    allh, allf = allh[order], allf[order]
    uniq, first = np.unique(allh, return_index=True)
    # OR flags of duplicate hashes (pat and mat share the k-mer)
    flags = np.zeros(len(uniq), np.uint8)
    np.bitwise_or.at(flags, np.searchsorted(uniq, allh), allf)
    log("load_trio_table", f"{len(uniq)} hap-informative k-mers (k={kp})")
    return TrioTable(kp, uniq, flags)


def _read_kmers(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical yak k-mer hash at every end position (k < 32, raw bases).

    Returns (end_positions, hashes); k-mers containing N are excluded
    (the reference resets its register at N, tb_worker Trio.cpp:215).
    """
    n = len(codes)
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    mask = np.uint64((1 << (2 * k)) - 1)
    c = codes.astype(np.uint64)
    valid = codes < 4
    # rolling forward word: f[i] = sum_{j<k} base[i-k+1+j] << 2(k-1-j)
    # computed with a vectorized polynomial scan via cumulative products is
    # awkward in pure numpy; use stride tricks on a 2-bit packed view
    ends = np.arange(k - 1, n, dtype=np.int64)
    win = np.lib.stride_tricks.sliding_window_view(np.where(valid, c, 0), k)
    shifts = (np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64))
    fwd = (win << shifts[None, :]).sum(axis=1, dtype=np.uint64) & mask
    rwin = win[:, ::-1]
    rc = ((np.uint64(3) - rwin) << shifts[None, :]).sum(
        axis=1, dtype=np.uint64) & mask
    canon = np.minimum(fwd, rc)
    ok = sliding_all(valid, k)
    h = yak_hash64_masked(canon[ok], mask)
    return ends[ok], h


def sliding_all(valid: np.ndarray, k: int) -> np.ndarray:
    """ok[i] = all(valid[i : i+k]) for windows ending at i+k-1."""
    c = np.cumsum(np.concatenate([[0], valid.astype(np.int64)]))
    return (c[k:] - c[:-k]) == k


def classify_read(codes: np.ndarray, table: TrioTable,
                  ratio_thres: float = 0.33) -> int:
    """~tb_worker + tb_classify for one read."""
    k = table.k
    ends, h = _read_kmers(codes, k)
    n = len(codes)
    if len(h) == 0:
        return AMBIGU
    flags = table.lookup(h)
    c1 = flags & 3
    c2 = (flags >> 2) & 3
    # per-position type over the read (0 elsewhere)
    s = np.zeros(n, np.uint8)
    s[ends[(c1 == 2) & (c2 == 0)]] = 1
    s[ends[(c2 == 2) & (c1 == 0)]] = 2
    # flag histogram c[16]
    c_hist = np.bincount(flags, minlength=16)
    # streak lengths >= k-4 accumulate into sc[type-1]
    sc = [0, 0]
    bounds = np.flatnonzero(np.diff(s)) + 1
    bounds = np.concatenate([[0], bounds, [n]])
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        t = int(s[b0])
        if t > 0 and b1 - b0 >= k - 4:
            sc[t - 1] += int(b1 - b0)
    return _tb_classify(sc, c_hist, k, ratio_thres)


def _tb_classify(sc, c, k, ratio_thres) -> int:
    """Literal re-expression of tb_classify (Trio.cpp:173)."""
    pat_only = int(c[0 << 2 | 2])   # strong pat, absent mat
    mat_only = int(c[2 << 2 | 0])
    if sc[0] == 0 and sc[1] == 0:
        if pat_only == mat_only:
            return AMBIGU
        if pat_only >= k - 4 + mat_only and \
                (mat_only <= 1 or pat_only * 0.05 > mat_only):
            return FATHER
        if mat_only >= k - 4 + pat_only and \
                (pat_only <= 1 or mat_only * 0.05 > pat_only):
            return MOTHER
        return AMBIGU
    if sc[0] > k and sc[1] > k:
        return AMBIGU
    if sc[0] >= k - 4 + sc[1] and sc[0] * 0.05 >= sc[1] and \
            pat_only * ratio_thres > mat_only:
        return FATHER
    if sc[1] >= k - 4 + sc[0] and sc[1] * 0.05 >= sc[0] and \
            mat_only * ratio_thres > pat_only:
        return MOTHER
    return AMBIGU


def ha_triobin(store: ReadStore, pat_path: Optional[str],
               mat_path: Optional[str], min_cnt: int = 2, mid_cnt: int = 5,
               list_pat: Optional[str] = None,
               list_mat: Optional[str] = None) -> np.ndarray:
    """Classify all reads (~ha_triobin, Trio.cpp:450). Updates
    store.trio_flags in place and returns it."""
    store.trio_flags[:] = AMBIGU
    if list_pat and list_mat:
        names = {n: i for i, n in enumerate(store.names)}
        for path, flag in ((list_pat, FATHER), (list_mat, MOTHER)):
            with open(path) as f:
                for line in f:
                    name = line.split()[0] if line.split() else ""
                    if name in names:
                        store.trio_flags[names[name]] = flag
    if pat_path and mat_path:
        table = load_trio_table(pat_path, mat_path, min_cnt, mid_cnt)
        for rid in range(store.n_reads):
            store.trio_flags[rid] = classify_read(store.get_codes(rid), table)
    n_p = int((store.trio_flags == FATHER).sum())
    n_m = int((store.trio_flags == MOTHER).sum())
    log("ha_triobin", f"{n_p} paternal, {n_m} maternal, "
        f"{store.n_reads - n_p - n_m} ambiguous")
    return store.trio_flags
