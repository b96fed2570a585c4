"""HPC minimizer sketching.

Re-expresses the reference's ``mz1_ha_sketch`` (sketch.cpp:454-579) as
vectorized array programs instead of a scalar rolling loop:

- the 1-bit-per-base k-mer words (sketch.cpp:498-501) become windowed bit
  extractions from packed bit-streams (forward and reversed), fully parallel
  over positions;
- the (w,k)-window minimum queue becomes log-step sliding-window extrema:
  a position is a minimizer iff its key equals the min of some window
  containing it (ties: all positions emitted);
- minimizer keys are (filter-count, hash) so low-occurrence k-mers win, as
  in the reference (sketch.cpp:184 mzcmp compares rid=count first);
- high-occurrence minimizers are dropped after selection, with up to
  MAX_MAX_HIGH_OCC=16 rescued per long high-occ streak
  (sketch.cpp:193-216 hf_select), approximating select_mz_h.

This module is the host (numpy) implementation; ops/sketch_jax.py is the
batched device version (fixed-shape [R, L] planes, u32-pair hashes).  Both
share semantics and are cross-validated byte-identical in
tests/test_sketch_jax.py.

Known deviations from the reference (documented, affect only edge cases):
- tie emission differs slightly mid-sequence (reference suppresses some tie
  positions depending on queue state);
- reads containing N use per-stretch windows; the reference lets its buffer
  span N resets in rare partial-window cases.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from hifiasm_tpu_torch.io.readstore import hpc_compress
from hifiasm_tpu_torch.ops.hashes import yak_hash64_np

MAX_HIGH_OCC = 8
MAX_MAX_HIGH_OCC = 16
_U64 = np.uint64
_INF_CNT = np.uint32(0xFFFFFFFF)


@dataclass
class Minimizers:
    """Columnar minimizer set (~ha_mz1_v of ha_mz1_t, htab.h:13-18)."""

    hash: np.ndarray   # uint64
    pos: np.ndarray    # int64, raw end position of the k-mer
    rev: np.ndarray    # uint8 strand
    span: np.ndarray   # int64 raw bases covered
    cnt: np.ndarray    # uint32 filter-table count at sketch time

    def __len__(self):
        return len(self.hash)


def _pack_bits_u64(bits: np.ndarray) -> np.ndarray:
    """bool/0-1 array -> uint64 words, LSB-first, padded with one extra word."""
    by = np.packbits(bits.astype(np.uint8), bitorder="little")
    pad = (-len(by)) % 8 + 8
    by = np.concatenate([by, np.zeros(pad, dtype=np.uint8)])
    return by.view(np.uint64)


def _extract_windows(words: np.ndarray, starts: np.ndarray, k: int) -> np.ndarray:
    """For each start s, the k bits [s, s+k) as a uint64 (LSB = bit s)."""
    wi = starts >> 6
    off = (starts & 63).astype(np.uint64)
    lo = words[wi] >> off
    hi_shift = (np.uint64(64) - off) & np.uint64(63)
    hi = np.where(off == 0, _U64(0), words[wi + 1] << hi_shift)
    val = lo | hi
    if k < 64:
        val &= _U64((1 << k) - 1)
    return val


def _composite_min(c1, h1, c2, h2):
    less = (c2 < c1) | ((c2 == c1) & (h2 < h1))
    return np.where(less, c2, c1), np.where(less, h2, h1)


def _composite_max(c1, h1, c2, h2):
    more = (c2 > c1) | ((c2 == c1) & (h2 > h1))
    return np.where(more, c2, c1), np.where(more, h2, h1)


def _sliding_extreme(cnt, hsh, w, op):
    """op over trailing-aligned windows: out[i] = op(x[i], ..., x[i+w-1]).

    log-step doubling; positions i > n-w contain the extreme of the
    truncated suffix (callers mask them).
    """
    n = len(cnt)
    c, h = cnt.copy(), hsh.copy()
    p = 1
    while p * 2 <= w:
        c2 = np.empty_like(c)
        h2 = np.empty_like(h)
        c2[: n - p], h2[: n - p] = c[p:], h[p:]
        c2[n - p:], h2[n - p:] = c[n - p:], h[n - p:]
        c, h = op(c, h, c2, h2)
        p *= 2
    if p < w:
        d = w - p
        c2 = np.empty_like(c)
        h2 = np.empty_like(h)
        c2[: n - d], h2[: n - d] = c[d:], h[d:]
        c2[n - d:], h2[n - d:] = c[n - d:], h[n - d:]
        c, h = op(c, h, c2, h2)
    return c, h


def _compute_kmers(codes: np.ndarray, k: int):
    """All canonical HPC k-mers of a read, vectorized.

    Returns None if fewer than k HPC bases, else a dict with per-position
    (j-indexed, j = compressed end index from k-1) arrays plus the stretch/
    eligibility bookkeeping shared by sketching and all-k-mer counting.
    """
    comp, raw_end, run_len = hpc_compress(codes)
    keep = comp < 4
    # stretch id increments after each removed N run
    reset_after = np.cumsum(~keep)
    comp2 = comp[keep]
    ends2 = raw_end[keep]
    rl2 = run_len[keep]
    stretch = reset_after[keep]
    L = len(comp2)
    if L < k:
        return None

    b0 = (comp2 & 1).astype(np.uint8)
    b1 = (comp2 >> 1).astype(np.uint8)
    F0, F1 = _pack_bits_u64(b0), _pack_bits_u64(b1)
    R0, R1 = _pack_bits_u64(b0[::-1]), _pack_bits_u64(b1[::-1])

    j = np.arange(k - 1, L, dtype=np.int64)          # k-mer end positions
    mask = _U64((1 << k) - 1)
    x0 = _extract_windows(R0, L - 1 - j, k)
    x1 = _extract_windows(R1, L - 1 - j, k)
    x2 = (~_extract_windows(F0, j - k + 1, k)) & mask
    x3 = (~_extract_windows(F1, j - k + 1, k)) & mask

    sym = x1 == x3
    rev = (~(x1 < x3)).astype(np.uint8)
    hsh = np.where(rev == 0,
                   yak_hash64_np(x0) + yak_hash64_np(x1),
                   yak_hash64_np(x2) + yak_hash64_np(x3))

    # same stretch over the whole k-mer (no N reset inside)
    same_stretch = stretch[j] == stretch[j - k + 1]
    span = ends2[j] - (ends2[j - k + 1] - rl2[j - k + 1] + 1) + 1

    # l: count of non-symmetric positions within stretch (all positions, then
    # k-mer completeness requires l >= k); build over full L
    elig_full = np.ones(L, dtype=bool)
    elig_full[j[sym]] = False          # symmetric k-mer positions are skipped
    # positions before k-1 count toward l too (they are non-symmetric by
    # definition in the reference only once a k-mer exists; before that every
    # valid base increments l). Reference: ++l for every non-symmetric valid
    # base — but symmetry is defined by the current register even when l<k.
    # We approximate: positions with index < k-1 always count.
    elig_full[: k - 1] = True
    # per-stretch running count of eligible positions
    lcount = np.zeros(L, dtype=np.int64)
    if L:
        new_s = np.ones(L, dtype=bool)
        new_s[1:] = stretch[1:] != stretch[:-1]
        e = elig_full.astype(np.int64)
        cs = np.cumsum(e)
        starts_idx = np.flatnonzero(new_s)
        base = np.zeros(L, dtype=np.int64)
        base[starts_idx] = cs[starts_idx] - e[starts_idx]
        np.maximum.accumulate(base, out=base)
        lcount = cs - base

    complete = (~sym) & (lcount[j] >= k) & (span < 256) & same_stretch
    return dict(j=j, hsh=hsh, rev=rev, span=span, sym=sym, complete=complete,
                elig_full=elig_full, lcount=lcount, stretch=stretch,
                ends2=ends2, L=L)


def all_kmers_read(codes: np.ndarray, k: int) -> np.ndarray:
    """Hashes of every complete canonical HPC k-mer (the w=1 counting pass
    of ha_ft_gen, htab.cpp:1143 HAF_COUNT_ALL)."""
    kd = _compute_kmers(codes, k)
    if kd is None:
        return np.zeros(0, dtype=_U64)
    return kd["hsh"][kd["complete"]]


def sketch_read(
    codes: np.ndarray,
    k: int,
    w: int,
    ft_lookup=None,
    sample_dist: int = 500,
    is_unique: bool = False,
    _multi_bounds: Optional[np.ndarray] = None,
) -> Minimizers:
    """Sketch one read. ``ft_lookup(hashes)->counts`` is the filter table.

    ``_multi_bounds`` (sketch_many internal): raw read-start offsets of a
    concatenation; the tail-window push and high-occ rescue then run per
    embedded read instead of once."""
    kd = _compute_kmers(codes, k)
    if kd is None:
        z = np.zeros(0)
        return Minimizers(z.astype(_U64), z.astype(np.int64),
                          z.astype(np.uint8), z.astype(np.int64),
                          z.astype(np.uint32))
    j, hsh, rev, span = kd["j"], kd["hsh"], kd["rev"], kd["span"]
    complete, elig_full = kd["complete"], kd["elig_full"]
    lcount, stretch, ends2 = kd["lcount"], kd["stretch"], kd["ends2"]

    cnt = np.zeros(len(j), dtype=np.uint32)
    if ft_lookup is not None:
        cnt[complete] = ft_lookup(hsh[complete]).astype(np.uint32)
    filtered = cnt >= np.uint32(1 << 28)
    if is_unique:
        zerocnt = (cnt == 0) & ~filtered
        filtered |= zerocnt
        cnt = np.where(cnt == 1, 0, cnt).astype(np.uint32)
    dummy = ~complete | filtered

    # --- window selection over eligible positions, per stretch ---
    # eligible sequence: all non-symmetric positions (incl. incomplete, as
    # dummies); windows of w entries; emit argmins of windows whose last
    # entry has l >= w+k-1.
    elig_pos = np.flatnonzero(elig_full)              # compressed indices
    ne = len(elig_pos)
    key_c = np.full(ne, _INF_CNT, dtype=np.uint32)
    key_h = np.full(ne, _U64(0xFFFFFFFFFFFFFFFF), dtype=_U64)
    # map k-mer arrays (indexed by j - (k-1)) onto eligible sequence
    kidx = elig_pos - (k - 1)                         # index into j-arrays
    has_kmer = kidx >= 0
    hk = np.flatnonzero(has_kmer)
    src = kidx[hk]
    ok = ~dummy[src]
    key_c[hk[ok]] = cnt[src[ok]]
    key_h[hk[ok]] = hsh[src[ok]]
    estretch = stretch[elig_pos]
    el = lcount[elig_pos]                             # l value at each entry

    emit_e = np.zeros(ne, dtype=bool)
    if ne >= 1:
        # window min aligned at starts
        wmin_c, wmin_h = _sliding_extreme(key_c, key_h, w, _composite_min)
        # a window starting at s is "valid" if it fits, is single-stretch,
        # and its end entry has l >= w+k-1
        s_idx = np.arange(ne)
        e_idx = s_idx + w - 1
        valid_w = e_idx < ne
        e_cl = np.minimum(e_idx, ne - 1)
        valid_w &= estretch[s_idx] == estretch[e_cl]
        valid_w &= el[e_cl] >= w + k - 1
        # invalid windows get a never-matching sentinel (min composite)
        vm_c = np.where(valid_w, wmin_c, np.uint32(0))
        vm_h = np.where(valid_w, wmin_h, _U64(0))
        # for each entry i, max over window-starts s in [i-w+1, i]:
        # compute leading-aligned max == trailing max over reversed arrays
        mm_c, mm_h = _sliding_extreme(vm_c[::-1], vm_h[::-1], w, _composite_max)
        mm_c, mm_h = mm_c[::-1], mm_h[::-1]
        # mm at index i-w+1... we need max over s<=i of vm[s] with s>=i-w+1:
        # trailing window starting at max(0, i-w+1)
        start = np.maximum(0, s_idx - w + 1)
        # _sliding_extreme over reversed gives, at reversed index, max of w
        # entries forward in reversed = backward in original ending at i.
        sel_c, sel_h = mm_c, mm_h  # aligned: entry i <- max vm[i-w+1..i]
        emit_e = (key_c != _INF_CNT) & (sel_c == key_c) & (sel_h == key_h)
        _ = start

    # --- final push: min of the last (possibly partial) window, once per
    # embedded read (sketch_many) or once for the whole read ---
    def _tail_push(entries):
        if not len(entries):
            return
        last_st = estretch[entries[-1]]
        in_last = entries[estretch[entries] == last_st]
        tail = in_last[-min(w, len(in_last)):]
        tc, th = key_c[tail], key_h[tail]
        good = tc != _INF_CNT
        if not good.any():
            return
        # last among ties wins (reference updates min on <=)
        bc, bh = np.uint32(0xFFFFFFFF), _U64(0xFFFFFFFFFFFFFFFF)
        bi = -1
        for t in range(len(tail)):
            if not good[t]:
                continue
            if (tc[t] < bc) or (tc[t] == bc and th[t] <= bh):
                bc, bh, bi = tc[t], th[t], tail[t]
        if bi >= 0:
            emit_e[bi] = True

    if ne:
        if _multi_bounds is None:
            _tail_push(np.arange(ne))
        else:
            epos = ends2[elig_pos]
            erid = np.searchsorted(_multi_bounds, epos,
                                   side="right") - 1
            seg = np.flatnonzero(np.diff(erid)) + 1
            starts = np.concatenate([[0], seg])
            ends = np.concatenate([seg, [ne]])
            for s, e in zip(starts, ends):
                _tail_push(np.arange(s, e))

    sel = elig_pos[emit_e]
    ksel = sel - (k - 1)
    out_h = hsh[ksel]
    out_pos = ends2[sel]
    out_rev = rev[ksel]
    out_span = span[ksel]
    out_cnt = cnt[ksel]

    # --- high-occ drop + streak rescue (select_mz_h, sketch.cpp:247-330) ---
    if ft_lookup is not None and sample_dist > w and len(out_h):
        if _multi_bounds is None:
            keep_m = _highocc_filter(out_cnt, out_h, out_pos, out_span,
                                     len(codes), sample_dist)
        else:
            keep_m = np.zeros(len(out_h), bool)
            orid = np.searchsorted(_multi_bounds, out_pos,
                                   side="right") - 1
            nb = len(_multi_bounds) - 1
            for i in range(nb):
                m = np.flatnonzero(orid == i)
                if not len(m):
                    continue
                rl = int(_multi_bounds[i + 1] - _multi_bounds[i]) - \
                    (1 if i + 1 < nb else 0)
                keep_m[m] = _highocc_filter(
                    out_cnt[m], out_h[m],
                    out_pos[m] - _multi_bounds[i], out_span[m], rl,
                    sample_dist)
        out_h, out_pos, out_rev, out_span, out_cnt = (
            out_h[keep_m], out_pos[keep_m], out_rev[keep_m],
            out_span[keep_m], out_cnt[keep_m])

    return Minimizers(out_h, out_pos.astype(np.int64), out_rev,
                      out_span.astype(np.int64), out_cnt)


def sketch_many(codes_list, k: int, w: int, ft_lookup=None,
                sample_dist: int = 500, is_unique: bool = False):
    """Sketch MANY reads in one vectorized pass.

    Reads are concatenated with an N sentinel between them, so read
    boundaries become stretch resets and the whole per-stretch pipeline of
    ``sketch_read`` runs once over the concatenation; only the tail-window
    push and the high-occ rescue stay per read (tiny). Cross-validated
    equal to per-read ``sketch_read`` in tests.
    """
    n_reads = len(codes_list)
    if n_reads == 0:
        return []
    sep = np.array([4], np.uint8)
    parts = []
    bounds = np.zeros(n_reads + 1, np.int64)   # raw offsets incl. separators
    off = 0
    for i, c in enumerate(codes_list):
        bounds[i] = off
        parts.append(c)
        off += len(c)
        if i + 1 < n_reads:
            parts.append(sep)
            off += 1
    bounds[n_reads] = off
    allc = np.concatenate(parts)

    mz = sketch_read(allc, k, w, ft_lookup, sample_dist=sample_dist,
                     is_unique=is_unique, _multi_bounds=bounds)
    # split per read by raw position
    rid = np.searchsorted(bounds, mz.pos, side="right") - 1
    out = []
    for i in range(n_reads):
        m = rid == i
        out.append(Minimizers(mz.hash[m], mz.pos[m] - bounds[i],
                              mz.rev[m], mz.span[m], mz.cnt[m]))
    return out


def _highocc_filter(cnt, hsh, pos, span, read_len, sample_dist):
    """Drop cnt>0 minimizers; rescue up to 16 per long high-occ streak."""
    n = len(cnt)
    keep = cnt == 0
    i = 0
    while i < n:
        if keep[i]:
            i += 1
            continue
        jx = i
        while jx < n and not keep[jx]:
            jx += 1
        ps = int(pos[i - 1]) if i > 0 else 0
        pe = int(pos[jx]) if jx < n else read_len
        m = int((pe - ps) / sample_dist + 0.499)
        if m > 0:
            m = min(m, MAX_MAX_HIGH_OCC)
            idx = np.arange(i, jx)
            order = np.lexsort((hsh[idx], cnt[idx]))
            for t in order[:m]:
                if cnt[idx[t]] < pe - ps:
                    keep[idx[t]] = True
        i = jx
    return keep
