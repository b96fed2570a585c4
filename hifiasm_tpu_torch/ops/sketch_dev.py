"""Batched HPC minimizer sketching on the device (PyTorch ops).

The port of hifiasm_tpu/ops/sketch_jax.py (``_sketch_kernel``,
``sketch_many_jax``): a chunk of reads becomes [R, L] planes, and the
whole minimizer selection of the reference's ``mz1_ha_sketch``
(sketch.cpp:454-579) runs on the device:

  1. HPC compression  -- run ends by neighbour compares, then one scatter
     compacts (code, raw end, run length, stretch id) per read row;
  2. k-mer words      -- the four 1-bit-per-base strand words by log-step
     shift-or ladders over the bit planes;
  3. keys             -- yak hashes (``yak_hash64_i64``) joined with the
     filter table's counts into (cnt, hash) keys;
  4. selection        -- the (w, k)-window minimum as two log-step
     sliding-extrema sweeps, plus the last window's push (last tie wins);
  5. emission         -- the selected entries of every row, in order.

The high-occurrence streak rescue (sketch.cpp:247-330) stays on the host
over the few selected minimizers of a read, as in the JAX package
(ops/sketch._highocc_filter).

PyTorch has no usable unsigned 64-bit arithmetic on the CPU, so k-mer
words and hashes are int64 holding the uint64 bits: adds and left shifts
wrap to the same bits, every right shift is masked to make it logical
(``_shr``), and orders compare hashes with bit 63 flipped
(``index/pos_table_dev.flip_u64``).  The JAX package's (hi, lo) uint32
pairs, its fixed [R, K] output buffer with a host fallback for a read
that overflows it, and its fixed 128-row, 2,048-padded chunks exist for
the TPU and XLA's compile cache.  PyTorch runs eagerly, so each chunk is
as long as its longest read, its rows are chosen by memory
(``row_chunk``), and the output is sized from every row's emit count: no
read leaves the device sketch for the host sketch.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from hifiasm_tpu_torch.device import resolve_device
from hifiasm_tpu_torch.index.pos_table_dev import flip_u64, unflip_u64
from hifiasm_tpu_torch.ops.sketch import Minimizers, _highocc_filter

_I32 = torch.int32
_I64 = torch.int64
_MIN64 = -(1 << 63)              # bit 63: the flip between orders
_MAX64 = (1 << 63) - 1           # flipped 0xFFFF_FFFF_FFFF_FFFF
_INF_CNT = 0xFFFFFFFF            # key count of an entry without a k-mer

# bytes of live [R, L] planes a cell of a chunk may take at its peak: the
# default row count keeps one chunk's planes under _CHUNK_BYTES
_CELL_BYTES = 320
_CHUNK_BYTES = 1 << 31


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 holding uint64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def yak_hash64_i64(key: torch.Tensor) -> torch.Tensor:
    """yak_hash64_64 (htab.h:150-160) on int64 holding uint64 bits: the
    int64 form of the JAX package's ``yak_hash64_u32pair``
    (hifiasm_tpu/ops/hashes.py:30)."""
    key = ~key + (key << 21)
    key = key ^ _shr(key, 24)
    key = key + (key << 3) + (key << 8)
    key = key ^ _shr(key, 14)
    key = key + (key << 2) + (key << 4)
    key = key ^ _shr(key, 28)
    return key + (key << 31)


# ---------------------------------------------------------------------------
# plane helpers (dim -1 = position)

def _from_left(x: torch.Tensor, p: int, fill) -> torch.Tensor:
    """out[..., j] = x[..., j - p]; positions < p get ``fill``."""
    if p == 0:
        return x
    out = torch.full_like(x, fill)
    if p < x.shape[-1]:
        out[..., p:] = x[..., :-p]
    return out


def _from_right(x: torch.Tensor, p: int, fill) -> torch.Tensor:
    """out[..., j] = x[..., j + p]; positions >= L - p get ``fill``."""
    if p == 0:
        return x
    out = torch.full_like(x, fill)
    if p < x.shape[-1]:
        out[..., :-p] = x[..., p:]
    return out


def _compact(mask, slots, fields, fills):
    """Stable compaction per row: fields[i][r, c] goes to column
    slots[r, c] where mask holds (the device form of a[mask] per row)."""
    R, L = mask.shape
    dump = torch.where(mask, slots, torch.full_like(slots, L)).long()
    outs = []
    for f, fill in zip(fields, fills):
        buf = torch.full((R, L + 1), fill, dtype=f.dtype, device=f.device)
        outs.append(buf.scatter_(1, dump, f)[:, :L])
    return outs


def _fwd_words(bit: torch.Tensor, k: int) -> torch.Tensor:
    """F[j] = sum_t bit[j - k + 1 + t] << t (LSB at j - k + 1), per row."""
    P, R, m, p = bit, None, 0, 1
    while k:
        if k & 1:
            if R is None:
                R, m = P, p
            else:
                # upper m bits from R[j], lower p bits from P[j - m]
                R = (R << p) | _from_left(P, m, 0)
                m += p
        k >>= 1
        if k:
            P = _from_left(P, p, 0) | (P << p)
            p *= 2
    return R


def _rev_words(bit: torch.Tensor, k: int) -> torch.Tensor:
    """G[j] = sum_t bit[j - t] << t, per row."""
    Q, R, m, p = bit, None, 0, 1
    while k:
        if k & 1:
            if R is None:
                R, m = Q, p
            else:
                # lower m bits from G[j], upper p bits from Q[j - m] << m
                R = R | (_from_left(Q, m, 0) << m)
                m += p
        k >>= 1
        if k:
            Q = Q | (_from_left(Q, p, 0) << p)
            p *= 2
    return R


def _key_less(c1, h1, c2, h2):
    """(c2, h2) < (c1, h1) on (count, flipped hash) keys."""
    return (c2 < c1) | ((c2 == c1) & (h2 < h1))


def _slide(c, h, w: int, trailing: bool, op_min: bool, fill):
    """Leading (out[j] = op over x[j..j+w-1]) or trailing
    (out[j] = op over x[j-w+1..j]) sliding extreme of (c, h) keys,
    log-step."""
    fc, fh = fill
    shift = _from_left if trailing else _from_right

    def comb(c1, h1, d):
        c2, h2 = shift(c1, d, fc), shift(h1, d, fh)
        take2 = _key_less(c1, h1, c2, h2) if op_min else \
            _key_less(c2, h2, c1, h1)
        return torch.where(take2, c2, c1), torch.where(take2, h2, h1)

    p = 1
    while p * 2 <= w:
        c, h = comb(c, h, p)
        p *= 2
    if p < w:
        c, h = comb(c, h, w - p)
    return c, h


# ---------------------------------------------------------------------------
# one chunk

def _sketch_chunk(bank, lens, ft_keys, ft_cnt, k: int, w: int,
                  is_unique: bool):
    """bank [R, L] int32 codes (pad 4), lens [R] -> the selected
    minimizers of every row, row by row in position order, as flat
    (flipped hash, raw end, rev, span, cnt) columns plus the count of
    each row.  Mirrors ops/sketch.sketch_read (port of _sketch_kernel)."""
    R, L = bank.shape
    dev = bank.device
    pos_i = torch.arange(L, dtype=_I32, device=dev)[None, :]
    pos_b = pos_i.expand(R, L)
    lens = lens[:, None]
    valid_raw = pos_i < lens

    # ---- 1. HPC compression (one scatter) ----
    c = bank
    nxt = _from_right(c, 1, 255)
    run_end = valid_raw & ((pos_i + 1 == lens) | (c != nxt))
    keep_run = run_end & (c < 4)
    # the previous run end (any code) gives the run length
    e_mark = torch.where(run_end, pos_b, torch.full_like(pos_b, -1))
    prev_end = _from_left(torch.cummax(e_mark, 1).values, 1, -1)
    run_len_raw = pos_i - prev_end
    run_slot = torch.cumsum(run_end, 1, dtype=_I32) - 1
    kept_slot = torch.cumsum(keep_run, 1, dtype=_I32) - 1
    stretch_raw = run_slot - kept_slot          # dropped runs before
    comp2, ends2, rl2, stretch = _compact(
        keep_run, kept_slot, [c, pos_b, run_len_raw, stretch_raw],
        [0, 0, 1, 0])
    del nxt, run_end, e_mark, prev_end, run_len_raw, run_slot, stretch_raw
    ncomp = kept_slot[:, -1:] + 1
    valid_c = pos_i < ncomp

    # ---- 2. k-mer words ----
    b0 = (comp2 & 1).to(_I64)
    b1 = ((comp2 >> 1) & 1).to(_I64)
    mask = -1 if k >= 64 else (1 << k) - 1
    x1 = _rev_words(b1, k) & mask
    x3 = ~_fwd_words(b1, k) & mask
    valid_j = valid_c & (pos_i >= k - 1)
    sym = (x1 == x3) & valid_j
    rev = ~((x1 ^ _MIN64) < (x3 ^ _MIN64))      # unsigned x1 >= x3
    # yak(x0) + yak(x1) on the forward strand, yak(x2) + yak(x3) on the
    # reverse: hash only the chosen strand's words
    lo = torch.where(rev, ~_fwd_words(b0, k) & mask, _rev_words(b0, k) & mask)
    hsh = yak_hash64_i64(lo) + yak_hash64_i64(torch.where(rev, x3, x1))
    del b0, b1, x1, x3, lo

    span = ends2 - (_from_left(ends2, k - 1, 0) -
                    _from_left(rl2, k - 1, 1) + 1) + 1
    same_stretch = stretch == _from_left(stretch, k - 1, -1)

    # ---- eligibility and the per-stretch running count ----
    elig = valid_c & ((pos_i < k - 1) | ~sym)
    e_i = elig.to(_I32)
    cs = torch.cumsum(e_i, 1, dtype=_I32)
    new_s = (pos_i == 0) | (stretch != _from_left(stretch, 1, -1))
    base = torch.cummax(torch.where(new_s, cs - e_i, torch.zeros_like(cs)),
                        1).values
    lcount = cs - base
    complete = ~sym & (lcount >= k) & (span < 256) & same_stretch & valid_j
    del e_i, new_s, base, same_stretch, sym, valid_j

    # ---- 3. (count, hash) keys ----
    hkey = hsh ^ _MIN64
    if ft_keys.numel():
        idx = torch.searchsorted(ft_keys, hkey).clamp(max=ft_keys.numel() - 1)
        hit = complete & (ft_keys[idx] == hkey)
        cnt = torch.where(hit, ft_cnt[idx], torch.zeros_like(hkey))
        del idx, hit
    else:
        cnt = torch.zeros_like(hkey)
    filtered = cnt >= (1 << 28)
    if is_unique:
        filtered |= (cnt == 0) & ~filtered & complete
        cnt = torch.where(cnt == 1, torch.zeros_like(cnt), cnt)
    good_key = elig & ~(~complete | filtered)

    # ---- 4. eligible-sequence compaction and window selection ----
    key_c, key_h, estretch, el, esrc = _compact(
        elig, cs - 1,
        [torch.where(good_key, cnt, torch.full_like(cnt, _INF_CNT)),
         torch.where(good_key, hkey, torch.full_like(hkey, _MAX64)),
         stretch, lcount, pos_b],
        [_INF_CNT, _MAX64, -1, 0, 0])
    del good_key, filtered, complete, stretch, lcount
    ne = cs[:, -1:]                              # [R, 1] eligible entries

    wmin_c, wmin_h = _slide(key_c, key_h, w, trailing=False, op_min=True,
                            fill=(_INF_CNT, _MAX64))
    e_cl = torch.minimum(pos_i + (w - 1), (ne - 1).clamp(min=0)).long()
    valid_w = (pos_i + (w - 1) < ne) & \
        (estretch == estretch.gather(1, e_cl)) & \
        (el.gather(1, e_cl) >= w + k - 1)
    mm_c, mm_h = _slide(
        torch.where(valid_w, wmin_c, torch.zeros_like(wmin_c)),
        torch.where(valid_w, wmin_h, torch.full_like(wmin_h, _MIN64)),
        w, trailing=True, op_min=False, fill=(0, _MIN64))
    real = key_c != _INF_CNT
    emit = real & (mm_c == key_c) & (mm_h == key_h)
    del wmin_c, wmin_h, e_cl, valid_w, mm_c, mm_h, el

    # ---- the last window's push: its minimum, last tie wins ----
    last_st = estretch.gather(1, (ne - 1).clamp(min=0).long())
    in_last = (estretch == last_st) & (pos_i < ne)
    n_last = in_last.sum(1, keepdim=True, dtype=_I32)
    lo_b = (ne - torch.clamp(n_last, max=w)).clamp(min=0)
    cand = (pos_i >= lo_b) & (pos_i < ne) & real
    m1 = torch.where(cand, key_c, torch.full_like(key_c, _INF_CNT)) \
        .min(1, keepdim=True).values
    t1 = cand & (key_c == m1)
    m2 = torch.where(t1, key_h, torch.full_like(key_h, _MAX64)) \
        .min(1, keepdim=True).values
    t2 = t1 & (key_h == m2)
    bi = torch.where(t2, pos_b, torch.full_like(pos_b, -1)).max(1).values
    rows = torch.nonzero((bi >= 0) & (ne[:, 0] > 0)).flatten()
    emit[rows, bi[rows].long()] = True
    del in_last, cand, t1, t2, estretch, key_c, key_h

    # ---- 5. emission, in row-major order ----
    r_i, e_j = torch.nonzero(emit, as_tuple=True)
    src = esrc[r_i, e_j].long()
    return (hkey[r_i, src], ends2[r_i, src], rev[r_i, src],
            span[r_i, src], cnt[r_i, src], emit.sum(1))


def default_rows(L: int) -> int:
    """Rows of a chunk of length L whose planes stay under _CHUNK_BYTES."""
    return max(1, _CHUNK_BYTES // (_CELL_BYTES * max(L, 1)))


def sketch_many_device(codes_list, k: int, w: int, ft=None,
                       sample_dist: int = 500, is_unique: bool = False,
                       device="cuda", row_chunk: int = 0
                       ) -> List[Minimizers]:
    """Sketch many reads on ``device``; returns list[Minimizers] equal,
    field for field, to ops/sketch.sketch_many and the JAX package's
    sketch_many_jax, the host high-occurrence rescue included.

    ``ft`` is the filter table (index/pos_table.FilterTable) or None.
    ``row_chunk`` > 0 sets the reads of a chunk; 0 picks them by memory
    (``default_rows`` of the chunk's longest read).  The result does not
    depend on it."""
    dev = resolve_device(device)
    n = len(codes_list)
    if n == 0:
        return []
    if ft is not None and len(ft.hashes):
        ft_keys = torch.from_numpy(flip_u64(ft.hashes)).to(dev)
        ft_cnt = torch.from_numpy(np.asarray(ft.counts, np.int64)).to(dev)
    else:
        ft_keys = torch.zeros(0, dtype=_I64, device=dev)
        ft_cnt = ft_keys
    lens_all = np.array([len(x) for x in codes_list], np.int64)
    out: List[Minimizers] = []
    c0 = 0
    while c0 < n:
        R = row_chunk if row_chunk > 0 else \
            default_rows(int(lens_all[c0:c0 + 4096].max(initial=1)))
        chunk = codes_list[c0:c0 + R]
        lens = lens_all[c0:c0 + len(chunk)]
        L = max(int(lens.max()), 1)
        bank = np.full((len(chunk), L), 4, np.uint8)
        for i, x in enumerate(chunk):
            bank[i, :len(x)] = x
        cols = _sketch_chunk(
            torch.from_numpy(bank).to(dev).to(_I32),
            torch.from_numpy(lens.astype(np.int32)).to(dev), ft_keys,
            ft_cnt, k, w, is_unique)
        hk, pos, rev, span, cnt, n_out = (t.cpu().numpy() for t in cols)
        h = unflip_u64(hk)
        off = np.concatenate([[0], np.cumsum(n_out)])
        for i in range(len(chunk)):
            a, b = int(off[i]), int(off[i + 1])
            m = Minimizers(h[a:b], pos[a:b].astype(np.int64),
                           rev[a:b].astype(np.uint8),
                           span[a:b].astype(np.int64),
                           cnt[a:b].astype(np.uint32))
            # the streak rescue only drops or keeps cnt > 0 entries
            if ft is not None and sample_dist > w and b > a and \
                    (m.cnt > 0).any():
                keep = _highocc_filter(m.cnt, m.hash, m.pos, m.span,
                                       len(chunk[i]), sample_dist)
                m = Minimizers(m.hash[keep], m.pos[keep], m.rev[keep],
                               m.span[keep], m.cnt[keep])
            out.append(m)
        c0 += len(chunk)
    return out
