"""Batched banded Myers bit-parallel alignment (host/numpy engine).

Same semantics as ``ops.banded_align.banded_edit_np`` (the scalar oracle;
cross-validated in tests) but vectorized over a BATCH of window problems:
the band of 2e+1 <= 63 diagonals packs into one uint64 lane per problem, so
every Myers step is ~15 elementwise uint64 ops over the batch.  This is the
shape of the TPU kernel (ops/banded_align_jax.py runs the identical scan on
(hi, lo) uint32 pairs); the reference equivalents are the banded BPM engines
of Levenshtein_distance.h:3857,4477 (single-problem SSE).

Inputs are padded rectangles:
  x:  [B, XL] uint8 query windows (codes 0..4), lengths ``xlen``
  y:  [B, YL] uint8 target windows, lengths ``ylen`` (YL >= XL + 2e)
Each problem aligns x[b,:xlen[b]] globally against y[b,:ylen[b]] with free
y-start in [0, 2e] and free y-end, at most ``e`` errors (else err = -1).

Traceback output is the consensus-ready per-x-position encoding of
``banded_align.WindowAlign``: aligned/deleted base per x position plus
insertion count + first inserted base after each x position.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

U1 = np.uint64(1)


@dataclass
class BatchAlign:
    err: np.ndarray       # [B] int32, -1 if failed
    y_start: np.ndarray   # [B] int32 first y index consumed
    y_end: np.ndarray     # [B] int32 one past last y index consumed
    tb_base: np.ndarray   # [B, XL] uint8 (0..3 aligned base, 4 deleted, 5 pad)
    ins_cnt: np.ndarray   # [B, XL] uint8 insertions after x position
    ins_base: np.ndarray  # [B, XL] uint8 first inserted base


def banded_batch_np(x: np.ndarray, xlen: np.ndarray, y: np.ndarray,
                    ylen: np.ndarray, e: int, traceback: bool = True
                    ) -> BatchAlign:
    B, XL = x.shape
    YL = y.shape[1]
    W = 2 * e + 1
    assert W <= 63, "band must fit a uint64 lane"
    mask = np.uint64((1 << W) - 1)
    xlen = xlen.astype(np.int64)
    ylen = ylen.astype(np.int64)

    # Peq[b, c]: band-relative match mask for base c
    peq = np.zeros((B, 4), dtype=np.uint64)
    lim = np.minimum(W, ylen)
    for b0 in range(min(W, YL)):
        active = b0 < lim
        yb = y[:, b0] if b0 < YL else np.full(B, 4, np.uint8)
        for c in range(4):
            sel = active & (yb == c)
            peq[sel, c] |= U1 << np.uint64(b0)

    VP = np.zeros(B, dtype=np.uint64)
    VN = np.zeros(B, dtype=np.uint64)
    err = np.zeros(B, dtype=np.int64)
    tmax = int(xlen.max()) if B else 0

    if traceback:
        st_vp = np.zeros((tmax + 1, B), dtype=np.uint64)
        st_vn = np.zeros((tmax + 1, B), dtype=np.uint64)
        st_d0 = np.zeros((tmax + 1, B), dtype=np.uint64)
        st_hp = np.zeros((tmax + 1, B), dtype=np.uint64)
        st_hn = np.zeros((tmax + 1, B), dtype=np.uint64)

    for i in range(tmax):
        live = i < xlen
        xc = x[:, i]
        eq = np.zeros(B, dtype=np.uint64)
        for c in range(4):
            eq = np.where(xc == c, peq[:, c], eq)
        X = eq | VN
        D0 = (((VP + (X & VP)) & mask) ^ VP) | X
        HN = VP & D0
        HP = VN | (~(VP | D0) & mask)
        X2 = D0 >> U1
        nVN = X2 & HP
        nVP = (HN | (~(X2 | HP) & mask)) & mask
        VP = np.where(live, nVP, VP)
        VN = np.where(live, nVN, VN)
        err = np.where(live, err + (1 - (D0 & U1)).astype(np.int64), err)
        if traceback:
            st_vp[i + 1] = np.where(live, VP, 0)
            st_vn[i + 1] = np.where(live, VN, 0)
            st_d0[i + 1] = np.where(live, D0, 0)
            st_hp[i + 1] = np.where(live, HP, 0)
            st_hn[i + 1] = np.where(live, HN, 0)
        # shift Peq, admit y[i + W]
        peq >>= U1
        nb = i + W
        if nb < YL:
            adm = live & (nb < ylen)
            ybn = y[:, nb]
            for c in range(4):
                sel = adm & (ybn == c)
                peq[sel, c] |= U1 << np.uint64(W - 1)

    # free-end scan over y endpoints xlen .. min(xlen+2e, ylen)
    best_err = err.copy()
    best_n = xlen.copy()
    e2 = err.copy()
    nb_max = np.minimum(2 * e, ylen - xlen)
    for b0 in range(2 * e):
        act = b0 < nb_max
        e2 = e2 + ((VP >> np.uint64(b0)) & U1).astype(np.int64) \
                - ((VN >> np.uint64(b0)) & U1).astype(np.int64)
        better = act & (e2 < best_err)
        best_err = np.where(better, e2, best_err)
        best_n = np.where(better, xlen + b0 + 1, best_n)
    # ungap preference: centre-diagonal end ties best -> end there
    e3 = err.copy()
    for b0 in range(e):
        e3 = e3 + ((VP >> np.uint64(b0)) & U1).astype(np.int64) \
                - ((VN >> np.uint64(b0)) & U1).astype(np.int64)
    pref = (ylen - xlen >= e) & (e3 == best_err)
    best_n = np.where(pref, xlen + e, best_n)

    ok = best_err <= e
    out_err = np.where(ok, best_err, -1).astype(np.int32)
    if not traceback:
        z = np.zeros((B, XL), dtype=np.uint8)
        return BatchAlign(out_err, np.full(B, -1, np.int32),
                          best_n.astype(np.int32), z, z.copy(), z.copy())

    tb_base = np.full((B, XL), 5, dtype=np.uint8)
    ins_cnt = np.zeros((B, XL), dtype=np.uint8)
    ins_base = np.zeros((B, XL), dtype=np.uint8)
    ii = np.where(ok, xlen, 0).astype(np.int64)
    jj = np.where(ok, best_n, 0).astype(np.int64)
    rows = np.arange(B)
    max_steps = int((xlen + 2 * e + 1).max()) if B else 0
    for _ in range(max_steps):
        act = ii > 0
        if not act.any():
            break
        i_s = np.maximum(ii, 1)          # safe indices
        bb = jj - ii
        d0 = st_d0[i_s, rows]
        hp = st_hp[i_s, rows]
        vp = st_vp[i_s, rows]
        in_band = (bb >= 0) & (bb <= 2 * e)
        bbs = np.clip(bb, 0, 2 * e).astype(np.uint64)
        xc = x[rows, np.clip(i_s - 1, 0, XL - 1)]
        jc = np.clip(jj - 1, 0, YL - 1)
        yc = y[rows, jc]
        matches = (xc == yc) & (xc < 4) & (jj - 1 < ylen) & (jj >= 1)
        d0bit = ((d0 >> bbs) & U1).astype(bool)
        diag_ok = act & in_band & (jj >= 1) & (jj - 1 >= ii - 1) & \
            ((matches & d0bit) | (~matches & ~d0bit))
        vp_bb = np.clip(bb - 1, 0, 2 * e).astype(np.uint64)
        horiz_ok = act & (jj - 1 >= ii) & (bb - 1 >= 0) & \
            (((vp >> vp_bb) & U1).astype(bool))
        vert_ok = act & in_band & (jj <= ii - 1 + 2 * e) & \
            (((hp >> bbs) & U1).astype(bool))
        do_diag = diag_ok
        do_horiz = ~do_diag & horiz_ok
        do_vert = ~do_diag & ~do_horiz & vert_ok
        stuck = act & ~do_diag & ~do_horiz & ~do_vert
        if stuck.any():
            raise AssertionError("batched traceback stuck")
        p = np.clip(ii - 1, 0, XL - 1)
        dsel = np.flatnonzero(do_diag)
        tb_base[dsel, p[dsel]] = y[dsel, jc[dsel]]
        hsel = np.flatnonzero(do_horiz)
        cur = ins_cnt[hsel, p[hsel]]
        ins_cnt[hsel, p[hsel]] = np.minimum(cur.astype(np.int32) + 1,
                                            255).astype(np.uint8)
        ins_base[hsel, p[hsel]] = y[hsel, jc[hsel]]
        vsel = np.flatnonzero(do_vert)
        tb_base[vsel, p[vsel]] = 4
        ii = ii - do_diag - do_vert
        jj = jj - do_diag - do_horiz
    y_start = np.where(ok, jj, -1).astype(np.int32)
    return BatchAlign(out_err, y_start, best_n.astype(np.int32),
                      tb_base, ins_cnt, ins_base)
