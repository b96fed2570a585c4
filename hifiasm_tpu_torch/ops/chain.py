"""Minimizer-anchor chain DP.

Re-expresses the reference's quick-DP chaining (``lchain_qdp_mcopy_fast``,
Hash_Table.cpp:2097-2284; scoring ``comput_sc_ch_ec`` :1515 and ``cal_bw``
:1475).  Two implementations share the scoring:

- ``chain_dp_ref`` — the scalar host oracle with the reference's exact
  control flow: the ``quick_ck_lchain`` O(n) consecutive-link pre-pass
  (Hash_Table.cpp:2007, resolves cleanly-collinear groups without the
  O(n*iter) DP), then the backward predecessor scan with the
  ``max_skip`` break and the ``max_ii`` long-range fallback.  The native
  C++ kernel (ht_chain_dp) is bit-compatible with this.
- ``chain_scores_batch_np`` — the vectorized [G, N] scorer mirrored by
  the device version (ops/chain_jax.py).  It omits the sequential
  pruning heuristics (they cannot vectorize); scores can differ from the
  pruned path only where max_skip truncation would have hidden a
  predecessor.

Multi-copy extraction (secondary chains of repeats) follows the reference:
after the best chain, endpoints with f >= mcopy_rate * best are traced
greedily in score order, stopping at nodes already used.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

MAX_DIS = 5000      # set_lchain_dp_op max_dis (anchor.cpp:2276)
NEG_INF = np.int64(-(1 << 62))


@dataclass
class ChainParams:
    max_iter: int = 5000
    max_dis: int = 5000           # bounds only the max_ii fallback window
    max_skip: int = 25            # backward-scan skip break (minimap2)
    quick_check: bool = True      # O(n) consecutive-link pre-pass
    bw_rate: float = 0.02         # bw_thres for HiFi EC
    chn_pen_gap: float = 0.5 * float(np.exp(-0.01 * 51))
    chn_pen_skip: float = 0.0005 * float(np.exp(-0.01 * 51))
    mcopy_num: int = 3
    mcopy_rate: float = 0.7
    mcopy_khit_cut: int = 32

    # Fixed-point penalty constants.  The reference computes chain
    # penalties in double (comput_sc_ch_ec, Hash_Table.cpp:1515); this
    # framework defines them in INTEGER Q16/Q4 fixed point instead so
    # every engine — scalar oracle, numpy batch, native C++, and the
    # int32-only TPU kernel — produces bit-identical scores with no
    # float-rounding divergence across backends (see _pen_int).
    @property
    def pg_q16(self) -> int:
        return int(round(self.chn_pen_gap * 65536.0))

    @property
    def pskip_q16(self) -> int:
        return int(round(self.chn_pen_skip * 65536.0))

    @property
    def bw_q16(self) -> int:
        return int(round(self.bw_rate * 65536.0))

    @property
    def invbw_q4(self) -> int:
        return int(round(16.0 / self.bw_rate))

    @property
    def mcopy_q16(self) -> int:
        return int(round(self.mcopy_rate * 65536.0))

    @classmethod
    def for_k(cls, k: int, is_accurate: bool = True, bw_rate: float = 0.02,
              **kw) -> "ChainParams":
        """~set_lchain_dp_op (anchor.cpp:2272)."""
        div = 0.01 if is_accurate else 0.1
        tmp = float(np.exp(-div * k))
        return cls(bw_rate=bw_rate, chn_pen_gap=0.5 * tmp,
                   chn_pen_skip=0.0005 * tmp, **kw)


def _pair_scores(self_i, off_i, span_i, w_i, self_j, off_j,
                 xl, yl, p: ChainParams):
    """Vectorized comput_sc_ch_ec for one anchor i against predecessors j."""
    dq = self_i - self_j
    dr = off_i - off_j
    ok = (dq > 0) & (dr > 0)
    dd = np.abs(dr - dq)
    dg = np.minimum(dr, dq)
    # banded filter: dd <= 16 always passes, else dd <= bw of projected ovlp
    sf_s = np.where(self_j <= off_j, 0, self_j - off_j)
    sf_r = xl - (self_i + 1)
    ot_r = yl - (off_i + 1)
    sf_e = np.where(sf_r <= ot_r, xl, self_i + 1 + ot_r)
    bw = (np.asarray(sf_e - sf_s, np.int64) * np.int64(p.bw_q16)) >> 16
    ok &= (dd <= 16) | (dd <= bw)

    sc = np.minimum(span_i, dg)
    sc = np.where(sc >= w_i, sc // np.maximum(w_i, 1), 1)  # normal_w
    pen = np.where((dd != 0) | (dg > span_i),
                   _pen_int_np(dd, dg, sc, p), 0)
    sc = sc - pen
    return np.where(ok, sc, NEG_INF)


def _pen_int_np(dd, dg, sc, p: ChainParams):
    """Integer Q4 fixed-point chain penalty, shared semantics of every
    engine (the reference's double math at Hash_Table.cpp:1552-1560
    re-defined for cross-backend bit-identity; see ChainParams)."""
    dd = np.asarray(dd, np.int64)
    dgc = np.maximum(np.asarray(dg, np.int64), 1)
    sc = np.asarray(sc, np.int64)
    lin_q4 = (np.int64(p.pg_q16) * dd) >> 12
    apen_q4 = (sc * dd * np.int64(p.invbw_q4)) // dgc
    cho = np.where(dd < 4, np.minimum(lin_q4, apen_q4),
                   np.maximum(lin_q4, apen_q4))
    skip_q4 = (np.int64(p.pskip_q16) * np.asarray(dg, np.int64)) >> 12
    return (cho + skip_q4) >> 4


def chain_scores_batch_np(self_off: np.ndarray, t_off: np.ndarray,
                          span: np.ndarray, weight: np.ndarray,
                          n: np.ndarray, xl: np.ndarray, yl: np.ndarray,
                          p: ChainParams) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized chain DP over MANY padded groups at once.

    Inputs are [G, N] anchor columns (n gives true lengths); returns
    (f, pre) [G, N].  Same scoring as the scalar path (cross-validated);
    this is the host mirror of ops/chain_jax.chain_scores_batch.
    """
    G, N = self_off.shape
    self_off = self_off.astype(np.int64)
    t_off = t_off.astype(np.int64)
    span = span.astype(np.int64)
    weight = weight.astype(np.int64)
    xl = xl.astype(np.int64)[:, None]
    yl = yl.astype(np.int64)[:, None]
    f = np.full((G, N), NEG_INF, np.int64)
    pre = np.full((G, N), -1, np.int64)
    jidx = np.arange(N)
    rows = np.arange(G)
    for i in range(N):
        si = self_off[:, i:i + 1]
        oi = t_off[:, i:i + 1]
        spi = span[:, i:i + 1]
        wi = weight[:, i:i + 1]
        dq = si - self_off
        dr = oi - t_off
        ok = (jidx[None, :] < i) & (jidx[None, :] >= i - p.max_iter) & \
            (jidx[None, :] < n[:, None]) & (dq > 0) & (dr > 0) & \
            (dq <= MAX_DIS) & (dr <= MAX_DIS)
        dd = np.abs(dr - dq)
        dg = np.minimum(dr, dq)
        sf_s = np.maximum(self_off - t_off, 0)
        sf_r = xl - (si + 1)
        ot_r = yl - (oi + 1)
        sf_e = np.where(sf_r <= ot_r, xl, si + 1 + ot_r)
        bw = (np.asarray(sf_e - sf_s, np.int64) * np.int64(p.bw_q16)) >> 16
        ok &= (dd <= 16) | (dd <= bw)
        sc = np.minimum(spi, dg)
        sc = np.where(sc >= wi, sc // np.maximum(wi, 1), 1)
        pen = np.where((dd != 0) | (dg > spi),
                       _pen_int_np(dd, dg, sc, p), 0)
        pair = np.where(ok, sc - pen, NEG_INF)
        tot = np.where(pair == NEG_INF, NEG_INF, pair + f)
        bj = np.argmax(tot, axis=1)
        best = tot[rows, bj]
        base = spi[:, 0]
        use = best > base
        in_r = i < n
        f[:, i] = np.where(in_r, np.where(use, best, base), NEG_INF)
        pre[:, i] = np.where(in_r & use, bj, -1)
    return f, pre


def _chain_bw(sj, oj, si, oi, bw_q16, xl, yl):
    """~cal_bw (Hash_Table.cpp:1475), integer Q16 band rate."""
    sf_s, sf_e = sj, si + 1
    sf_r, ot_r = xl - sf_e, yl - (oi + 1)
    sf_s = 0 if sf_s <= oj else sf_s - oj
    sf_e = sf_e + ot_r if sf_r > ot_r else xl
    return int((sf_e - sf_s) * bw_q16) >> 16


def _chain_pair_sc(si, oi, spi, wi, sj, oj, p: ChainParams, xl, yl):
    """~comput_sc_ch_ec (Hash_Table.cpp:1515); None when invalid."""
    dq = si - sj
    if dq <= 0:
        return None
    dr = oi - oj
    if dr <= 0:
        return None
    dd = abs(dr - dq)
    if dd > 16 and dd > _chain_bw(sj, oj, si, oi, p.bw_q16, xl, yl):
        return None
    dg = min(dr, dq)
    sc = min(spi, dg)
    sc = sc // max(wi, 1) if sc >= wi else 1
    if dd or (dg > spi and dg > 0):
        lin_q4 = (p.pg_q16 * dd) >> 12
        apen_q4 = (sc * dd * p.invbw_q4) // max(dg, 1)
        cho = min(lin_q4, apen_q4) if dd < 4 else max(lin_q4, apen_q4)
        sc -= (cho + ((p.pskip_q16 * dg) >> 12)) >> 4
    return sc


def chain_dp_ref(self_off, t_off, span, weight, xl: int, yl: int,
                 p: ChainParams):
    """Scalar oracle of the reference chain DP (lchain_qdp_mcopy_fast,
    Hash_Table.cpp:2097): quick consecutive-link pre-pass
    (quick_ck_lchain :2007), then — only if it fails — the full backward
    scan with the max_skip break and the max_ii fallback.  The native
    ht_chain_dp is bit-compatible (cross-validated in tests).

    Returns (f, pre, quick): quick=True means the pre-pass resolved the
    group (the best chain ends at the LAST anchor).
    """
    n = len(self_off)
    f = np.zeros(n, np.int64)
    pre = np.full(n, -1, np.int64)
    if n == 0:
        return f, pre, False
    if p.quick_check:
        f[0] = span[0]
        msc0, msc_i0, ddt = int(f[0]), 0, 0
        z = 1
        while z < n:
            dq = self_off[z] - self_off[z - 1]
            dr = t_off[z] - t_off[z - 1]
            if dq <= 0 or dr <= 0:
                break
            dd = abs(dr - dq)
            if dd > 16 and dd > _chain_bw(self_off[z - 1], t_off[z - 1],
                                          self_off[z], t_off[z],
                                          p.bw_q16, xl, yl):
                break
            sc = _chain_pair_sc(self_off[z], t_off[z], span[z], weight[z],
                                self_off[z - 1], t_off[z - 1], p, xl, yl)
            sc += int(f[z - 1])
            if sc < span[z]:
                break
            pre[z] = z - 1
            f[z] = sc
            ddt += dd
            if f[z] >= msc0:
                msc0, msc_i0 = int(f[z]), z
            z += 1
        if z >= n and msc_i0 == n - 1:
            if n >= 2 and ddt > 16 and \
                    ddt > _chain_bw(self_off[0], t_off[0], self_off[n - 1],
                                    t_off[n - 1], p.bw_q16, xl, yl):
                msc_i0 = -1
            if msc_i0 == n - 1:
                return f, pre, True
    t = np.full(n, -1, np.int64)
    st = 0
    max_ii = -1
    for i in range(n):
        si, oi = int(self_off[i]), int(t_off[i])
        spi, wi = int(span[i]), int(weight[i])
        max_f, n_skip, max_j = spi, 0, -1
        if i - st > p.max_iter:
            st = i - p.max_iter
        j = i - 1
        while j >= st:
            sc = _chain_pair_sc(si, oi, spi, wi, int(self_off[j]),
                                int(t_off[j]), p, xl, yl)
            if sc is not None:
                sc += int(f[j])
                if sc > max_f:
                    max_f, max_j = sc, j
                    if n_skip > 0:
                        n_skip -= 1
                elif t[j] == i:
                    n_skip += 1
                    if n_skip > p.max_skip:
                        break
                if pre[j] >= 0:
                    t[pre[j]] = i
            j -= 1
        end_j = j
        if max_ii < 0 or si > int(self_off[max_ii]) + p.max_dis:
            mx, max_ii = None, -1
            j = i - 1
            while j >= st and si <= p.max_dis + int(self_off[j]):
                if mx is None or mx < f[j]:
                    mx, max_ii = int(f[j]), j
                j -= 1
        if max_ii >= 0 and max_ii < end_j:
            tmp = _chain_pair_sc(si, oi, spi, wi, int(self_off[max_ii]),
                                 int(t_off[max_ii]), p, xl, yl)
            if tmp is not None and max_f < tmp + int(f[max_ii]):
                max_f, max_j = tmp + int(f[max_ii]), max_ii
        f[i] = max_f
        pre[i] = max_j
        if max_ii < 0 or (si <= p.max_dis + int(self_off[max_ii]) and
                          f[max_ii] < f[i]):
            max_ii = i
    return f, pre, False


def chain_dp_group(self_off: np.ndarray, t_off: np.ndarray, span: np.ndarray,
                   weight: np.ndarray, xl: int, yl: int, p: ChainParams
                   ) -> List[Tuple[int, np.ndarray]]:
    """Chain one (target, strand) anchor group (sorted by (self, t) offset).

    Returns [(score, hit_indices_in_group_order), ...] best chain first,
    then up to mcopy_num-1 secondary chains.
    """
    n = len(self_off)
    if n == 0:
        return []
    so = np.asarray(self_off, np.int64)
    to = np.asarray(t_off, np.int64)
    f, pre, quick = chain_dp_ref(so, to, np.asarray(span, np.int64),
                                 np.asarray(weight, np.int64), xl, yl, p)
    return extract_chains(f, pre, so, to, xl, yl, p, quick=quick)


def extract_chains(f: np.ndarray, pre: np.ndarray, self_off: np.ndarray,
                   t_off: np.ndarray, xl: int, yl: int, p: ChainParams,
                   quick: bool = False) -> List[Tuple[int, np.ndarray]]:
    """Best chain + multi-copy secondaries from a computed (f, pre)."""
    n = len(f)
    msc = int(f.max())
    cand = np.flatnonzero(f == msc)
    if quick:
        # quick-resolved group: LAST argmax (quick_ck_lchain's ">=")
        msc_i = int(cand[-1])
    elif len(cand) > 1:
        # full DP: tie -> smaller projected overlap length
        ovl = _chain_len(self_off[cand], self_off[cand], xl,
                         t_off[cand], t_off[cand], yl)
        msc_i = int(cand[np.argmin(ovl)])
    else:
        msc_i = int(cand[0])

    used = np.zeros(n, dtype=bool)
    chains = []
    hits = _trace(pre, msc_i, used)
    chains.append((msc, hits))

    if p.mcopy_num > 1 and len(hits) >= p.mcopy_khit_cut:
        plus = min(0, int(f.min()))
        msc_pos = msc - plus
        min_sc = int(msc_pos * p.mcopy_q16) >> 16
        fpos = f - plus
        cand = np.flatnonzero(~used & (fpos >= min_sc))
        order = cand[np.argsort(-fpos[cand], kind="stable")]
        for e in order:
            if len(chains) >= p.mcopy_num:
                break
            if used[e]:
                continue
            seg = _trace(pre, int(e), used, stop_at_used=True)
            if len(seg) == 0:
                continue
            stop = pre[seg[0]]
            sc = int(fpos[e]) - (int(f[stop]) - plus if stop >= 0 else 0)
            # reference: sc = f[e] - f[stop] without double plus; replicate:
            sc = int(fpos[e]) if stop < 0 else int(fpos[e] - f[stop])
            if sc >= min_sc and len(seg) > 1:
                chains.append((sc + plus, seg))
            else:
                used[seg] = False
    return chains


def _trace(pre, end, used, stop_at_used=False):
    idx = []
    i = end
    while i >= 0:
        if stop_at_used and used[i]:
            break
        if used[i] and not stop_at_used:
            break
        idx.append(i)
        used[i] = True
        i = int(pre[i])
    return np.array(idx[::-1], dtype=np.int64)


def _chain_len(xs, xe, xl, ys, ye, yl):
    """Projected overlap length ~get_chainLen (Hash_Table.cpp:779)."""
    xs = np.asarray(xs, np.int64)
    ys = np.asarray(ys, np.int64)
    xe = np.asarray(xe, np.int64)
    ye = np.asarray(ye, np.int64)
    xb = np.where(xs <= ys, 0, xs - ys)
    xr = xl - xe - 1
    yr = yl - ye - 1
    xe2 = np.where(xr <= yr, xl - 1, xe + yr)
    return xe2 - xb + 1
