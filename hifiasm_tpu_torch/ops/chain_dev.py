"""Batched anchor-chain DP and chain extraction on the device (PyTorch ops).

The port of hifiasm_tpu/ops/chain_jax.py's DP functions:

- ``chain_scores_batch`` (``lchain_qdp`` scoring, Hash_Table.cpp:1515
  ``comput_sc_ch_ec``, :1475 ``cal_bw``): a loop over anchor index i
  computes, for every group of the batch, the lookback over all
  predecessors j < i in one masked [B, N] step; the scalar engine's skip
  and max_skip pruning is dropped, as in the JAX package.
- ``chain_exact_batch``: the same loop with the scalar engine's exact
  control flow (the quick pre-pass of ops/chain_batch.py, the max_skip
  break, the max_ii fallback), so (f, pre, quick) equal
  ops/chain.chain_dp_ref and the native ``ht_chain_dp`` bit for bit.
- ``extract_chains_batch``: the best chain's choice and traceback and
  the multi-copy peeling of ops/chain.extract_chains, as per-anchor
  chain labels and per-chain (count, score, first, last, hits).

Every value is int32 and wraps as JAX's does (ops/chain_batch.py); the
penalties are the integer fixed-point forms of ``ops/chain._pen_int_np``.
In the JAX package these are jitted XLA, not Pallas kernels, so here
they are PyTorch ops on the groups' device.  The JAX package's
``lax.while_loop`` traces become Python loops that test their condition
(a host sync) every ``SYNC_EVERY`` iterations: their bodies change
nothing once no lane is active, so the result does not depend on it.
"""

from __future__ import annotations

import torch

from hifiasm_tpu_torch.device import resolve_device
from hifiasm_tpu_torch.ops.chain_batch import (
    NEG_INF32, _BW_Q16, _I32, _INVBW_Q4, _PG_Q16, _PSKIP_Q16, _pair_sc_vec,
    _quick_prepass,
)

_BIG32 = 1 << 30
# [B, N] cells of one pass of chain_exact_batch's DP: about 40 int32
# planes of this size are live in a step
_MAX_CELLS = 1 << 24
# iterations of a traceback loop between two tests of its condition
SYNC_EVERY = 8


def chain_scores_batch(self_off, t_off, span, weight, n, xl, yl,
                       max_iter: int = 5000, pg_q16: int = _PG_Q16,
                       pskip_q16: int = _PSKIP_Q16, bw_q16: int = _BW_Q16,
                       invbw_q4: int = _INVBW_Q4):
    """[B, N] anchor columns -> (f, pre) int32 [B, N]: the best chain
    score ending at each anchor and its predecessor (-1 where a chain
    starts; f is NEG_INF32 past a group's ``n`` anchors).  All tensors on
    one device."""
    so, to, sp, w = (t.to(_I32) for t in (self_off, t_off, span, weight))
    n = n.to(_I32)
    B, N = so.shape
    dev = so.device
    xl = xl.to(_I32)[:, None]
    yl = yl.to(_I32)[:, None]
    consts = (pg_q16, pskip_q16, bw_q16, invbw_q4)
    jidx = torch.arange(N, dtype=_I32, device=dev)[None, :]
    neg = torch.full((B, N), NEG_INF32, dtype=_I32, device=dev)
    f = neg.clone()
    pre = torch.full((B, N), -1, dtype=_I32, device=dev)
    none = pre[:, 0].clone()
    for i in range(N):
        si, oi = so[:, i:i + 1], to[:, i:i + 1]
        spi, wi = sp[:, i:i + 1], w[:, i:i + 1]
        sc, ok = _pair_sc_vec(si, oi, spi, wi, so, to, xl, yl, *consts)
        dq = si - so
        dr = oi - to
        # max_dis (anchor.cpp:2276) and the scan's own window
        valid = ok & (jidx < i) & (jidx >= i - max_iter) & \
            (jidx < n[:, None]) & (dq <= 5000) & (dr <= 5000)
        pair = torch.where(valid, sc, neg)
        tot = torch.where(pair == NEG_INF32, neg, pair + f)
        bj = torch.argmax(tot, dim=1)                      # first max
        best = tot.gather(1, bj[:, None])[:, 0]
        base = spi[:, 0]
        use = best > base
        in_range = i < n
        f[:, i] = torch.where(in_range, torch.where(use, best, base),
                              neg[:, 0])
        pre[:, i] = torch.where(in_range & use, bj.to(_I32), none)
    return f, pre


# ---------------------------------------------------------------------------
# exact-semantics DP and extraction

def _rev_cum(x: torch.Tensor, op) -> torch.Tensor:
    """Reversed (suffix) cumulative op along the last dim; ``op`` is
    torch.cumsum (int32), torch.cummax or torch.cummin."""
    y = x.flip(-1)
    r = torch.cumsum(y, -1, dtype=_I32) if op is torch.cumsum else \
        op(y, -1).values
    return r.flip(-1)


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for [B, N] x and [B] idx (in range)."""
    return x.gather(1, idx.long()[:, None])[:, 0]


def _iterate(step, state, active, limit: int, every: int, what: str):
    """state = step(state) until active(state) is false, testing it every
    ``every`` steps; raises past ``limit`` steps."""
    it = 0
    while bool(active(state)):
        if it >= limit:
            raise RuntimeError(f"{what}: still active after {it} iterations")
        k = min(every, limit - it)
        for _ in range(k):
            state = step(state)
        it += k
    return state


def _exact_dp(so, to, span, weight, n, xl, yl, in_g, max_iter, max_skip,
              max_dis, consts):
    """The full DP of chain_exact_batch over int32 [B, N] rows (xl, yl
    [B, 1]); returns (f, pre).  One step per anchor index i, up to the
    longest group."""
    B, N = so.shape
    dev = so.device
    jidx = torch.arange(N, dtype=_I32, device=dev)[None, :]
    neg = torch.full((B, N), NEG_INF32, dtype=_I32, device=dev)
    f = neg.clone()
    pre = torch.full((B, N), -1, dtype=_I32, device=dev)
    max_ii = pre[:, 0].clone()
    m1 = torch.full((B,), -1, dtype=_I32, device=dev)
    negc = neg[:, :1]
    zc = torch.zeros((B, 1), dtype=_I32, device=dev)
    fc = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    for i in range(int(n.max()) if B else 0):
        si, oi = so[:, i:i + 1], to[:, i:i + 1]
        spi, wi = span[:, i:i + 1], weight[:, i:i + 1]
        sc_j, ok = _pair_sc_vec(si, oi, spi, wi, so, to, xl, yl, *consts)
        st = max(i - max_iter, 0)
        window = (jidx >= st) & (jidx < i) & in_g
        valid = ok & window
        tot = torch.where(valid, sc_j + f, neg)
        # t[] marks: j was recorded as a predecessor by a valid j' > j
        midx = torch.where(valid & (pre >= 0), pre, N).long()
        mark = torch.zeros((B, N + 1), dtype=torch.bool, device=dev) \
            .scatter_(1, midx, True)[:, :N]
        # improvement / skip deltas in visit order (descending j)
        m_after = torch.maximum(
            torch.cat([_rev_cum(tot, torch.cummax)[:, 1:], negc], 1), spi)
        imp = valid & (tot > m_after)
        d = torch.where(imp, -1, torch.where(valid & mark, 1, 0)).to(_I32)
        P = _rev_cum(d, torch.cumsum)                 # sum d[j..i-1]
        p_after = torch.cat([P[:, 1:], zc], 1)
        s_cnt = P - torch.clamp(_rev_cum(p_after, torch.cummin), max=0)
        bad = window & (s_cnt > max_skip)
        stopped_above = torch.cat(
            [_rev_cum(bad.to(_I32), torch.cummax)[:, 1:] > 0, fc], 1)
        visited = window & ~stopped_above
        totc = torch.where(valid & visited & ~bad, tot, neg)
        best = torch.maximum(totc.max(1).values, spi[:, 0])
        max_j = torch.where(
            best > spi[:, 0],
            torch.where(totc == best[:, None], jidx, -1).max(1).values, m1)
        j_b = torch.where(bad & visited, jidx, -1).max(1).values
        end_j = torch.where(j_b >= 0, j_b, st - 1)
        # the max_ii fallback
        stale = (max_ii < 0) | \
            (si[:, 0] > _at(so, max_ii.clamp(0, N - 1)) + max_dis)
        wm = window & (si <= max_dis + so)
        fwm = torch.where(wm, f, neg)
        mii_new = torch.where(fwm == fwm.max(1, keepdim=True).values,
                              jidx, -1).max(1).values
        mii_new = torch.where(wm.any(1), mii_new, m1)
        max_ii = torch.where(stale, mii_new, max_ii)
        mii_c = max_ii.clamp(0, N - 1)
        tmp, tok = _pair_sc_vec(si[:, 0], oi[:, 0], spi[:, 0], wi[:, 0],
                                _at(so, mii_c), _at(to, mii_c), xl[:, 0],
                                yl[:, 0], *consts)
        cand = tmp + _at(f, mii_c)
        use_fb = (max_ii >= 0) & (max_ii < end_j) & tok & (best < cand)
        in_r = i < n
        f_i = torch.where(in_r, torch.where(use_fb, cand, best), NEG_INF32)
        pre_i = torch.where(in_r, torch.where(use_fb, max_ii, max_j), -1)
        f[:, i] = f_i
        pre[:, i] = pre_i
        # maintenance
        keep = (max_ii < 0) | ((si[:, 0] <= max_dis + _at(so, mii_c)) &
                               (_at(f, mii_c) < f_i))
        max_ii = torch.where(in_r & keep, i, max_ii)
    return f, pre


def chain_exact_batch(so, to, span, weight, n, xl, yl,
                      max_iter: int = 5000, max_skip: int = 25,
                      max_dis: int = 5000, quick_check: bool = True,
                      pg_q16: int = _PG_Q16, pskip_q16: int = _PSKIP_Q16,
                      bw_q16: int = _BW_Q16, invbw_q4: int = _INVBW_Q4,
                      device="cuda"):
    """Batched chain DP with the scalar engine's exact control flow:
    [B, N] padded groups of ``n`` anchors (so, to, span, weight; xl, yl
    [B]), as numpy arrays or tensors -> (f, pre, quick) int32 / bool on
    ``device``, equal bit for bit to the JAX package's chain_exact_batch
    and to ops/chain.chain_dp_ref (lchain_qdp_mcopy_fast,
    Hash_Table.cpp:2097; quick_ck_lchain :2007).

    The DP is quadratic in N, as the JAX design is: a step per anchor
    index touches about 40 [B, N] int32 planes, so a call moves about
    160 B N^2 bytes.  Only the groups the quick pre-pass does not resolve
    run it, in passes of at most 2^24 cells (B N), up to their longest
    group."""
    dev = resolve_device(device)
    so, to, span, weight = (torch.as_tensor(t).to(dev, _I32)
                            for t in (so, to, span, weight))
    n, xl, yl = (torch.as_tensor(t).to(dev, _I32) for t in (n, xl, yl))
    B, N = so.shape
    xl, yl = xl[:, None], yl[:, None]
    consts = (pg_q16, pskip_q16, bw_q16, invbw_q4)
    in_g, fq, pre_q, quick = _quick_prepass(
        so, to, span, weight, n, xl, yl, consts, quick_check)
    f = torch.where(in_g, fq, NEG_INF32)
    pre = pre_q.clone()
    full = torch.nonzero(~quick).flatten()
    step = max(1, _MAX_CELLS // max(N, 1))
    for r0 in range(0, full.numel(), step):
        r = full[r0:r0 + step]
        f[r], pre[r] = _exact_dp(so[r], to[r], span[r], weight[r], n[r],
                                 xl[r], yl[r], in_g[r], max_iter, max_skip,
                                 max_dis, consts)
    return f, pre, quick


def extract_chains_batch(f, pre, quick, so, to, n, xl, yl,
                         mcopy_num: int = 3, mcopy_khit_cut: int = 32,
                         mcopy_q16: int = 45875, device="cuda"):
    """Batched chain extraction equal, bit for bit, to the JAX package's
    extract_chains_batch and to ops/chain.extract_chains (the native
    ht_chain_groups traceback): the best chain's choice with the quick
    and full-DP tie-breaks, its traceback, and the sequential multi-copy
    peeling (candidates by descending fpos, then ascending index; failed
    segments released; scores fpos[e] - f[stop]).  Inputs [B, N] (f,
    pre, quick from chain_exact_batch; so, to) and [B] (n, xl, yl).

    Returns on ``device``: label [B, N] int32 (-1 unused; chain k's hits
    are the label-k anchors in ascending index), cnt [B], and per chain
    [B, mcopy_num] sc, first, last, nh (hits).  Reference:
    lchain_qdp_mcopy_fast traceback + mcopy (Hash_Table.cpp:2097-2284).
    The min_sc product is int32 and wraps above a score of 46,810, as
    the JAX package's does (ROADMAP.md watch list)."""
    dev = resolve_device(device)
    f, pre, so, to = (torch.as_tensor(t).to(dev, _I32)
                      for t in (f, pre, so, to))
    n, xl, yl = (torch.as_tensor(t).to(dev, _I32) for t in (n, xl, yl))
    quick = torch.as_tensor(quick).to(dev, torch.bool)
    B, N = f.shape
    jidx = torch.arange(N, dtype=_I32, device=dev)[None, :]
    in_g = jidx < n[:, None]
    has = n > 0
    limit = N + 1

    fm = torch.where(in_g, f, NEG_INF32)
    msc = fm.max(1).values
    is_max = fm == msc[:, None]
    last_max = torch.where(is_max, jidx, -1).max(1).values
    # full-DP tie: the smallest projected overlap length, first index
    xb = torch.where(so <= to, 0, so - to)
    xr = xl[:, None] - so - 1
    yr = yl[:, None] - to - 1
    ovl = torch.where(xr <= yr, xl[:, None] - 1, so + yr) - xb + 1
    ovl_c = torch.where(is_max, ovl, _BIG32)
    first_minovl = torch.where(
        is_max & (ovl_c == ovl_c.min(1, keepdim=True).values), jidx,
        _BIG32).min(1).values
    msc_i = torch.where(has, torch.where(quick, last_max, first_minovl), -1)

    # ---- trace the best chain (label 0) ----
    def trace(st):
        cur, label = st
        act = cur >= 0
        curc = cur.clamp(0, N - 1).long()[:, None]
        label = label.scatter(1, curc, torch.where(
            act[:, None], 0, label.gather(1, curc)))
        return torch.where(act, _at(pre, curc[:, 0]), -1), label

    label = torch.full((B, N), -1, dtype=_I32, device=dev)
    _, label = _iterate(trace, (msc_i, label), lambda s: (s[0] >= 0).any(),
                        limit, SYNC_EVERY, "best-chain traceback")

    cnt = has.to(_I32)
    sc_out = torch.full((B, mcopy_num), NEG_INF32, dtype=_I32, device=dev)
    sc_out[:, 0] = torch.where(has, msc, NEG_INF32)

    if mcopy_num > 1:
        # ---- multi-copy peeling ----
        n_hits0 = (label == 0).sum(1, dtype=_I32)
        # min over in-group f only (padded lanes are NEG_INF32 and would
        # overflow the fixed-point min_sc product)
        plus = torch.where(in_g, f, _BIG32).min(1).values.clamp(max=0)
        plus = torch.where(has, plus, 0)
        min_sc = ((msc - plus) * mcopy_q16) >> 16
        fpos = f - plus[:, None]
        cand0 = in_g & (label < 0) & (fpos >= min_sc[:, None]) & \
            (n_hits0 >= mcopy_khit_cut)[:, None] & has[:, None]

        def seg_trace(s):
            cur, lab, head, label = s
            act = cur >= 0
            cc = cur.clamp(0, N - 1).long()[:, None]
            lab = lab.scatter(1, cc, torch.where(act[:, None], -2,
                                                 lab.gather(1, cc)))
            head = torch.where(act, cur, head)
            nxt = _at(pre, cc[:, 0])
            stop = (nxt < 0) | (torch.where(
                act, _at(label, nxt.clamp(0, N - 1)), -1) >= 0)
            return torch.where(act & ~stop, nxt, -1), lab, head, label

        def peel(st):
            cand, label, cnt, sc_out = st
            grp = cand.any(1) & (cnt < mcopy_num)
            fp_c = torch.where(cand & (label < 0), fpos, NEG_INF32)
            mx = fp_c.max(1).values
            e = torch.where(fp_c == mx[:, None], jidx, _BIG32).min(1).values
            pickable = grp & (mx > NEG_INF32)
            e = torch.where(pickable, e, -1)
            ec = e.clamp(0, N - 1)
            # the traceback from e, stopping at used anchors; the segment
            # is marked -2 until it is committed or released
            _, lab2, head, _ = _iterate(
                seg_trace, (e, label, torch.full_like(e, -1), label),
                lambda s: (s[0] >= 0).any(), limit, SYNC_EVERY,
                "multi-copy traceback")
            seg_len = (lab2 == -2).sum(1, dtype=_I32)
            stopj = torch.where(head >= 0, _at(pre, head.clamp(0, N - 1)),
                                -1)
            sc = torch.where(stopj < 0, _at(fpos, ec),
                             _at(fpos, ec) - _at(f, stopj.clamp(0, N - 1)))
            commit = pickable & (sc >= min_sc) & (seg_len > 1)
            newlab = torch.where(
                lab2 == -2, torch.where(commit[:, None], cnt[:, None], -1),
                lab2)
            ci = cnt.clamp(0, mcopy_num - 1)
            sc_out = sc_out.scatter(1, ci.long()[:, None], torch.where(
                commit, sc + plus, _at(sc_out, ci))[:, None])
            cnt = cnt + commit.to(_I32)
            # drop e (tried) and anything now used from the candidates
            cand = cand & (jidx != e[:, None]) & (newlab < 0)
            return cand, newlab, cnt, sc_out

        _, label, cnt, sc_out = _iterate(
            peel, (cand0, label, cnt, sc_out),
            lambda s: (s[0].any(1) & (s[2] < mcopy_num)).any(), limit, 1,
            "multi-copy peeling")

    # per-chain endpoints and hit counts
    ks = torch.arange(mcopy_num, dtype=_I32, device=dev)[None, :, None]
    mk = label[:, None, :] == ks                        # [B, m, N]
    first = torch.where(mk, jidx[:, None, :], _BIG32).min(2).values
    last = torch.where(mk, jidx[:, None, :], -1).max(2).values
    nh = mk.sum(2, dtype=_I32)
    return label, cnt, sc_out, first, last, nh
