"""Batched anchor-chain DP on the device (PyTorch ops).

The port of hifiasm_tpu/ops/chain_jax.py ``chain_scores_batch``
(``lchain_qdp`` scoring, Hash_Table.cpp:1515 ``comput_sc_ch_ec``, :1475
``cal_bw``): a loop over anchor index i computes, for every group of the
batch, the lookback over all predecessors j < i in one masked [B, N]
step.  The scalar engine's skip and max_skip pruning is dropped, as in
the JAX package.  Every value is int32 and wraps as JAX's does
(ops/chain_batch.py); the penalties are the integer fixed-point forms of
``ops/chain._pen_int_np``.  In the JAX package this is jitted XLA, not a
Pallas kernel, so here it is PyTorch ops on the groups' device.
"""

from __future__ import annotations

import torch

from hifiasm_tpu_torch.ops.chain_batch import (
    NEG_INF32, _BW_Q16, _I32, _INVBW_Q4, _PG_Q16, _PSKIP_Q16, _pair_sc_vec,
)


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
