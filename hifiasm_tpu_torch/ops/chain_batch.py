"""Batched quick chain pass on the device (PyTorch ops).

The port of the quick pass of hifiasm_tpu/ops/chain_jax.py
(``_pair_sc_vec``, ``_quick_prepass_tr``, ``chain_quick_batch``): for
[B, N] padded anchor groups it scores the consecutive-link chain over all
of a group's anchors and decides whether that chain IS the optimum
(``quick_ck_lchain``, Hash_Table.cpp:2007).  Groups that pass take the
closed-form chain; the caller sends the rest to the host scalar DP, the
reference's own shortcut before ``lchain_qdp_mcopy_fast``
(Hash_Table.cpp:2097).

Every value is ``torch.int32`` so overflow and shifts wrap exactly as
JAX's int32 does: Python-int operands keep int32, and each cumulative
op and reduction names ``dtype=torch.int32`` (PyTorch would otherwise
promote integer sums to int64).  Integer division floors, as ``//`` does
in JAX.  The full DP with the scalar engine's control flow and the
chain extraction (``chain_exact_batch``, ``extract_chains_batch``) are
in ops/chain_dev.py.
"""

from __future__ import annotations

import torch

from hifiasm_tpu_torch.ops.chain import ChainParams as _CP

NEG_INF32 = -(1 << 30)

# ChainParams.for_k(51) integer Q16/Q4 defaults (ops/chain.ChainParams)
_D = _CP.for_k(51)
_PG_Q16, _PSKIP_Q16 = _D.pg_q16, _D.pskip_q16
_BW_Q16, _INVBW_Q4 = _D.bw_q16, _D.invbw_q4

_I32 = torch.int32


def _fdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _pair_sc_vec(si, oi, spi, wi, so, to, xl, yl,
                 pg_q16, pskip_q16, bw_q16, invbw_q4):
    """comput_sc_ch_ec for anchor i against a j-vector, integer
    penalties.  Returns (sc, valid); sc is garbage where ~valid (and
    wraps there exactly as the int32 reference does)."""
    dq = si - so
    dr = oi - to
    ok = (dq > 0) & (dr > 0)
    dd = (dr - dq).abs()
    dg = torch.minimum(dr, dq)
    sf_s = (so - to).clamp(min=0)
    sf_r = xl - (si + 1)
    ot_r = yl - (oi + 1)
    sf_e = torch.where(sf_r <= ot_r, xl, si + 1 + ot_r)
    bw = ((sf_e - sf_s).clamp(min=0) * bw_q16) >> 16
    ok &= (dd <= 16) | (dd <= bw)
    sc = torch.minimum(spi, dg)
    sc = torch.where(sc >= wi, _fdiv(sc, wi.clamp(min=1)),
                     torch.ones_like(sc))
    ddc = dd.clamp(0, 8191)
    scc = sc.clamp(0, 1023)
    dgc = dg.clamp(min=1)
    lin_q4 = (ddc * pg_q16) >> 12
    apen_q4 = _fdiv(scc * ddc * invbw_q4, dgc)
    cho = torch.where(dd < 4, torch.minimum(lin_q4, apen_q4),
                      torch.maximum(lin_q4, apen_q4))
    skip_q4 = (dg.clamp(0, 262143) * pskip_q16) >> 12
    pen = torch.where((dd != 0) | (dg > spi), (cho + skip_q4) >> 4,
                      torch.zeros_like(cho))
    return sc - pen, ok


def _quick_prepass(so, to, span, weight, n, xl, yl, consts,
                   quick_check: bool):
    """Vector form of quick_ck_lchain over int32 [B, N] inputs (xl, yl
    [B, 1]); returns (in_g, fq, pre_q, quick)."""
    B, N = so.shape
    dev = so.device
    jidx = torch.arange(N, dtype=_I32, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    bw_q16 = consts[2]
    so_p = torch.cat([so[:, :1], so[:, :-1]], dim=1)        # z - 1
    to_p = torch.cat([to[:, :1], to[:, :-1]], dim=1)
    link_sc, link_ok = _pair_sc_vec(so, to, span, weight, so_p, to_p,
                                    xl, yl, *consts)
    dd_l = ((to - to_p) - (so - so_p)).abs()
    in_g = jidx < n[:, None]
    zero = torch.zeros_like(link_sc)
    fq = span[:, :1] + torch.cat(
        [torch.zeros((B, 1), dtype=_I32, device=dev),
         torch.cumsum(torch.where(in_g, link_sc, zero)[:, 1:], dim=1,
                      dtype=_I32)], dim=1)
    cond = link_ok & (fq >= span) & in_g
    cond[:, 0] = in_g[:, 0]
    unbroken = torch.cumprod(cond.to(_I32), dim=1, dtype=_I32) > 0
    quick_complete = unbroken.sum(1, dtype=_I32) == n
    fqm = torch.where(in_g, fq, torch.full_like(fq, NEG_INF32))
    mx_q = fqm.max(dim=1, keepdim=True).values
    msc_i0 = torch.where(fqm == mx_q, jidx.expand(B, N),
                         torch.full_like(fqm, -1)).max(dim=1).values
    ddt = (torch.where(in_g, dd_l, zero)[:, 1:] *
           unbroken[:, 1:].to(_I32)).sum(1, dtype=_I32)
    last = (n - 1).clamp(min=0).long()
    so0, to0 = so[:, 0], to[:, 0]
    soL = so[rows, last]
    toL = to[rows, last]
    sf_s0 = (so0 - to0).clamp(min=0)
    sf_r0 = xl[:, 0] - (soL + 1)
    ot_r0 = yl[:, 0] - (toL + 1)
    sf_e0 = torch.where(sf_r0 <= ot_r0, xl[:, 0], soL + 1 + ot_r0)
    bw_g = ((sf_e0 - sf_s0).clamp(min=0) * bw_q16) >> 16
    ddt_bad = (n >= 2) & (ddt > 16) & (ddt > bw_g)
    quick = quick_complete & (msc_i0 == n - 1) & ~ddt_bad & (n > 0)
    if not quick_check:
        quick = torch.zeros_like(quick)
    pre_q = torch.where(in_g & (jidx > 0), jidx - 1,
                        torch.full_like(fq, -1))
    return in_g, fq, pre_q, quick


def chain_quick_batch(so, to, span, weight, n, xl, yl,
                      quick_check: bool = True,
                      pg_q16: int = _PG_Q16, pskip_q16: int = _PSKIP_Q16,
                      bw_q16: int = _BW_Q16, invbw_q4: int = _INVBW_Q4):
    """Quick pre-pass alone: (fq, pre_q, quick) for [B, N] groups of
    ``n`` anchors each (fq is NEG_INF32 past a group's end).  All
    tensors on one device; results are int32 / bool there."""
    so, to, span, weight, n, xl, yl = (
        t.to(_I32) for t in (so, to, span, weight, n, xl, yl))
    consts = (pg_q16, pskip_q16, bw_q16, invbw_q4)
    in_g, fq, pre_q, quick = _quick_prepass(
        so, to, span, weight, n, xl[:, None], yl[:, None], consts,
        quick_check)
    return (torch.where(in_g, fq, torch.full_like(fq, NEG_INF32)), pre_q,
            quick)
