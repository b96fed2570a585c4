"""EC votes: masked integer scatter-adds into the vote accumulators.

The wrappers ``raw_counts`` (L2), ``cis_votes`` (L4) and ``masked_add``
(the window seams) are what ec/device_ec.py calls on every device, and
``_route`` is the one place that picks the form.  For CUDA tensors they
launch the hand-written kernel ``csrc/vote_scatter.cu`` (it replaces no
TPU kernel: the JAX package aggregates with one-hot int8 matmuls and
log-shift rolls).  For CPU tensors they run the plain PyTorch versions
``*_torch`` of this module.  There is no fallback between the
two: a CUDA tensor either goes through the kernel or raises.

Every form adds 1 to an int32 accumulator entry for each kept entry and
adds the number of dropped (masked-off) entries to ``dropped``, an int64
scalar on the same device, when one is given: one drop per masked entry
per sub-scatter.  The accumulators keep the spare last slot of
ec/device_ec.py's layout; neither version touches it.  Integer adds
commute, so the sums are bit-identical in any order.

Column i of window w lies at ``q_row[w] * L + q_ws[w] + i`` and is valid
where ``mask[w]``, ``i < xlen[w]`` and ``q_ws[w] + i < qlen_w[w]``
(``abs_index``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch


def abs_index(XL: int, L: int, q_row, q_ws, xlen, qlen_w, okm):
    """Flat (row, pos) index [N, XL] of each window column and its mask:
    inside [ws, ws + xlen), on a kept window, before the read's end."""
    i = torch.arange(XL, device=q_row.device)[None, :]
    pos = q_ws[:, None] + i
    valid = okm[:, None] & (i < xlen[:, None]) & (pos < qlen_w[:, None])
    return q_row[:, None] * L + pos, valid


def masked_add_torch(acc: torch.Tensor, idx: torch.Tensor,
                     keep: torch.Tensor,
                     dropped: Optional[torch.Tensor] = None) -> None:
    """Plain version of ``masked_add``: acc[idx] += 1 where keep."""
    idx = idx.reshape(-1)
    keep = keep.reshape(-1)
    kept = idx[keep]
    acc.index_add_(0, kept, torch.ones_like(kept, dtype=acc.dtype))
    if dropped is not None:
        dropped += (~keep).sum()


def raw_entries(cnt: torch.Tensor, L: int, tb, q_row, q_ws, xlen, qlen_w,
                w_ok):
    """(accumulator, flat index, keep) of the L2 scatter: class tb < 5
    of each valid column into cnt [5*RL + 1]."""
    RL = (cnt.numel() - 1) // 5
    pos, valid = abs_index(tb.shape[1], L, q_row, q_ws, xlen, qlen_w, w_ok)
    cls = tb.long()
    yield cnt, cls * RL + pos, valid & (cls < 5)


def cis_entries(votes, ins_tot, ins_bc, ins_lc, L: int, tb, ic, ib, q_row,
                q_ws, xlen, qlen_w, w_cis):
    """(accumulator, flat index, keep) of each L4 sub-scatter, made one at
    a time: the consensus votes (class tb < 5) and, where ic > 0, the
    insertion total, base (ib < 4) and length (ic capped at 8) of each
    valid column."""
    RL = ins_tot.numel() - 1
    pos, valid = abs_index(tb.shape[1], L, q_row, q_ws, xlen, qlen_w, w_cis)
    cls = tb.long()
    yield votes, cls * RL + pos, valid & (cls < 5)
    c = ic.long()
    has = valid & (c > 0)
    yield ins_tot, pos, has
    b = ib.long()
    yield ins_bc, b * RL + pos, has & (b < 4)
    yield ins_lc, c.clamp(max=8) * RL + pos, has


def raw_counts_torch(cnt: torch.Tensor, L: int, tb, q_row, q_ws, xlen,
                     qlen_w, w_ok, dropped=None) -> None:
    """Plain version of ``raw_counts``."""
    for acc, idx, keep in raw_entries(cnt, L, tb, q_row, q_ws, xlen, qlen_w,
                                      w_ok):
        masked_add_torch(acc, idx, keep, dropped)


def cis_votes_torch(votes, ins_tot, ins_bc, ins_lc, L: int, tb, ic, ib,
                    q_row, q_ws, xlen, qlen_w, w_cis, dropped=None) -> None:
    """Plain version of ``cis_votes``."""
    for acc, idx, keep in cis_entries(votes, ins_tot, ins_bc, ins_lc, L, tb,
                                      ic, ib, q_row, q_ws, xlen, qlen_w,
                                      w_cis):
        masked_add_torch(acc, idx, keep, dropped)


# ---- checks ---------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the planes on {device}")


def _check_acc(name: str, acc: torch.Tensor, classes: int, RL: int,
               device) -> None:
    _check(name, acc, torch.int32, (classes * RL + 1,), device)


def _check_windows(tb, planes, q_row, q_ws, xlen, qlen_w, mask, dropped):
    if tb.dim() != 2:
        raise ValueError(f"tb must be [N, XL], got {tuple(tb.shape)}")
    dev = tb.device
    N = tb.shape[0]
    for name, t in planes:
        _check(name, t, torch.uint8, tb.shape, dev)
    _check("tb", tb, torch.uint8, None, dev)
    for name, t in (("q_row", q_row), ("q_ws", q_ws), ("xlen", xlen),
                    ("qlen_w", qlen_w)):
        _check(name, t, torch.int64, (N,), dev)
    _check("mask", mask, torch.bool, (N,), dev)
    _check_dropped(dropped, dev)


def _check_dropped(dropped, device) -> None:
    if dropped is not None:
        _check("dropped", dropped, torch.int64, (), device)


def _route(device) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return True


# ---- the kernel ----------------------------------------------------------

def _lib():
    from hifiasm_tpu_torch.ops.cuda_build import load

    lib = load("vote_scatter")
    if lib.vote_cis_launch.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vote_raw_counts_launch.argtypes = [vp] * 6 + [cl, ci, cl, cl,
                                                          vp, vp, vp]
        lib.vote_cis_launch.argtypes = [vp] * 8 + [cl, ci, cl, cl] + [vp] * 6
        lib.vote_indexed_launch.argtypes = [vp, vp, cl, vp, vp, vp]
        for fn in (lib.vote_raw_counts_launch, lib.vote_cis_launch,
                   lib.vote_indexed_launch):
            fn.restype = ci
    return lib


def _launch(fn, name: str, *args, dev) -> None:
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def raw_counts(cnt: torch.Tensor, L: int, tb: torch.Tensor, q_row, q_ws,
               xlen, qlen_w, w_ok, dropped=None) -> None:
    """L2: cnt [5*RL + 1] int32 += 1 at (class, row, pos) for each valid
    column of class tb < 5 (tb uint8 [N, XL]; q_row, q_ws, xlen, qlen_w
    int64 [N]; w_ok bool [N]).  ``raw_counts.launches`` counts kernel
    launches."""
    RL = (cnt.numel() - 1) // 5
    _check_windows(tb, (), q_row, q_ws, xlen, qlen_w, w_ok, dropped)
    _check_acc("cnt", cnt, 5, RL, tb.device)
    if not _route(tb.device):
        raw_counts_torch(cnt, L, tb, q_row, q_ws, xlen, qlen_w, w_ok,
                         dropped)
        return
    N, XL = tb.shape
    if N == 0 or XL == 0:
        return
    _launch(_lib().vote_raw_counts_launch, "vote_raw_counts",
            tb.data_ptr(), q_row.data_ptr(), q_ws.data_ptr(),
            xlen.data_ptr(), qlen_w.data_ptr(), w_ok.data_ptr(), N, XL, L,
            RL, cnt.data_ptr(), _ptr(dropped), dev=tb.device)
    raw_counts.launches += 1


def cis_votes(votes, ins_tot, ins_bc, ins_lc, L: int, tb: torch.Tensor, ic,
              ib, q_row, q_ws, xlen, qlen_w, w_cis, dropped=None) -> None:
    """L4: votes [5*RL + 1], ins_tot [RL + 1], ins_bc [4*RL + 1] and
    ins_lc [9*RL + 1] int32 += the cis-window votes, in one pass over the
    tb, ic and ib planes (uint8 [N, XL]).  ``cis_votes.launches`` counts
    kernel launches."""
    RL = ins_tot.numel() - 1
    dev = tb.device
    _check_windows(tb, (("ic", ic), ("ib", ib)), q_row, q_ws, xlen, qlen_w,
                   w_cis, dropped)
    for name, acc, k in (("votes", votes, 5), ("ins_tot", ins_tot, 1),
                         ("ins_bc", ins_bc, 4), ("ins_lc", ins_lc, 9)):
        _check_acc(name, acc, k, RL, dev)
    if not _route(dev):
        cis_votes_torch(votes, ins_tot, ins_bc, ins_lc, L, tb, ic, ib, q_row,
                        q_ws, xlen, qlen_w, w_cis, dropped)
        return
    N, XL = tb.shape
    if N == 0 or XL == 0:
        return
    _launch(_lib().vote_cis_launch, "vote_cis", tb.data_ptr(),
            ic.data_ptr(), ib.data_ptr(), q_row.data_ptr(), q_ws.data_ptr(),
            xlen.data_ptr(), qlen_w.data_ptr(), w_cis.data_ptr(), N, XL, L,
            RL, votes.data_ptr(), ins_tot.data_ptr(), ins_bc.data_ptr(),
            ins_lc.data_ptr(), _ptr(dropped), dev=dev)
    cis_votes.launches += 1


def masked_add(acc: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
               dropped=None) -> None:
    """The one-dimensional form (the window seams): acc (int32, 1-D)
    [idx] += 1 where keep (idx int64 [n], keep bool [n]); a kept index
    must lie in acc.  ``masked_add.launches`` counts kernel launches."""
    dev = acc.device
    if acc.dim() != 1:
        raise ValueError(f"acc must be 1-D, got {tuple(acc.shape)}")
    _check("acc", acc, torch.int32, None, dev)
    _check("idx", idx, torch.int64, (idx.numel(),), dev)
    _check("keep", keep, torch.bool, idx.shape, dev)
    _check_dropped(dropped, dev)
    if not _route(dev):
        masked_add_torch(acc, idx, keep, dropped)
        return
    if idx.numel() == 0:
        return
    _launch(_lib().vote_indexed_launch, "vote_indexed", idx.data_ptr(),
            keep.data_ptr(), idx.numel(), acc.data_ptr(), _ptr(dropped),
            dev=dev)
    masked_add.launches += 1


raw_counts.launches = 0
cis_votes.launches = 0
masked_add.launches = 0
