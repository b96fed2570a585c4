"""K1: banded Myers alignment with traceback for a batch of EC windows.

``banded_tb`` is the wrapper the EC path calls.  For CUDA tensors it
launches the hand-written kernel ``csrc/banded_tb.cu`` (one window per
thread; it replaces the TPU kernel ``pallas_tb_core`` of
hifiasm_tpu/ops/pallas_tb.py).  For CPU tensors it runs
``banded_tb_torch``, the plain PyTorch version of the same function, laid
out as the kernel is: a forward scan that checkpoints its state every
``rc`` rows, then, segment by segment from the last, a recompute of the
segment's move planes and one backward step per x row for every window.
There is no fallback between the two: a CUDA tensor either goes through
the kernel or raises.

Both compute what ``ops.banded_batch.banded_batch_np`` computes: x aligns
globally against y with the y start free in [0, 2e] and the y end free in
[xlen, xlen + 2e], at most ``e`` errors (else err = -1), and the
traceback is emitted per x row as (aligned base or 4 = deletion or
5 = none, insertion count, first inserted base).  y holds codes 0..4
(4 = N or pad): the backward keeps the low three bits of each y byte.

Returns ``(err, y_start, y_end, tb, ic, ib)``: int32 [B] x3 and
uint8 [B, XL] x3 on the input's device.
"""

from __future__ import annotations

import ctypes

import torch

_M32 = 0xFFFFFFFF
_M31 = 0x7FFFFFFF
_M62 = (1 << 62) - 1
_M63 = (1 << 63) - 1

# rows per checkpoint segment: the plain version's default, equal to the
# CUDA kernel's RC (csrc/banded_myers.cuh)
RC = 16


def _add63(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2**63 for int64 a, b in [0, 2**63), without relying
    on signed overflow: the sum is formed from 32-bit halves."""
    lo = (a & _M32) + (b & _M32)
    hi = (a >> 32) + (b >> 32) + (lo >> 32)
    return ((hi & _M31) << 32) | (lo & _M32)


def _row(VP, VN, peq, xc, mask: int, zero):
    """One Myers row against x codes ``xc``: (eq, D0, HP, VP', VN')."""
    eq = torch.where(xc < 4, peq.gather(1, xc.clamp(max=3)[:, None])[:, 0],
                     zero)
    X = eq | VN
    D0 = ((_add63(VP, X & VP) & mask) ^ VP) | X
    HN = VP & D0
    HP = VN | (~(VP | D0) & mask)
    X2 = D0 >> 1
    nVN = X2 & HP
    nVP = (HN | (~(X2 | HP) & mask)) & mask
    return eq, D0, HP, nVP, nVN


def _admit(peq, y64, i: int, live, yl, W: int, codes):
    """Peq one row along y, admitting y[i + W] where the lane is live and
    that base exists."""
    peq = peq >> 1
    nb = i + W
    if nb < y64.shape[1]:
        adm = live & (nb < yl)
        peq = peq | ((adm[:, None] & (y64[:, nb, None] == codes[None, :]))
                     .long() << (W - 1))
    return peq


def forward_scan(x: torch.Tensor, xlen: torch.Tensor, y: torch.Tensor,
                 ylen: torch.Tensor, e: int, rc: int = 0):
    """The banded Myers forward scan and free-end scan: K2's plain version
    and K1's pass A.  Vectorised over the batch, a Python loop over rows.
    Band planes live in int64 (the 63-bit band fits a non-negative int64;
    every add and shift is masked) because PyTorch on the CPU has no
    unsigned 64-bit shifts, adds or compares.  Returns (err, y_end, ok,
    ckpts) with err = -1 where the best end needs more than ``e`` errors;
    with ``rc`` > 0, ckpts lists the state (VP, VN, Peq [B, 4]) before
    rows 0, rc, 2 rc, ... below xlen.max() (a lane past its xlen keeps
    its last state), else it is None."""
    dev = x.device
    B, XL = x.shape
    YL = y.shape[1]
    W = 2 * e + 1
    E2 = 2 * e
    mask = (1 << W) - 1
    x64 = x.long()
    y64 = y.long()
    xl = xlen.long().clamp(0, XL)
    yl = ylen.long()
    codes = torch.arange(4, device=dev)

    w0 = min(W, YL)
    bitpos = torch.arange(w0, device=dev)
    act0 = bitpos[None, :] < yl[:, None]
    peq = torch.stack([
        ((act0 & (y64[:, :w0] == c)).long() << bitpos[None, :]).sum(1)
        for c in range(4)], dim=1)                               # [B, 4]

    tmax = int(xl.max()) if B else 0
    ckpts = [] if rc > 0 else None
    VP = torch.zeros(B, dtype=torch.int64, device=dev)
    VN = torch.zeros_like(VP)
    err = torch.zeros_like(VP)
    zero = torch.zeros_like(VP)
    for i in range(tmax):
        if rc > 0 and i % rc == 0:
            ckpts.append((VP, VN, peq))
        live = i < xl
        _, D0, _, nVP, nVN = _row(VP, VN, peq, x64[:, i], mask, zero)
        VP = torch.where(live, nVP, VP)
        VN = torch.where(live, nVN, VN)
        err = torch.where(live, err + 1 - (D0 & 1), err)
        peq = _admit(peq, y64, i, live, yl, W, codes)

    # free-end scan over y endpoints xlen .. min(xlen + 2e, ylen)
    best_err = err.clone()
    best_n = xl.clone()
    e2 = err.clone()
    nb_max = torch.minimum(torch.full_like(yl, E2), yl - xl)
    for b0 in range(E2):
        e2 = e2 + ((VP >> b0) & 1) - ((VN >> b0) & 1)
        better = (b0 < nb_max) & (e2 < best_err)
        best_err = torch.where(better, e2, best_err)
        best_n = torch.where(better, xl + b0 + 1, best_n)
    e3 = err.clone()
    for b0 in range(e):
        e3 = e3 + ((VP >> b0) & 1) - ((VN >> b0) & 1)
    pref = (yl - xl >= e) & (e3 == best_err)
    best_n = torch.where(pref, xl + e, best_n)
    ok = best_err <= e
    out_err = torch.where(ok, best_err, torch.full_like(best_err, -1))
    return out_err, best_n, ok, ckpts


def _msb(v: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each v in [1, 2**63)."""
    p = torch.zeros_like(v)
    for s in (32, 16, 8, 4, 2, 1):
        m = v >> s
        take = m != 0
        v = torch.where(take, m, v)
        p = p + s * take.long()
    return p


def banded_tb_torch(x: torch.Tensor, xlen: torch.Tensor, y: torch.Tensor,
                    ylen: torch.Tensor, e: int, rc: int = RC):
    """Plain PyTorch version, structured as the kernel: ``forward_scan``
    with a checkpoint every ``rc`` rows; then, from the last segment to
    the first, the segment's move planes recomputed from its checkpoint
    (diag = ~(eq ^ D0) within the band, HP, VP') and one backward step
    per x row for every lane, with y kept as three code bit planes."""
    if rc < 1:
        raise ValueError(f"rc={rc} must be >= 1")
    dev = x.device
    B, XL = x.shape
    YL = y.shape[1]
    W = 2 * e + 1
    E2 = 2 * e
    mask = (1 << W) - 1
    x64 = x.long()
    y64 = y.long()
    xl = xlen.long().clamp(0, XL)
    yl = ylen.long()
    codes = torch.arange(4, device=dev)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    out_err, best_n, ok, ckpts = forward_scan(x, xlen, y, ylen, e, rc=rc)
    tmax = int(xl.max()) if B else 0

    tb = torch.full((B, XL), 5, dtype=torch.uint8, device=dev)
    ic = torch.zeros((B, XL), dtype=torch.uint8, device=dev)
    ib = torch.zeros((B, XL), dtype=torch.uint8, device=dev)
    bb = torch.where(ok, best_n - xl, zero)          # diagonal, jj - ii
    done = ~ok
    # y code planes of the row above the last segment: bit p of plane k
    # is bit k of y[top + p] (the last byte past the row's end)
    top = len(ckpts) * rc
    bits = torch.arange(63, device=dev)
    ytop = y64[:, (top + bits).clamp(max=YL - 1)]
    planes = [(((ytop >> k) & 1) << bits).sum(1) for k in range(3)]

    def code(p):
        return sum(((planes[k] >> p) & 1) << k for k in range(3))

    for s in range(len(ckpts) - 1, -1, -1):
        i0 = s * rc
        VP, VN, peq = ckpts[s]
        seg = []
        for i in range(i0, min(i0 + rc, tmax)):
            live = i < xl
            eq, D0, HP, nVP, nVN = _row(VP, VN, peq, x64[:, i], mask, zero)
            VP = torch.where(live, nVP, VP)
            VN = torch.where(live, nVN, VN)
            seg.append((~(eq ^ D0) & mask, HP, VP))
            peq = _admit(peq, y64, i, live, yl, W, codes)
        for i in range(i0 + rc - 1, i0 - 1, -1):
            c = y64[:, min(i, YL - 1)]
            planes = [((p & _M62) << 1) | ((c >> k) & 1)
                      for k, p in enumerate(planes)]
            if i >= tmax:
                continue
            dg, hp, vp = seg[i - i0]
            active = (i < xl) & ~done
            # insertions run down from bb while no diag and VP' allows
            # one; bit 0 always stops
            keep = torch.where(bb >= 62, torch.full_like(bb, _M63),
                               (1 << (bb.clamp(max=61) + 1)) - 1)
            stop = (dg | ~((vp & _M62) << 1) | 1) & keep
            bs = _msb(stop)
            n = bb - bs
            dtake = ((dg >> bs) & 1) == 1
            vtake = ~dtake & (bs < E2) & (((hp >> bs) & 1) == 1)
            otb = torch.where(dtake, code(bs),
                              torch.where(vtake, 4, 5))
            tb[:, i] = torch.where(active, otb, 5).byte()
            ic[:, i] = torch.where(active, n, 0).byte()
            ib[:, i] = torch.where(active & (n > 0),
                                   code((bs + 1).clamp(max=62)), 0).byte()
            done = done | (active & ~dtake & ~vtake)
            bb = torch.where(active, torch.where(vtake, bs + 1, bs), bb)
    y_start = torch.where(ok, bb, torch.full_like(bb, -1))
    return out_err.int(), y_start.int(), best_n.int(), tb, ic, ib


def _check(x, xlen, y, ylen, e: int) -> None:
    if not 0 <= e <= 31:
        raise ValueError(f"band half-width e={e} exceeds the 64-bit band "
                         "(W = 2e+1 must be <= 63)")
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         "be [B, XL] and [B, YL]")
    if x.shape[1] < 1 or y.shape[1] < 1:
        raise ValueError("empty window rows")
    if y.shape[1] < x.shape[1] + 2 * e:
        raise ValueError(f"y rows of {y.shape[1]} must hold the x rows of "
                         f"{x.shape[1]} and the band: YL >= XL + 2e")
    B = x.shape[0]
    for name, t, dt, shape in (("x", x, torch.uint8, None),
                               ("y", y, torch.uint8, None),
                               ("xlen", xlen, torch.int32, (B,)),
                               ("ylen", ylen, torch.int32, (B,))):
        _check_tensor(name, t, dt, shape, x.device)


def _check_tensor(name, t, dt, shape, device) -> None:
    if t.dtype != dt:
        raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")


def _check_out(out, B: int, XL: int, device) -> None:
    if len(out) != 6:
        raise ValueError("out must hold (err, y_start, y_end, tb, ic, ib)")
    for name, t, dt, shape in zip(
            ("err", "y_start", "y_end", "tb", "ic", "ib"), out,
            (torch.int32,) * 3 + (torch.uint8,) * 3,
            ((B,),) * 3 + ((B, XL),) * 3):
        _check_tensor(f"out {name}", t, dt, shape, device)


def _launch_fns():
    """The kernel's launch function and its checkpoint-size function."""
    from hifiasm_tpu_torch.ops.cuda_build import load

    lib = load("banded_tb")
    fn, size = lib.banded_tb_launch, lib.banded_tb_ckpt_bytes
    if fn.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, vp, cl, ci, ci, ci,
                       vp, vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
        size.argtypes = [ci, cl]
        size.restype = cl
    return fn, size


def banded_tb(x: torch.Tensor, xlen: torch.Tensor, y: torch.Tensor,
              ylen: torch.Tensor, e: int, out=None):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``out``, if given, is the six output tensors
    (err, y_start, y_end int32 [B]; tb, ic, ib uint8 [B, XL], contiguous,
    on x's device); the results are written there and ``out`` returned.
    ``banded_tb.launches`` counts kernel launches."""
    _check(x, xlen, y, ylen, e)
    B, XL = x.shape
    dev = x.device
    if out is not None:
        _check_out(out, B, XL, dev)
    if dev.type == "cpu":
        res = banded_tb_torch(x, xlen, y, ylen, e)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    fn, ckpt_bytes = _launch_fns()
    if out is None:
        out = (torch.empty(B, dtype=torch.int32, device=dev),
               torch.empty(B, dtype=torch.int32, device=dev),
               torch.empty(B, dtype=torch.int32, device=dev),
               torch.empty((B, XL), dtype=torch.uint8, device=dev),
               torch.empty((B, XL), dtype=torch.uint8, device=dev),
               torch.empty((B, XL), dtype=torch.uint8, device=dev))
    if B == 0:
        return tuple(out)
    # the kernel's state before every 16th row (its only scratch)
    ckpt = torch.empty(ckpt_bytes(XL, B) // 8, dtype=torch.int64,
                       device=dev)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), xlen.data_ptr(), y.data_ptr(),
                ylen.data_ptr(), B, XL, y.shape[1], e, ckpt.data_ptr(),
                *(o.data_ptr() for o in out),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"banded_tb kernel launch failed: cudaError {rc}")
    banded_tb.launches += 1
    return tuple(out)


banded_tb.launches = 0
