"""K1: banded Myers alignment with traceback for a batch of EC windows.

``banded_tb`` is the wrapper the EC path calls.  For CUDA tensors it
launches the hand-written kernel ``csrc/banded_tb.cu`` (one window per
thread; it replaces the TPU kernel ``pallas_tb_core`` of
hifiasm_tpu/ops/pallas_tb.py).  For CPU tensors it runs
``banded_tb_torch``, the plain PyTorch version of the same function.
There is no fallback between the two: a CUDA tensor either goes through
the kernel or raises.

Both compute what ``ops.banded_batch.banded_batch_np`` computes: x aligns
globally against y with the y start free in [0, 2e] and the y end free in
[xlen, xlen + 2e], at most ``e`` errors (else err = -1), and the
traceback is emitted per x row as (aligned base or 4 = deletion or
5 = none, insertion count saturating at 255, first inserted base).

Returns ``(err, y_start, y_end, tb, ic, ib)``: int32 [B] x3 and
uint8 [B, XL] x3 on the input's device.
"""

from __future__ import annotations

import ctypes

import torch

_M32 = 0xFFFFFFFF
_M31 = 0x7FFFFFFF

# CUDA windows per launch: the move log takes 24 B per row per window,
# so a launch's log stays under 1.5 GiB at any window length (one launch
# covers a 65,536-window EC chunk at XL = 775)
_LOG_BYTES = 3 << 29


def _add63(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2**63 for int64 a, b in [0, 2**63), without relying
    on signed overflow: the sum is formed from 32-bit halves."""
    lo = (a & _M32) + (b & _M32)
    hi = (a >> 32) + (b >> 32) + (lo >> 32)
    return ((hi & _M31) << 32) | (lo & _M32)


def forward_scan(x: torch.Tensor, xlen: torch.Tensor, y: torch.Tensor,
                 ylen: torch.Tensor, e: int, log: bool):
    """The banded Myers forward scan and free-end scan shared by K1's and
    K2's plain versions: vectorised over the batch, a Python loop over
    rows.  Band planes live in int64 (the 63-bit band fits a non-negative
    int64; every add and shift is masked) because PyTorch on the CPU has
    no unsigned 64-bit shifts, adds or compares.  Returns (err, y_end,
    ok, logs) with err = -1 where the best end needs more than ``e``
    errors, and logs = the per-row (D0, HP, VP) planes [xlen.max(), B]
    when ``log``, else None."""
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
    logs = None
    if log:
        logs = tuple(torch.zeros((tmax, B), dtype=torch.int64, device=dev)
                     for _ in range(3))
    VP = torch.zeros(B, dtype=torch.int64, device=dev)
    VN = torch.zeros_like(VP)
    err = torch.zeros_like(VP)
    zero = torch.zeros_like(VP)
    for i in range(tmax):
        live = i < xl
        xc = x64[:, i]
        eq = torch.where(xc < 4, peq.gather(1, xc.clamp(max=3)[:, None])[:, 0],
                         zero)
        X = eq | VN
        D0 = ((_add63(VP, X & VP) & mask) ^ VP) | X
        HN = VP & D0
        HP = VN | (~(VP | D0) & mask)
        X2 = D0 >> 1
        nVN = X2 & HP
        nVP = (HN | (~(X2 | HP) & mask)) & mask
        VP = torch.where(live, nVP, VP)
        VN = torch.where(live, nVN, VN)
        err = torch.where(live, err + 1 - (D0 & 1), err)
        if log:
            logs[0][i] = torch.where(live, D0, zero)
            logs[1][i] = torch.where(live, HP, zero)
            logs[2][i] = torch.where(live, VP, zero)
        peq = peq >> 1
        nb = i + W
        if nb < YL:
            adm = live & (nb < yl)
            peq = peq | ((adm[:, None] & (y64[:, nb, None] == codes[None, :]))
                         .long() << (W - 1))

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
    return out_err, best_n, ok, logs


def banded_tb_torch(x: torch.Tensor, xlen: torch.Tensor, y: torch.Tensor,
                    ylen: torch.Tensor, e: int):
    """Plain PyTorch version: ``forward_scan`` with the move log, then the
    traceback, one move per lane per step."""
    dev = x.device
    B, XL = x.shape
    YL = y.shape[1]
    E2 = 2 * e
    x64 = x.long()
    y64 = y.long()
    xl = xlen.long().clamp(0, XL)
    yl = ylen.long()
    rows = torch.arange(B, device=dev)
    tmax = int(xl.max()) if B else 0
    out_err, best_n, ok, (st_d0, st_hp, st_vp) = forward_scan(
        x, xlen, y, ylen, e, log=True)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)

    # traceback: one move per lane per step
    tb = torch.full((B * XL,), 5, dtype=torch.uint8, device=dev)
    ic = torch.zeros(B * XL, dtype=torch.uint8, device=dev)
    ib = torch.zeros(B * XL, dtype=torch.uint8, device=dev)
    ii = torch.where(ok, xl, zero)
    jj = torch.where(ok, best_n, zero)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    four = torch.full_like(y64[:, 0], 4)
    for step in range(tmax + E2 + 1):
        act = (ii > 0) & alive
        if dev.type == "cpu" and not bool(act.any()):
            break
        r = (ii - 1).clamp(min=0)
        rr = r.clamp(max=max(tmax - 1, 0))
        bb = jj - ii
        if tmax:
            d0 = st_d0[rr, rows]
            hp = st_hp[rr, rows]
            vp = st_vp[rr, rows]
        else:
            d0 = hp = vp = zero
        in_band = (bb >= 0) & (bb <= E2)
        bbs = bb.clamp(0, E2)
        xc = x64[rows, r.clamp(max=XL - 1)]
        jc = (jj - 1).clamp(0, YL - 1)
        yc = y64[rows, jc]
        matches = (xc == yc) & (xc < 4) & (jj - 1 < yl) & (jj >= 1)
        d0bit = ((d0 >> bbs) & 1) == 1
        do_d = act & in_band & (jj >= 1) & (jj - 1 >= ii - 1) & \
            (matches == d0bit)
        vpb = (bb - 1).clamp(0, E2)
        do_h = act & ~do_d & (jj - 1 >= ii) & (bb - 1 >= 0) & \
            (((vp >> vpb) & 1) == 1)
        do_v = act & ~do_d & ~do_h & in_band & (jj <= ii - 1 + E2) & \
            (((hp >> bbs) & 1) == 1)
        alive = alive & ~(act & ~do_d & ~do_h & ~do_v)
        flat = rows * XL + r.clamp(max=XL - 1)
        tb[flat] = torch.where(do_d, yc, torch.where(do_v, four,
                                                     tb[flat].long())).byte()
        cur = ic[flat].long()
        ic[flat] = torch.where(do_h, (cur + 1).clamp(max=255), cur).byte()
        ib[flat] = torch.where(do_h, yc, ib[flat].long()).byte()
        ii = ii - do_d.long() - do_v.long()
        jj = jj - do_d.long() - do_h.long()
    y_start = torch.where(ok, jj - ii, torch.full_like(jj, -1))
    return (out_err.int(), y_start.int(), best_n.int(),
            tb.view(B, XL), ic.view(B, XL), ib.view(B, XL))


def _check(x, xlen, y, ylen, e: int) -> None:
    if not 0 <= e <= 31:
        raise ValueError(f"band half-width e={e} exceeds the 64-bit band "
                         "(W = 2e+1 must be <= 63)")
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         "be [B, XL] and [B, YL]")
    if x.shape[1] < 1 or y.shape[1] < 1:
        raise ValueError("empty window rows")
    B = x.shape[0]
    for name, t, dt, shape in (("x", x, torch.uint8, None),
                               ("y", y, torch.uint8, None),
                               ("xlen", xlen, torch.int32, (B,)),
                               ("ylen", ylen, torch.int32, (B,))):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch_fn():
    from hifiasm_tpu_torch.ops.cuda_build import load

    fn = load("banded_tb").banded_tb_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci,
                       vp, vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def banded_tb(x: torch.Tensor, xlen: torch.Tensor, y: torch.Tensor,
              ylen: torch.Tensor, e: int):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``banded_tb.launches`` counts kernel launches."""
    _check(x, xlen, y, ylen, e)
    if x.device.type == "cpu":
        return banded_tb_torch(x, xlen, y, ylen, e)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    fn = _launch_fn()
    B, XL = x.shape
    YL = y.shape[1]
    dev = x.device
    err = torch.empty(B, dtype=torch.int32, device=dev)
    ys = torch.empty_like(err)
    yn = torch.empty_like(err)
    tb = torch.empty((B, XL), dtype=torch.uint8, device=dev)
    ic = torch.empty_like(tb)
    ib = torch.empty_like(tb)
    if B == 0:
        return err, ys, yn, tb, ic, ib
    chunk = max(256, (_LOG_BYTES // (24 * XL)) // 256 * 256)
    chunk = min(chunk, B)
    mlog = torch.empty(XL * 3 * chunk, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for c0 in range(0, B, chunk):
            c1 = min(B, c0 + chunk)
            n = c1 - c0
            out_t = torch.empty((3, XL, n), dtype=torch.uint8, device=dev)
            rc = fn(x[c0:c1].data_ptr(), xlen[c0:c1].data_ptr(),
                    y[c0:c1].data_ptr(), ylen[c0:c1].data_ptr(), n, XL, YL,
                    e, mlog.data_ptr(), err[c0:c1].data_ptr(),
                    ys[c0:c1].data_ptr(), yn[c0:c1].data_ptr(),
                    out_t[0].data_ptr(), out_t[1].data_ptr(),
                    out_t[2].data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"banded_tb kernel launch failed: "
                                   f"cudaError {rc}")
            banded_tb.launches += 1
            tb[c0:c1] = out_t[0].t()
            ic[c0:c1] = out_t[1].t()
            ib[c0:c1] = out_t[2].t()
    return err, ys, yn, tb, ic, ib


banded_tb.launches = 0
