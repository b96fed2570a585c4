"""K2: banded Myers forward scan in scoring mode, for a batch of windows.

``banded_forward`` is the engine-shaped entry point (the signature of the
JAX package's ``banded_forward_pallas``).  For CUDA tensors it launches
the hand-written kernel ``csrc/banded_fwd.cu`` (one window per thread; it
replaces the TPU kernel ``_pallas_forward`` of
hifiasm_tpu/ops/banded_pallas.py).  For CPU tensors it runs
``banded_forward_torch``, the plain PyTorch version: K1's forward and
free-end scan (ops/banded_tb.forward_scan) without checkpoints.  There
is no fallback between the two: a CUDA tensor either goes through the
kernel or raises.

It computes the err and y_end of ``banded_batch_np(..., traceback=False)``:
x aligns globally against y with the y start free in [0, 2e] and the y
end free in [xlen, xlen + 2e], preferring the centre diagonal on a tie;
err is -1 past ``e`` errors.  It has three assembly paths, each of
which calls ``banded_batch_np`` on the host for the same err in the JAX
package: the Hi-C seed-extend rescue (phasing/hic.rescue_align, e = 8,
XL up to the longest mate), the UL chain screen (ul.ul_band_err from
``ul_align``: 75 bp windows, e = 15, every chain of a mapping pass in
one call of at most 65,536 rows) and the UL junction checks (the same
helper from ``graph_chain_paths``: windows up to 140 bp, e = 8-31, one
call per DP row and band width).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hifiasm_tpu_torch.device import resolve_device
from hifiasm_tpu_torch.ops.banded_batch import BatchAlign
from hifiasm_tpu_torch.ops.banded_tb import _check, forward_scan


def banded_forward_torch(x: torch.Tensor, xlen: torch.Tensor,
                         y: torch.Tensor, ylen: torch.Tensor, e: int):
    """Plain PyTorch version: (err, y_end), int32 [B] each."""
    err, y_end, _, _ = forward_scan(x, xlen, y, ylen, e)
    return err.int(), y_end.int()


def _launch_fn():
    from hifiasm_tpu_torch.ops.cuda_build import load

    fn = load("banded_fwd").banded_fwd_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci,
                       vp, vp, vp]
        fn.restype = ci
    return fn


def banded_forward(x: torch.Tensor, xlen: torch.Tensor, y: torch.Tensor,
                   ylen: torch.Tensor, e: int,
                   traceback: bool = False) -> BatchAlign:
    """K2 wrapper: x [B, XL] uint8, y [B, YL] uint8, xlen/ylen int32 [B],
    e <= 31.  Returns a BatchAlign of tensors on the input's device: err
    and y_end int32 [B], y_start = -1 and zeroed tb/ic/ib [B, XL] uint8
    (scoring mode; K1, ops/banded_tb.py, computes tracebacks).
    ``banded_forward.launches`` counts kernel launches."""
    if traceback:
        raise ValueError("banded_forward scores only; use "
                         "ops.banded_tb.banded_tb for tracebacks")
    _check(x, xlen, y, ylen, e)
    B, XL = x.shape
    dev = x.device
    if dev.type == "cpu":
        err, yn = banded_forward_torch(x, xlen, y, ylen, e)
    elif dev.type == "cuda":
        fn = _launch_fn()
        err = torch.empty(B, dtype=torch.int32, device=dev)
        yn = torch.empty_like(err)
        if B:
            with torch.cuda.device(dev):
                rc = fn(x.data_ptr(), xlen.data_ptr(), y.data_ptr(),
                        ylen.data_ptr(), B, XL, y.shape[1], e,
                        err.data_ptr(), yn.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"banded_fwd kernel launch failed: "
                                   f"cudaError {rc}")
            banded_forward.launches += 1
    else:
        raise ValueError(f"unsupported device {dev}")
    z = torch.zeros((3, B, XL), dtype=torch.uint8, device=dev)
    return BatchAlign(err, torch.full_like(err, -1), yn, z[0], z[1], z[2])


banded_forward.launches = 0


def banded_err_np(X: np.ndarray, xl: np.ndarray, Y: np.ndarray,
                  yl: np.ndarray, e: int, device="cuda") -> np.ndarray:
    """K2 for rows packed on the host: uploads X, Y (uint8 [n, XL] and
    [n, XL + 2e]) and the lengths to ``device``, runs ``banded_forward``
    there (the kernel for cuda, its plain version for cpu) and returns
    ``banded_batch_np(X, xl, Y, yl, e, traceback=False).err`` as int64
    [n] on the host, -1 past ``e`` errors."""
    dev = resolve_device(device)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        X, xl.astype(np.int32), Y, yl.astype(np.int32))]
    return banded_forward(*t, e).err.cpu().numpy().astype(np.int64)
