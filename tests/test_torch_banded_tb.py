"""K1 of the PyTorch/CUDA port (hifiasm_tpu_torch/ops/banded_tb.py) against
the JAX package: the plain PyTorch version must be bit-equal to the host
oracle ``banded_batch_np`` and to the Pallas kernel in interpret mode, on
every output (tolerance zero).  The CUDA kernel itself is held against
the plain version on the card (``python3 chip_smoke.py``; the
``cuda``-marked case below)."""

import numpy as np
import pytest
import torch

from hifiasm_tpu.ops.banded_batch import banded_batch_np
from hifiasm_tpu.ops.pallas_tb import pallas_banded_tb
from hifiasm_tpu_torch.ops.banded_tb import banded_tb, banded_tb_torch
from tests.test_pallas_tb import _problems


def _run_torch(x, xlen, y, ylen, e, device="cpu"):
    t = [torch.as_tensor(a).to(device) for a in
         (x, xlen.astype(np.int32), y, ylen.astype(np.int32))]
    return [o.cpu().numpy() for o in banded_tb(t[0], t[1], t[2], t[3], e)]


def _assert_oracle(out, ref):
    err, ys, yn, tb, ic, ib = out
    np.testing.assert_array_equal(err, ref.err)
    np.testing.assert_array_equal(ys, ref.y_start)
    np.testing.assert_array_equal(yn, ref.y_end)
    np.testing.assert_array_equal(tb, ref.tb_base)
    np.testing.assert_array_equal(ic, ref.ins_cnt)
    np.testing.assert_array_equal(ib, ref.ins_base)


@pytest.mark.parametrize("XL,e,B", [(96, 31, 77), (160, 31, 131),
                                    (775, 31, 45), (96, 8, 70),
                                    (160, 8, 53)])
def test_plain_matches_oracle(XL, e, B):
    rng = np.random.default_rng(100 + XL + e)
    x, xlen, y, ylen = _problems(rng, B, XL, e)
    # an all-pad lane
    x[2] = 4
    y[2] = 4
    ref = banded_batch_np(x, xlen, y, ylen, e, traceback=True)
    out = _run_torch(x, xlen, y, ylen, e)
    _assert_oracle(out, ref)
    if e == 31:
        assert (out[0] >= 0).sum() > 4 and (out[0] < 0).sum() > 0


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(17)
    e = 31
    x, xlen, y, ylen = _problems(rng, 128, 96, e)
    err, ys, yn, tb, ic, ib = pallas_banded_tb(
        x, xlen, y, ylen, e, bb_lanes=128, interpret=True)
    out = _run_torch(x, xlen, y, ylen, e)
    for a, b in zip(out, (err, ys, yn, tb, ic, ib)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_short_y_and_empty_batch():
    """ylen < xlen everywhere, and B = 0."""
    rng = np.random.default_rng(3)
    e = 31
    x, xlen, y, ylen = _problems(rng, 40, 96, e)
    ylen = np.minimum(ylen, np.maximum(xlen - 5, 0))
    ref = banded_batch_np(x, xlen, y, ylen, e, traceback=True)
    _assert_oracle(_run_torch(x, xlen, y, ylen, e), ref)
    z = np.zeros((0, 96), np.uint8)
    out = _run_torch(z, np.zeros(0, np.int64), np.zeros((0, 158), np.uint8),
                     np.zeros(0, np.int64), e)
    assert [o.shape for o in out] == [(0,), (0,), (0,), (0, 96), (0, 96),
                                      (0, 96)]


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((4, 96), dtype=torch.uint8)
    y = torch.zeros((4, 160), dtype=torch.uint8)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        banded_tb(x, n, y, n, 32)
    with pytest.raises(TypeError):
        banded_tb(x.int(), n, y, n, 31)
    with pytest.raises(ValueError):
        banded_tb(x, n[:3], y, n, 31)
    with pytest.raises(ValueError):
        banded_tb(x.t().contiguous().t(), n, y, n, 31)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hifiasm_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    rng = np.random.default_rng(5)
    x, xlen, y, ylen = _problems(rng, 8, 96, 31)
    with pytest.raises((RuntimeError, AssertionError)):
        _run_torch(x, xlen, y, ylen, 31, device="cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(23)
    for XL, e in ((96, 31), (775, 31), (160, 8)):
        x, xlen, y, ylen = _problems(rng, 300, XL, e)
        t = [torch.as_tensor(a) for a in
             (x, xlen.astype(np.int32), y, ylen.astype(np.int32))]
        ref = banded_tb_torch(*t, e)
        got = banded_tb(*[a.cuda() for a in t], e)
        for a, b in zip(ref, got):
            assert torch.equal(a, b.cpu())
