"""K2 of the PyTorch/CUDA port (hifiasm_tpu_torch/ops/banded_fwd.py) against
the JAX package, tolerance zero: the plain version gives the err of the
Pallas kernel in interpret mode (``banded_forward_pallas``) and of the
host oracle ``banded_batch_np(traceback=False)``, and their y_end where
err >= 0; it agrees with K1's plain version on every window.  The CUDA
kernel itself is held against the plain version on the card
(``python3 chip_smoke.py``; the ``cuda``-marked case below)."""

import numpy as np
import pytest
import torch

from hifiasm_tpu.ops.banded_batch import banded_batch_np
from hifiasm_tpu.ops.banded_pallas import banded_forward_pallas
from hifiasm_tpu_torch.ops.banded_fwd import banded_forward, \
    banded_forward_torch
from hifiasm_tpu_torch.ops.banded_tb import banded_tb_torch
from tests.test_banded_batch import _mk_problems


def _batch(rng, e, n=25):
    """tests/test_banded_pallas.py's windows: y is [B, XL + 2e]."""
    xs, ys = _mk_problems(rng, n, e)
    B = len(xs)
    XL = max(len(x) for x in xs)
    YL = XL + 2 * e
    xb = np.full((B, XL), 4, np.uint8)
    yb = np.full((B, YL), 4, np.uint8)
    xlen = np.array([len(x) for x in xs], np.int32)
    ylen = np.array([min(len(y), YL) for y in ys], np.int32)
    for i in range(B):
        xb[i, :xlen[i]] = xs[i]
        yb[i, :ylen[i]] = ys[i][:ylen[i]]
    return xb, xlen, yb, ylen


def _t(*arrs):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("e", [7, 31])
def test_plain_matches_pallas_and_oracle(rng, e):
    x, xlen, y, ylen = _batch(rng, e)
    ref = banded_batch_np(x, xlen, y, ylen, e, traceback=False)
    pal = banded_forward_pallas(x, xlen, y, ylen, e, interpret=True)
    err, yn = (a.numpy() for a in banded_forward_torch(*_t(x, xlen, y, ylen),
                                                       e))
    np.testing.assert_array_equal(err, ref.err)
    np.testing.assert_array_equal(err, pal.err)
    okm = ref.err >= 0
    assert okm.sum() > len(okm) // 2
    np.testing.assert_array_equal(yn[okm], ref.y_end[okm])
    np.testing.assert_array_equal(yn[okm], pal.y_end[okm])


@pytest.mark.parametrize("e", [7, 31])
def test_plain_matches_k1_plain(rng, e):
    """err and y_end of K2's plain version == K1's, on every window
    (failed and dead ones included)."""
    x, xlen, y, ylen = _batch(rng, e, n=40)
    xlen[3] = 0
    ylen[5] = 0
    ylen[7] = max(int(xlen[7]) - 9, 1)
    t = _t(x, xlen, y, ylen)
    err, yn = banded_forward_torch(*t, e)
    k1 = banded_tb_torch(*t, e)
    assert torch.equal(err, k1[0]) and torch.equal(yn, k1[2])
    assert (err < 0).any() and (err >= 0).any()


def test_wrapper_runs_plain_on_cpu(rng):
    e = 31
    x, xlen, y, ylen = _batch(rng, e)
    t = _t(x, xlen, y, ylen)
    n0 = banded_forward.launches
    out = banded_forward(*t, e)
    assert banded_forward.launches == n0       # no kernel on the CPU
    err, yn = banded_forward_torch(*t, e)
    assert torch.equal(out.err, err) and torch.equal(out.y_end, yn)
    assert (out.y_start == -1).all() and out.err.dtype == torch.int32
    for a in (out.tb_base, out.ins_cnt, out.ins_base):
        assert a.shape == x.shape and a.dtype == torch.uint8
        assert not a.any()


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((4, 96), dtype=torch.uint8)
    y = torch.zeros((4, 160), dtype=torch.uint8)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        banded_forward(x, n, y, n, 31, traceback=True)
    with pytest.raises(ValueError):
        banded_forward(x, n, y, n, 32)
    with pytest.raises(TypeError):
        banded_forward(x, n.long(), y, n, 31)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(23)
    for e in (7, 31):
        t = _t(*_batch(rng, e, n=300))
        ref = banded_forward_torch(*t, e)
        got = banded_forward(*[a.cuda() for a in t], e)
        assert torch.equal(ref[0], got.err.cpu())
        assert torch.equal(ref[1], got.y_end.cpu())
