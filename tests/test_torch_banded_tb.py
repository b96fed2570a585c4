"""K1 of the PyTorch/CUDA port (hifiasm_tpu_torch/ops/banded_tb.py) against
the JAX package: the plain PyTorch version must be bit-equal to the host
oracle ``banded_batch_np`` and to the Pallas kernel in interpret mode, on
every output (tolerance zero), for every checkpoint segment length ``rc``
(the kernel's checkpoint + recompute + row-synchronous backward, which
the card alone runs, has the plain version's structure).  The CUDA
kernel itself is held against the plain version on the card
(``python3 chip_smoke.py``; the ``cuda``-marked case below)."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import k1_stress
from hifiasm_tpu.ops.banded_batch import banded_batch_np
from hifiasm_tpu.ops.pallas_tb import pallas_banded_tb
from hifiasm_tpu_torch.ops import cuda_build
from hifiasm_tpu_torch.ops.banded_tb import RC, banded_tb, banded_tb_torch
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


@pytest.mark.parametrize("rc", [1, 7, 16, 64, 101])
@pytest.mark.parametrize("e", [7, 31])
def test_plain_rc_matches_oracle(rc, e):
    """Every segment length, XL = 96 (rc = 101 > XL: one segment), on
    windows with xlen at multiples of rc and one either side (0 and XL
    among them), insertion and deletion runs, ylen < xlen and dead
    lanes."""
    rng = np.random.default_rng(7 * rc + e)
    x, xlen, y, ylen = k1_stress(rng, 150, 96, e, rc=min(rc, 96))
    ref = banded_batch_np(x, xlen, y, ylen, e, traceback=True)
    t = [torch.as_tensor(a) for a in (x, xlen, y, ylen)]
    out = [o.numpy() for o in banded_tb_torch(*t, e, rc=rc)]
    _assert_oracle(out, ref)
    ok = ref.err >= 0
    assert ok.sum() > 20 and (~ok).sum() > 0
    lens = set(xlen.tolist())
    assert {0, 96} <= lens and (ylen < xlen).any() and (ylen == 0).any()
    if rc < 96:                      # lanes end on and beside a boundary
        assert {rc - 1, rc, rc + 1} <= lens


def test_insertion_run_and_first_base():
    """A run of insertions longer than e/2 in one row: the bit scan takes
    the whole run at once, ic counts it and ib is its first base."""
    e, XL = 31, 160
    rng = np.random.default_rng(4)
    # x has no base 3, so the 3s can only be inserted, in one run after
    # x[79]; its first base (1) differs from x around it
    base = rng.integers(0, 3, XL).astype(np.uint8)
    base[77:81] = 0
    ins = np.array([1] + [3] * 19, np.uint8)
    yfull = np.concatenate([base[:80], ins, base[80:],
                            np.full(2 * e, 4, np.uint8)])[:XL + 2 * e]
    x = base[None, :]
    y = yfull[None, :]
    xlen = np.array([XL], np.int32)
    ylen = np.array([XL + len(ins)], np.int32)
    ref = banded_batch_np(x, xlen, y, ylen, e, traceback=True)
    for rc in (1, 16, 79, 80, 81):
        t = [torch.as_tensor(a) for a in (x, xlen, y, ylen)]
        out = [o.numpy() for o in banded_tb_torch(*t, e, rc=rc)]
        _assert_oracle(out, ref)
    assert ref.err[0] == len(ins)
    assert np.flatnonzero(ref.ins_cnt[0]).tolist() == [79]
    assert ref.ins_cnt[0, 79] == len(ins) and ref.ins_base[0, 79] == 1


def test_out_matches_fresh_outputs():
    """``out=`` fills the given tensors (row slices of larger ones, as
    DeviceEC passes) with what a call without it returns."""
    rng = np.random.default_rng(9)
    e = 31
    x, xlen, y, ylen = _problems(rng, 30, 96, e)
    t = [torch.as_tensor(a) for a in (x, xlen.astype(np.int32), y,
                                      ylen.astype(np.int32))]
    ref = banded_tb(*t, e)
    big = (torch.zeros(50, dtype=torch.int32), torch.zeros(50, dtype=torch.int32),
           torch.zeros(50, dtype=torch.int32),
           torch.zeros((50, 96), dtype=torch.uint8),
           torch.zeros((50, 96), dtype=torch.uint8),
           torch.zeros((50, 96), dtype=torch.uint8))
    out = tuple(a[10:40] for a in big)
    got = banded_tb(*t, e, out=out)
    for a, b, o in zip(got, ref, out):
        assert a is o and torch.equal(a, b)
    assert all(not a[:10].any() and not a[40:].any() for a in big)
    with pytest.raises(ValueError):
        banded_tb(*t, e, out=out[:5])
    with pytest.raises(TypeError):
        banded_tb(*t, e, out=(out[0].long(),) + out[1:])
    with pytest.raises(ValueError):
        banded_tb(*t, e, out=out[:3] + (big[3][:30, :95],) + out[4:])


def test_library_path_tracks_included_headers(tmp_path, monkeypatch):
    """An edited csrc header renames (so rebuilds) every kernel library
    that includes it; no nvcc needed."""
    (tmp_path / "h.cuh").write_text("// h v1\n")
    (tmp_path / "g.cuh").write_text('#include "h.cuh"\n')
    (tmp_path / "a.cu").write_text('#include "g.cuh"\n#include <cstdint>\n')
    (tmp_path / "b.cu").write_text("// no header\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(cuda_build, "SOURCES", {"a": "a.cu", "b": "b.cu"})
    pa, pb = cuda_build.library_path("a"), cuda_build.library_path("b")
    assert os.path.basename(pa).startswith("a-")
    (tmp_path / "h.cuh").write_text("// h v2\n")
    assert cuda_build.library_path("a") != pa
    assert cuda_build.library_path("b") == pb
    # the real kernels both include the shared forward scan
    monkeypatch.undo()
    for n in ("banded_tb", "banded_fwd"):
        assert "banded_myers.cuh" in cuda_build._sources(
            cuda_build.SOURCES[n], [])


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
    with pytest.raises(ValueError):                # YL < XL + 2e
        banded_tb(x, n, y[:, :157].contiguous(), n, 31)


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
        for x, xlen, y, ylen in (_problems(rng, 300, XL, e),
                                 k1_stress(rng, 300, XL, e, RC)):
            t = [torch.as_tensor(a) for a in
                 (x, xlen.astype(np.int32), y, ylen.astype(np.int32))]
            ref = banded_tb_torch(*t, e)
            got = banded_tb(*[a.cuda() for a in t], e)
            for a, b in zip(ref, got):
                assert torch.equal(a, b.cpu())

