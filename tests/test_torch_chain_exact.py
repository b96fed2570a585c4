"""The port's exact chain DP and chain extraction
(hifiasm_tpu_torch/ops/chain_dev.py ``chain_exact_batch``,
``extract_chains_batch``) against the JAX package's
(hifiasm_tpu/ops/chain_jax.py), the scalar oracle
(ops/chain.chain_dp_ref, extract_chains) and the native kernel, on the
CPU, tolerance zero.

The cases are tests/test_chain_exact_jax.py's (clean, repeat and noise
groups; the native kernel; extraction with multi-copy peeling), with a
row of n = 0 in every batch; then the max_skip break and the max_ii
fallback, each shown reached (turning it off changes the result), and
the tracebacks' condition tested every 1, 3, 8 or 1,000 iterations on
lanes that each end on a different iteration."""

import numpy as np
import pytest
import torch

from hifiasm_tpu.ops.chain_jax import (
    chain_exact_batch as j_exact, extract_chains_batch as j_extract,
)
from hifiasm_tpu_torch.native import chain_dp_native
from hifiasm_tpu_torch.ops import chain_dev
from hifiasm_tpu_torch.ops.chain import (
    ChainParams, chain_dp_ref, extract_chains,
)
from hifiasm_tpu_torch.ops.chain_dev import (
    chain_exact_batch, extract_chains_batch,
)
from tests.test_chain_exact_jax import _rand_group

STYLES = ("clean", "repeat", "noise")


def _batch(rng, B, N, xl, style, n_min=3):
    """[B, N] int32 columns of random groups; row 0 is empty."""
    cols = [np.zeros((B, N), np.int32) for _ in range(4)]
    n_arr = np.zeros(B, np.int32)
    groups = [None]
    for b in range(1, B):
        n = int(rng.integers(n_min, N + 1))
        g = _rand_group(rng, n, xl, style if style else STYLES[b % 3])
        groups.append(g)
        for c in range(4):
            cols[c][b, :n] = g[c]
        n_arr[b] = n
    full = np.full(B, xl, np.int32)
    return cols, n_arr, full, groups


def _kw(p):
    return dict(max_iter=p.max_iter, max_skip=p.max_skip,
                max_dis=p.max_dis, quick_check=p.quick_check,
                pg_q16=p.pg_q16, pskip_q16=p.pskip_q16, bw_q16=p.bw_q16,
                invbw_q4=p.invbw_q4)


def _exact(cols, n_arr, xl, p):
    """(f, pre, quick) of the port, held equal to the JAX package's."""
    got = chain_exact_batch(*cols, n_arr, xl, xl, device="cpu", **_kw(p))
    ref = j_exact(*cols, n_arr, xl, xl, **_kw(p))
    for a, b, name in zip(got, ref, ("f", "pre", "quick")):
        assert a.dtype == (torch.bool if name == "quick" else torch.int32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    return tuple(t.numpy() for t in got)


def _hold_to_oracle(got, groups, xl, p, oracle=chain_dp_ref):
    f, pre, quick = got
    assert not quick[0] and (f[0] == -(1 << 30)).all() and \
        (pre[0] == -1).all()
    n_quick = 0
    for b, g in enumerate(groups):
        if g is None:
            continue
        n = len(g[0])
        fr, prer, qr = oracle(*g, int(xl[b]), int(xl[b]), p)
        assert bool(quick[b]) == bool(qr), f"row {b}: quick"
        np.testing.assert_array_equal(f[b, :n], fr, err_msg=f"row {b}: f")
        np.testing.assert_array_equal(pre[b, :n], prer,
                                      err_msg=f"row {b}: pre")
        n_quick += bool(qr)
    return n_quick


@pytest.mark.parametrize("style", STYLES)
def test_chain_exact_matches_jax_and_oracle(style):
    rng = np.random.default_rng(11)
    B, N, xl = 24, 64, 3000
    p = ChainParams.for_k(51)
    cols, n_arr, full, groups = _batch(rng, B, N, xl, style)
    n_quick = _hold_to_oracle(_exact(cols, n_arr, full, p), groups, full, p)
    if style == "clean":
        assert n_quick >= B // 2       # the pre-pass must engage
    if style == "noise":
        assert n_quick < B - 1         # the full DP must engage


def test_chain_exact_matches_native():
    rng = np.random.default_rng(11)
    B, N, xl = 16, 48, 2500
    p = ChainParams.for_k(51)
    cols, n_arr, full, groups = _batch(rng, B, N, xl, None, n_min=4)
    _hold_to_oracle(_exact(cols, n_arr, full, p), groups, full, p,
                    oracle=chain_dp_native)


def _extract(got, cols, n_arr, xl, p):
    """The port's extraction, held equal to the JAX package's."""
    f, pre, quick = got
    kw = dict(mcopy_num=p.mcopy_num, mcopy_khit_cut=p.mcopy_khit_cut,
              mcopy_q16=p.mcopy_q16)
    out = extract_chains_batch(f, pre, quick, cols[0], cols[1], n_arr, xl,
                               xl, device="cpu", **kw)
    ref = j_extract(f, pre, quick, cols[0], cols[1], n_arr, xl, xl, **kw)
    for a, b in zip(out, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return tuple(t.numpy() for t in out)


def _hold_extract(out, got, groups, cols, xl, p):
    label, cnt, sc, first, last, nh = out
    f, pre, quick = got
    assert cnt[0] == 0 and (label[0] == -1).all()
    n_multi = 0
    for b, g in enumerate(groups):
        if g is None:
            continue
        n = len(g[0])
        chains = extract_chains(f[b, :n].astype(np.int64),
                                pre[b, :n].astype(np.int64),
                                g[0], g[1], int(xl[b]), int(xl[b]), p,
                                quick=bool(quick[b]))
        assert cnt[b] == len(chains), f"row {b}: chain count"
        n_multi += len(chains) > 1
        for k, (sck, idx) in enumerate(chains):
            assert sc[b, k] == sck, f"row {b} chain {k}: score"
            np.testing.assert_array_equal(
                np.flatnonzero(label[b, :n] == k), idx,
                err_msg=f"row {b} chain {k}: hits")
            assert first[b, k] == idx[0] and last[b, k] == idx[-1]
            assert nh[b, k] == len(idx)
    return n_multi


def test_extract_chains_batch_matches_jax_and_host():
    """Traceback and multi-copy peeling == ops/chain.extract_chains."""
    rng = np.random.default_rng(11)
    B, N, xl = 24, 96, 3000
    p = ChainParams.for_k(51, mcopy_num=3, mcopy_khit_cut=6)
    cols, n_arr, full, groups = _batch(rng, B, N, xl, None, n_min=6)
    got = _exact(cols, n_arr, full, p)
    out = _extract(got, cols, n_arr, full, p)
    assert _hold_extract(out, got, groups, cols, full, p) >= 1


@pytest.mark.parametrize("path", ["max_skip", "max_ii"])
def test_chain_exact_control_paths_reached(path):
    """The max_skip break (max_skip 0) and the max_ii fallback (a scan
    window of max_iter 8) on noise groups with the quick pass off: each
    run equals the JAX package and the oracle, and turning the path off
    (max_skip past N; max_dis below any distance, which leaves no
    fallback candidate) changes (f, pre), so the path was taken."""
    rng = np.random.default_rng(1)
    B, N, xl = 32, 96, 3000
    cols, n_arr, full, groups = _batch(rng, B, N, xl, "noise", n_min=40)
    if path == "max_skip":
        on, off = dict(max_skip=0), dict(max_skip=N + 1)
    else:
        on, off = dict(max_iter=8), dict(max_iter=8, max_dis=-10 ** 6)
    res = []
    for kw in (on, off):
        p = ChainParams.for_k(51, quick_check=False, **kw)
        res.append(_exact(cols, n_arr, full, p))
        _hold_to_oracle(res[-1], groups, full, p)
    assert (res[0][1] != res[1][1]).sum() >= 3


def _line(n):
    """One collinear chain of n anchors: quick, its best chain all n."""
    so = 100 + 60 * np.arange(n, dtype=np.int64)
    return so, so + 40, np.full(n, 51, np.int64), np.ones(n, np.int64)


@pytest.mark.parametrize("kind", ["lines", "mixed"])
def test_extract_sync_every(monkeypatch, kind):
    """Testing the tracebacks' condition every 1, 3, 8 or 1,000
    iterations gives the same result, equal to the host's.  "lines": row
    b is one chain of b anchors, so every lane ends the best-chain
    traceback on a different iteration; "mixed": clean and repeat groups
    of 1..B-1 anchors, whose peeling commits second chains."""
    rng = np.random.default_rng(2)
    B, N, xl = 40, 48, 3000
    p = ChainParams.for_k(51, mcopy_khit_cut=4)
    cols = [np.zeros((B, N), np.int32) for _ in range(4)]
    n_arr = np.arange(B, dtype=np.int32)
    groups = [None]
    for b in range(1, B):
        g = _line(b) if kind == "lines" else \
            _rand_group(rng, b, xl, "clean" if b % 2 else "repeat")
        groups.append(g)
        for c in range(4):
            cols[c][b, :b] = g[c]
    full = np.full(B, xl, np.int32)
    got = _exact(cols, n_arr, full, p)
    outs = []
    for every in (1, 3, 8, 1000):
        monkeypatch.setattr(chain_dev, "SYNC_EVERY", every)
        outs.append(_extract(got, cols, n_arr, full, p))
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            np.testing.assert_array_equal(a, b)
    n_multi = _hold_extract(outs[0], got, groups, cols, full, p)
    if kind == "lines":
        assert outs[0][5][:, 0].tolist() == list(range(B))
    else:
        assert n_multi >= 3


def test_chain_dev_device_rule():
    """The new entry points run on the CPU only when asked, and a
    traceback that does not end raises instead of looping."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    z = np.zeros((1, 4), np.int32)
    one = np.ones(1, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain_exact_batch(z, z, z, z, one, one, one)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_chains_batch(z, z, one > 0, z, z, one, one, one)
    cyc = np.array([[1, 0, -1, -1]], np.int32)      # 0 -> 1 -> 0 -> ...
    with pytest.raises(RuntimeError, match="still active"):
        extract_chains_batch(np.array([[5, 5, 0, 0]], np.int32), cyc,
                             one > 0, z, z, 2 * one, one, one,
                             device="cpu")
