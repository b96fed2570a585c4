"""The port's device front end (hifiasm_tpu_torch/index/pos_table_dev.py,
overlap/chain_device.py, ops/chain_batch.py) against the JAX package's
(index/pos_table_jax.py, overlap/chain_device.py, ops/chain_jax.py), on
the CPU, tolerance zero.

Both front ends are fed the same host-built position table, as the JAX
package's main path feeds its own (``device_table_from_host``).  The
stores are those of tests/test_chain_device.py (repeat_frac 0.25) and
tests/test_pos_table_jax.py, with a small ``chunk_mz`` so that several
chunks run; one case pads the read-length table past 2^20 reads, which
sends the JAX package down its "wide" sort."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiasm_tpu.index.pos_table import build_position_table as j_build
from hifiasm_tpu.index.pos_table_jax import (
    _lookup_kernel, _split_u64, collect_anchor_groups_device as j_groups,
    device_table_from_host as j_upload,
)
from hifiasm_tpu.ops.chain import ChainParams as JParams
from hifiasm_tpu.ops.chain_jax import chain_quick_batch as j_quick
from hifiasm_tpu.overlap.chain_device import (
    DeviceChunkChains as JChains, regions_from_device_chains as j_regions,
)
from hifiasm_tpu_torch.ec.window_align import plan_read_windows
from hifiasm_tpu_torch.index.pos_table import build_position_table
from hifiasm_tpu_torch.index.pos_table_dev import (
    collect_anchor_groups_device, device_table_from_host, lookup,
)
from hifiasm_tpu_torch.ops.chain import ChainParams
from hifiasm_tpu_torch.ops.chain_batch import chain_quick_batch
from hifiasm_tpu_torch.overlap import chain_device as CD
from hifiasm_tpu_torch.overlap.anchors import chain_many, collect_anchors_many
from tests.synth import make_genome, sample_reads
from tests.test_pos_table_jax import _reads_with_overlaps

CPU = torch.device("cpu")
REGION_FIELDS = ("y_id", "rev", "x_s", "x_e", "y_s", "y_e", "score",
                 "n_hits", "hit_ref")
COLS = ("read", "tid", "rev", "qpos", "toff", "span", "w")


def _chain_store():
    rng = np.random.default_rng(11)
    g = make_genome(rng, 40000, repeat_frac=0.25)
    reads, _, _ = sample_reads(rng, g, depth=12, read_len=5000,
                               err_rate=0.004)
    return reads, 51, 51, None, 3_000, 0


def _table_store(pad=0):
    reads = _reads_with_overlaps(np.random.default_rng(7), glen=6000,
                                 rlen=800, depth=5)
    return reads, 17, 11, 5, 500, pad


def _repeat_store():
    """test_pos_table_jax's 40-copy tandem repeat: occurrences reach the
    weight LUT's high branch and groups fail the quick pass."""
    rng = np.random.default_rng(3)
    g = np.tile(rng.integers(0, 4, 150).astype(np.uint8), 40)
    reads = [g[s:s + 450].copy() for s in rng.integers(0, len(g) - 450, 30)]
    return reads, 17, 11, 3, 200, 0


STORES = {"chain_device": _chain_store, "pos_table": _table_store,
          "pos_table_wide": lambda: _table_store(pad=1 << 20),
          "tandem_repeat": _repeat_store}


@pytest.fixture(scope="module", params=sorted(STORES))
def front(request):
    """Both front ends on one store: per chunk the JAX (cols, meta,
    chains) and the port's."""
    reads, k, w, hom, chunk_mz, pad = STORES[request.param]()
    lens = np.array([len(r) for r in reads] + [0] * pad, np.int64)
    rids = list(range(len(reads)))
    jpt, ph, _, jmzs = j_build(reads, k, w)
    pt, ph2, _, mzs = build_position_table(reads, k, w)
    assert ph == ph2
    hom = hom or (ph if ph > 0 else 12)
    jcp, cp = JParams.for_k(k), ChainParams.for_k(k)
    saved = dict(CD.STATS)
    jch = []
    for cols, meta in j_groups(jmzs, j_upload(jpt), rids, lens, hom,
                               chunk_mz=chunk_mz):
        jch.append((cols, meta, JChains(cols, meta, lens, lens, jcp)))
    tch = []
    for cols, meta in collect_anchor_groups_device(
            mzs, device_table_from_host(pt, CPU), rids, lens, hom,
            chunk_mz=chunk_mz):
        tch.append((cols, meta, CD.DeviceChunkChains(cols, meta, lens, lens,
                                                     cp)))
    stats = {k: CD.STATS[k] - saved[k] for k in saved}
    return dict(name=request.param, reads=reads, lens=lens, rids=rids,
                pt=pt, mzs=mzs, hom=hom, cp=cp, jch=jch, tch=tch,
                stats=stats)


def test_anchor_groups_match_jax(front):
    assert len(front["jch"]) == len(front["tch"]) > 1
    for (jc, jm, _), (tc, tm, _) in zip(front["jch"], front["tch"]):
        assert list(jm["reads"]) == list(tm["reads"])
        assert jm["n_keep"] == tm["n_keep"]
        if jc is None:
            assert tc is None
            continue
        nk = jm["n_keep"]
        for c in COLS:
            np.testing.assert_array_equal(
                np.asarray(jc[c])[:nk].astype(np.int64),
                tc[c].numpy().astype(np.int64), err_msg=c)
        for f in ("g_start", "g_end", "g_read", "g_tid", "g_rev"):
            np.testing.assert_array_equal(jm[f], tm[f], err_msg=f)


def test_regions_match_jax(front):
    lens = front["lens"]
    n_reg = 0
    for (_, _, jd), (_, _, td) in zip(front["jch"], front["tch"]):
        jr = j_regions(jd, lens, lens)
        tr = CD.regions_from_device_chains(td, lens, lens)
        assert [r for r, _ in jr] == [r for r, _ in tr]
        for (rr, a), (_, b) in zip(jr, tr):
            for f in REGION_FIELDS:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f"read {rr}: {f}")
            n_reg += len(a)
    assert n_reg > len(front["rids"])


def test_tws_matches_planner(front):
    """t_ws of every window: the port's device search == the host
    planner's searchsorted over the host chains == the JAX package's
    device search."""
    lens = front["lens"]
    rids = front["rids"]
    ans = collect_anchors_many(front["mzs"], front["pt"], rids, lens,
                               front["hom"])
    host = chain_many([(r, ans[r], len(front["reads"][r])) for r in rids],
                      lens, front["cp"])
    n_win = 0
    for (_, _, jd), (_, _, td) in zip(front["jch"], front["tch"]):
        for rr, ov in CD.regions_from_device_chains(td, lens, lens):
            pl = plan_read_windows(host[rr], 775, 0.04)
            if len(pl["ws"]) == 0:
                continue
            ci = ov.hit_ref[pl["ov_idx"]]
            got = td.tws_for_windows(ci, pl["ws"])
            np.testing.assert_array_equal(got, pl["t_ws"], f"read {rr}")
            np.testing.assert_array_equal(got, jd.tws_for_windows(
                ci, pl["ws"]), f"read {rr}")
            n_win += len(got)
    assert n_win > 50


def test_host_dp_groups_counted(front):
    """Groups that fail the quick pass or exceed the top bucket take the
    host DP, and are counted; the tandem repeat has some."""
    st = front["stats"]
    n_groups = sum(len(m["g_start"]) for c, m, _ in front["tch"]
                   if c is not None)
    assert st["quick_groups"] + st["host_nonquick_groups"] + \
        st["host_oversize_groups"] == n_groups
    if front["name"] == "tandem_repeat":
        assert st["host_nonquick_groups"] > 0
        assert any((d.host_ref >= 0).any() for _, _, d in front["tch"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_quick_batch_matches_jax(seed):
    """Seeded random groups: near-collinear runs (mostly quick), with
    broken links, overflowing penalty products and padding."""
    rng = np.random.default_rng(seed)
    B, N = 64, 48
    n = rng.integers(0, N + 1, B).astype(np.int32)
    step_q = rng.integers(1, 400, (B, N))
    jit = np.where(rng.random((B, N)) < 0.85, 0,
                   rng.integers(-300, 300, (B, N)))
    so = np.cumsum(step_q, 1).astype(np.int32)
    to = (so + jit + rng.integers(0, 50, (B, 1))).astype(np.int32)
    span = rng.integers(15, 60, (B, N)).astype(np.int32)
    w = rng.integers(1, 4, (B, N)).astype(np.int32)
    xl = (so.max(1) + rng.integers(0, 2000, B)).astype(np.int32)
    yl = (to.max(1) + rng.integers(0, 2000, B)).astype(np.int32)
    ref = j_quick(*(jnp.asarray(a) for a in (so, to, span, w, n, xl, yl)))
    got = chain_quick_batch(*(torch.as_tensor(a) for a in
                              (so, to, span, w, n, xl, yl)))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    quick = np.asarray(ref[2])
    assert 0 < quick.sum() < B


def test_lookup_matches_jax_with_high_bit_hashes():
    """Hashes with bit 63 set sort after the others, as unsigned."""
    rng = np.random.default_rng(9)
    h = np.unique(rng.integers(0, 2 ** 63, 300, dtype=np.uint64) |
                  np.where(rng.random(300) < 0.5, np.uint64(1 << 63),
                           np.uint64(0)))
    cnt = rng.integers(2, 9, len(h)).astype(np.int32)

    class PT:
        hashes = h
        start = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
        count = cnt
        rid = np.zeros(int(cnt.sum()), np.uint32)
        pos = np.zeros(int(cnt.sum()), np.uint32)
        rev = np.zeros(int(cnt.sum()), np.uint8)
        span = np.zeros(int(cnt.sum()), np.uint16)

    q = np.concatenate([h[rng.integers(0, len(h), 200)],
                        rng.integers(0, 2 ** 64 - 1, 200, dtype=np.uint64),
                        np.array([0, 2 ** 64 - 1], np.uint64)])
    jt = j_upload(PT)
    qhi, qlo = _split_u64(q)
    ref = _lookup_kernel(jnp.asarray(qhi), jnp.asarray(qlo), jt.h_hi,
                         jt.h_lo, jt.count, jnp.int32(jt.n_distinct),
                         n_steps=jt.search_steps)
    tt = device_table_from_host(PT, CPU)
    from hifiasm_tpu_torch.index.pos_table_dev import flip_u64
    got = lookup(torch.from_numpy(flip_u64(q)), tt)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy().astype(np.int64))
    assert np.asarray(ref[1]).sum() >= 200 and (h >> np.uint64(63)).any()
