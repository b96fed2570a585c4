"""The port's multi-device path (hifiasm_tpu_torch/parallel/, DeviceEC on a
mesh, ec_round's mesh branch, --profile) against the JAX package's, on
the CPU, tolerance zero.

The gold is the JAX package's own mesh on the conftest's 8 virtual CPU
devices; the port runs an 8-shard mesh of logical CPU shards
(``Mesh(["cpu"] * 8)``).  Scenarios are those of tests/test_ec_shard.py,
tests/test_index_shard.py, tests/test_chain_jax.py and
tests/test_mesh_assembly.py; the table build runs on a store of about
1 Mb."""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hifiasm_tpu.ec.device_ec as JD
from hifiasm_tpu.assemble import assemble as jax_assemble
from hifiasm_tpu.config import HifiasmConfig as JConfig
from hifiasm_tpu.index.pos_table import PositionTable as JTable
from hifiasm_tpu.io.readstore import ReadStore as JStore
from hifiasm_tpu.ops.chain_jax import chain_scores_batch as j_chain_scores
from hifiasm_tpu.parallel import ec_shard as JE
from hifiasm_tpu.parallel import index_shard as JI
from hifiasm_tpu.parallel.mesh import make_mesh as j_make_mesh
from hifiasm_tpu.parallel.sharded_align import (
    make_sharded_align_step as j_align_step,
)
from hifiasm_tpu_torch.assemble import assemble
from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.ec import device_ec as TD
from hifiasm_tpu_torch.ec import pipeline as TP
from hifiasm_tpu_torch.index.pos_table import (
    PositionTable, build_position_table,
)
from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.ops.chain import ChainParams
from hifiasm_tpu_torch.ops.chain_dev import chain_scores_batch
from hifiasm_tpu_torch.overlap.anchors import chain_many, collect_anchors_many
from hifiasm_tpu_torch.parallel import index_shard as TI
from hifiasm_tpu_torch.parallel.dryrun import dryrun_multichip
from hifiasm_tpu_torch.parallel.ec_shard import (
    MeshAnchorGather, collect_anchors_mesh,
)
from hifiasm_tpu_torch.parallel.mesh import Mesh, make_mesh
from hifiasm_tpu_torch.parallel.sharded_align import (
    make_sharded_align_step, make_sharded_chain_step,
)
from hifiasm_tpu_torch.utils import trace
from tests import synth
from tests.synth import make_genome, sample_reads
from tests.test_chain_jax import _mk_group

S = 8
CPU8 = Mesh(["cpu"] * S)
SUFFIXES = ("bp.p_ctg.gfa", "bp.r_utg.gfa", "bp.p_utg.gfa", "p_ctg.fa")
ANCHOR_FIELDS = ("tid", "rev", "self_off", "t_off", "span", "weight")


def _jmesh():
    assert len(jax.devices()) >= S, "conftest should provide 8 cpu devices"
    return j_make_mesh(S)


def _jtable(pt: PositionTable) -> JTable:
    return JTable(pt.hashes, pt.start, pt.count, pt.rid, pt.pos, pt.rev,
                  pt.span)


def _anchors_equal(a, b):
    for f in ANCHOR_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


# ---------------------------------------------------------------------------
# the anchor gather (tests/test_ec_shard.py's three scenarios)


def _gather_store(kind):
    rng = np.random.default_rng(11)
    if kind == "host":
        g = make_genome(rng, 30000)
        reads, _, _ = sample_reads(rng, g, depth=10, read_len=3000,
                                   err_rate=0.002)
        return reads, dict(q_chunk=1 << 10, classes=(4, 32))
    g = make_genome(rng, 8000)
    reads, _, _ = sample_reads(rng, g, depth=14, read_len=1500,
                               err_rate=0.0)
    return reads, dict(q_chunk=1 << 9, classes=(2, 4))


@pytest.mark.parametrize("kind", ["host", "high_occ_fallback"])
def test_mesh_anchor_gather_matches_jax_and_host(kind):
    reads, kw = _gather_store(kind)
    lens = np.array([len(r) for r in reads])
    pt, hom, _, mzs = build_position_table(reads, 51, 51)
    hom_cov = hom if hom > 0 else 10
    rids = list(range(len(reads)))
    host = collect_anchors_many(mzs, pt, rids, lens, hom_cov)
    gather = MeshAnchorGather(pt, CPU8, **kw)
    got = collect_anchors_mesh(mzs, gather, rids, lens, hom_cov)
    jg = JE.MeshAnchorGather(_jtable(pt), _jmesh(), **kw)
    gold = JE.collect_anchors_mesh(mzs, jg, rids, lens, hom_cov)
    assert len(got) == len(host) == len(gold)
    for a, b, c in zip(got, host, gold):
        _anchors_equal(a, b)
        _anchors_equal(a, c)
    assert sum(len(a.tid) > 0 for a in got) > len(reads) // 2
    assert gather.n_fallback == jg.n_fallback
    if kind == "high_occ_fallback":
        assert gather.n_fallback > 0


def _skew_table(h_bit63: bool = False):
    rng = np.random.default_rng(7)
    # hashes all congruent to 3 mod 8: one shard owns everything
    hashes = (rng.integers(1, 1 << 58, 256).astype(np.uint64)
              << np.uint64(3)) | np.uint64(3)
    if h_bit63:
        hashes[::2] |= np.uint64(1 << 63)
    hashes = np.unique(hashes)
    H = len(hashes)
    counts = np.full(H, 2, np.int32)
    counts[0] = 100                       # beyond the largest class (64)
    start = np.zeros(H, np.int64)
    start[1:] = np.cumsum(counts[:-1])
    P = int(counts.sum())
    pt = PositionTable(
        hashes=hashes, start=start, count=counts,
        rid=rng.integers(0, 1000, P).astype(np.uint32),
        pos=rng.integers(0, 1 << 20, P).astype(np.uint32),
        rev=rng.integers(0, 2, P).astype(np.uint8),
        span=np.full(P, 51, np.uint16))
    return pt


@pytest.mark.parametrize("bit63", [False, True])
def test_mesh_gather_bucket_skew_and_highocc(bit63):
    """Every query hashes to one shard, a hot k-mer takes the host
    fallback; with ``bit63`` half the hashes have bit 63 set, where a
    signed order would differ from the unsigned one."""
    pt = _skew_table(bit63)
    q = np.concatenate([pt.hashes, pt.hashes[::2]])   # duplicates too
    g = MeshAnchorGather(pt, CPU8, q_chunk=1 << 8)
    got = g.gather(q)
    jg = JE.MeshAnchorGather(_jtable(pt), _jmesh(), q_chunk=1 << 8)
    gold = jg.gather(q)
    for a, b in zip(got, gold):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    exp = pt.count[np.searchsorted(pt.hashes, q)]
    np.testing.assert_array_equal(got[0], exp.astype(np.int64))
    assert g.n_fallback == jg.n_fallback >= 1


# ---------------------------------------------------------------------------
# the sharded index (tests/test_index_shard.py)


def _index_store():
    rng = np.random.default_rng(11)
    g = make_genome(rng, 12000)
    reads, _, _ = sample_reads(rng, g, depth=8, read_len=2000, err_rate=0.0)
    pt, _, _, _ = build_position_table(reads, 51, 51)
    return rng, pt


def _padded(qs):
    Q = -(-len(qs) // S) * S
    return np.concatenate([qs, np.zeros(Q - len(qs), np.uint64)])


def test_sharded_index_build_matches_jax():
    _, pt = _index_store()
    idx = TI.ShardedIndex.build(pt, S)
    jidx = JI.ShardedIndex.build(_jtable(pt), S)
    bits = (jidx.h_hi.astype(np.uint64) << np.uint64(32)) | jidx.h_lo
    np.testing.assert_array_equal(idx.hashes, bits)
    np.testing.assert_array_equal(idx.counts, jidx.counts)
    np.testing.assert_array_equal(idx.h_len, jidx.h_len)
    sp = TI.ShardedPostings.build(pt, S)
    jsp = JI.ShardedPostings.build(_jtable(pt), S)
    for f in ("start", "p_rid", "p_pos"):
        np.testing.assert_array_equal(getattr(sp, f), getattr(jsp, f), f)


def test_sharded_cnt_matches_jax():
    rng, pt = _index_store()
    qs = np.concatenate([pt.hashes[::3],
                         rng.integers(1, 1 << 60, 64).astype(np.uint64)])
    qs_p = _padded(qs)
    cap = 2 * (len(qs_p) // S) + 8
    got = TI.sharded_cnt_np(TI.make_sharded_cnt(
        CPU8, TI.ShardedIndex.build(pt, S), cap), qs_p)
    gold = JI.sharded_cnt_np(
        JI.make_sharded_cnt(_jmesh(), JI.ShardedIndex.build(_jtable(pt), S),
                            cap), qs_p, S)
    np.testing.assert_array_equal(got, gold)
    np.testing.assert_array_equal(got[:len(qs)], pt.cnt(qs))


def test_sharded_postings_match_jax():
    rng, pt = _index_store()
    qs = _padded(np.concatenate(
        [pt.hashes[::5], rng.integers(1, 1 << 60, 32).astype(np.uint64)]))
    cap, K = 2 * (len(qs) // S) + 8, 8
    got = TI.make_sharded_postings(CPU8, TI.ShardedPostings.build(pt, S),
                                   cap, K)(TI.hash_bits(qs))
    hi, lo = JI._split64(qs)
    gold = JI.make_sharded_postings(
        _jmesh(), JI.ShardedPostings.build(_jtable(pt), S), cap, K)(
        jnp.asarray(hi), jnp.asarray(lo))
    for a, b in zip(got, gold):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((got[0] > 0).sum()) > 20


def test_mesh_table_build_matches_jax():
    """The table built on the mesh (postings routed to owners, per-shard
    sort and segment reduce, summed histogram) on a ~1 Mb store: hist,
    h_len and every kept hash's lookup equal to the JAX package's."""
    rng = np.random.default_rng(11)
    g = make_genome(rng, 100_000)
    reads, _, _ = sample_reads(rng, g, depth=11, read_len=15000,
                               err_rate=0.002)
    assert sum(len(r) for r in reads) >= 1_000_000
    pt, _, _, mz = build_position_table(reads, 51, 51)
    qf, hist, h_len = TI.build_sharded_postings_mesh(CPU8, mz)
    jqf, jhist, jh_len = JI.build_sharded_postings_mesh(_jmesh(), mz)
    np.testing.assert_array_equal(hist, np.asarray(jhist))
    np.testing.assert_array_equal(h_len, np.asarray(jh_len))
    assert int(h_len.sum()) == pt.n_distinct
    kmax = int(pt.count.max())
    qs = _padded(pt.hashes)
    got = qf(kmax)(TI.hash_bits(qs))
    hi, lo = JI._split64(qs)
    gold = jqf(kmax)(jnp.asarray(hi), jnp.asarray(lo))
    for a, b in zip(got, gold):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[0].numpy()[:pt.n_distinct], pt.count)


def test_lane_overflow_raises_like_jax():
    """A lane of ``cap`` queries that gets more raises RuntimeError in
    both packages (all queries skewed onto one owner)."""
    pt = _skew_table()
    qs = _padded(pt.hashes[:64])
    cap = 4
    with pytest.raises(RuntimeError, match="lane overflow"):
        JI.sharded_cnt_np(JI.make_sharded_cnt(
            _jmesh(), JI.ShardedIndex.build(_jtable(pt), S), cap), qs, S)
    with pytest.raises(RuntimeError, match="lane overflow"):
        TI.sharded_cnt_np(TI.make_sharded_cnt(
            CPU8, TI.ShardedIndex.build(pt, S), cap), qs)


def test_three_shard_mesh_raises_like_jax(tmp_path):
    """The JAX package asserts a power-of-two shard count in its index,
    though its mesh rule can form a mesh of 3; the port raises there
    too, from the index build and from a whole assembly."""
    _, pt = _index_store()
    with pytest.raises(AssertionError):
        JI.ShardedIndex.build(_jtable(pt), 3)
    with pytest.raises(AssertionError):
        TI.ShardedIndex.build(pt, 3)
    reads = _e2e_reads()
    names = [f"r{i}" for i in range(len(reads))]
    with pytest.raises(AssertionError):
        jax_assemble(JStore.from_arrays(names, reads), JConfig(
            output_prefix=str(tmp_path / "j3"), n_rounds_ec=1,
            ignore_bin=True, align_engine="jax", mesh_devices=3))
    with pytest.raises(AssertionError):
        assemble(ReadStore.from_arrays(names, reads), HifiasmConfig(
            output_prefix=str(tmp_path / "t3"), n_rounds_ec=1,
            ignore_bin=True), device="cpu", mesh=Mesh(["cpu"] * 3))


def test_pos_packing_wraps_like_jax():
    """(span << 24 | pos) holds positions below 2^24 only; past it both
    packages pack the same (wrong) lane."""
    pt = _skew_table()
    pt.pos[:8] = np.uint32((1 << 24) + 5)
    sp = TI.ShardedPostings.build(pt, S)
    jsp = JI.ShardedPostings.build(_jtable(pt), S)
    np.testing.assert_array_equal(sp.p_pos, jsp.p_pos)


# ---------------------------------------------------------------------------
# chain scores, the sharded steps, the EC routing


def _chain_inputs():
    rng = np.random.default_rng(11)
    B, N, xl = 8, 48, 2100
    cols = [np.zeros((B, N), np.int32) for _ in range(4)]
    n_arr = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(8, N + 1))
        g = _mk_group(rng, n, xl)
        for c in range(4):
            cols[c][b, :n] = g[c]
        n_arr[b] = n
    return cols, n_arr, np.full(B, xl, np.int32), np.full(B, xl, np.int32)


def test_chain_scores_batch_matches_jax():
    cols, n, xl, yl = _chain_inputs()
    f, pre = chain_scores_batch(*(torch.as_tensor(a) for a in
                                  (*cols, n, xl, yl)))
    jf, jpre = j_chain_scores(*cols, n, xl, yl)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pre.numpy(), np.asarray(jpre))


def test_chain_many_device_route_matches_numpy():
    rng = np.random.default_rng(11)
    g = make_genome(rng, 20000, repeat_frac=0.2)
    reads, _, _ = sample_reads(rng, g, depth=10, read_len=3000,
                               err_rate=0.003)
    lens = np.array([len(r) for r in reads])
    pt, hom, _, mzs = build_position_table(reads, 51, 51)
    rids = list(range(len(reads)))
    ans = collect_anchors_many(mzs, pt, rids, lens, hom if hom > 0 else 10)
    rr = [(r, a, int(lens[r])) for r, a in zip(rids, ans)]
    cp = ChainParams.for_k(51)
    dev = chain_many(rr, lens, cp, device_threshold=0, device="cpu")
    ref = chain_many(rr, lens, cp, device_threshold=1 << 62, device="cpu")
    assert sum(len(o) for o in dev) > 100
    for a, b in zip(dev, ref):
        for f in ("y_id", "rev", "x_s", "x_e", "y_s", "y_e", "score",
                  "n_hits", "hit_self", "hit_t"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_sharded_steps_match_jax():
    rng = np.random.default_rng(11)
    e, XL = 7, 48
    YL = XL + 2 * e
    B = 4 * S
    y = rng.integers(0, 4, (B, YL)).astype(np.uint8)
    x = y[:, e:e + XL].copy()
    x[::3, 5] = (x[::3, 5] + 1) % 4
    xl = np.full(B, XL, np.int32)
    xl[::5] = XL - 9
    yl = np.full(B, YL, np.int32)
    got = make_sharded_align_step(CPU8, e)(x, xl, y, yl)
    gold = j_align_step(_jmesh(), e)(x, xl, y, yl)
    for k, (a, b) in enumerate(zip(got, gold)):
        # the JAX step returns the [B, XL] planes flattened
        np.testing.assert_array_equal(a.numpy().reshape(-1),
                                      np.asarray(b).reshape(-1), str(k))
    assert int(got[6][0]) == B
    cols, n, xl, yl = _chain_inputs()
    best, bidx = make_sharded_chain_step(CPU8)(*cols, n, xl, yl)
    f, _ = chain_scores_batch(*(torch.as_tensor(a) for a in
                                (*cols, n, xl, yl)))
    np.testing.assert_array_equal(best.numpy(), f.max(1).values.numpy())
    np.testing.assert_array_equal(bidx.numpy(), f.argmax(1).numpy())


def test_route_windows_matches_jax():
    rng = np.random.default_rng(11)
    q_row = rng.integers(0, 200, 3000).astype(np.int32)
    for nd, chunk in ((8, 8192), (4, 1000), (3, 999)):
        fake = types.SimpleNamespace(n_dev=nd, chunk=chunk)
        want = JD.DeviceEC._route_windows(fake, q_row, 256 // nd * nd)
        got = TD.route_windows(q_row, 256 // nd * nd, nd, chunk)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        owners = TD.shard_windows(got[0], nd, chunk)
        assert sorted(np.concatenate(owners).tolist()) == list(range(3000))


def test_active_mesh_rule(monkeypatch):
    """n = avail if mesh_devices == 0 else min(mesh_devices, avail); one
    device is no mesh.  The CPU counts as one device."""
    for md in (0, 1, 8):
        assert TP._active_mesh(HifiasmConfig(mesh_devices=md), "cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for md, want in ((0, 4), (1, None), (2, 2), (3, 3), (9, 4)):
        m = TP._active_mesh(HifiasmConfig(mesh_devices=md), "cuda")
        got = None if m is None else len(m)
        assert got == want, (md, got)
    assert [str(d) for d in make_mesh(None, "cuda").devices] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]


# ---------------------------------------------------------------------------
# the slice end to end


def _e2e_reads():
    rng = np.random.default_rng(11)
    g = make_genome(rng, 12000)
    reads, _, _ = sample_reads(rng, g, depth=12, read_len=1800,
                               err_rate=0.004)
    return reads


def _capture(monkeypatch, owner, name, method):
    calls = []
    orig = getattr(owner, name)

    def wrapped(*a):
        out = orig(*a)
        q_row, Rp = a[-2:] if method else a[:2]
        calls.append((np.array(q_row), int(Rp), out))
        return out
    monkeypatch.setattr(owner, name, wrapped)
    return calls


def test_mesh_assembly_end_to_end(tmp_path, monkeypatch):
    """test_mesh_assembly.py's store, one EC round: the port on an
    8-shard mesh, the JAX package with mesh_devices=0 (its 8-device
    mesh) and the port with no mesh give byte-identical outputs; the
    read rows (LPT) and window slot maps of every routed pass equal the
    JAX package's; on the mesh, the reads with an ambiguity cluster took
    their host DAG pass from traceback columns gathered on the shards."""
    reads = _e2e_reads()
    names = [f"r{i}" for i in range(len(reads))]
    jcalls = _capture(monkeypatch, JD.DeviceEC, "_route_windows", True)
    jax_assemble(JStore.from_arrays(names, reads), JConfig(
        output_prefix=str(tmp_path / "jax"), n_rounds_ec=1, ignore_bin=True,
        align_engine="jax", mesh_devices=0))
    tcalls = _capture(monkeypatch, TD, "route_windows", False)
    trace.reset()
    assemble(ReadStore.from_arrays(names, reads), HifiasmConfig(
        output_prefix=str(tmp_path / "mesh"), n_rounds_ec=1,
        ignore_bin=True), device="cpu", mesh=CPU8)
    assert TP.STATS["mesh_rounds"] == 1
    assert TP.STATS["host_dag_reads"] > 0
    assert TP.STATS["host_dag_native_reads"] == TP.STATS["host_dag_reads"]
    assert TP.STATS["host_dag_fallback_reads"] == 0
    assert TD.STATS["dag_gather_windows"] > 0
    assemble(ReadStore.from_arrays(names, reads), HifiasmConfig(
        output_prefix=str(tmp_path / "one"), n_rounds_ec=1,
        ignore_bin=True), device="cpu")
    for suf in SUFFIXES:
        data = [open(tmp_path / f"{t}.{suf}", "rb").read()
                for t in ("jax", "mesh", "one")]
        assert data[0], suf
        assert data[0] == data[1] == data[2], suf
    assert len(jcalls) == len(tcalls) >= 1
    for (jq, jR, jo), (tq, tR, to) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(jq, tq)
        assert jR == tR
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nd", [8, 3])
def test_device_ec_on_mesh_matches_jax(nd):
    """DeviceEC over logical shards (any count: the EC routing has no
    power-of-two rule) gives the JAX package's single-device results."""
    from tests.test_torch_device_ec import J, _assert_same, _ec_inputs

    store, jstore, read_ovs, cfg = _ec_inputs()
    ref = J.DeviceEC(jstore, wl=cfg.ec_window,
                     e_rate=cfg.max_ov_diff_ec).process(read_ovs)
    trace.reset()
    dev = TD.DeviceEC(store, wl=cfg.ec_window, e_rate=cfg.max_ov_diff_ec,
                      mesh=Mesh(["cpu"] * nd), chunk=1000)
    assert len({id(b) for b in dev.banks}) == 1     # one copy per device
    _assert_same(ref, dev.process(read_ovs))
    assert sorted(TD.SHARD_STATS) == list(range(nd))


def test_dryrun_multichip_tiny():
    out = dryrun_multichip(CPU8, synth, bases=150_000)
    assert out["gfa_bytes"] > 0 and out["align_windows"] == 8 * S


def test_profile_writes_one_trace_per_round(tmp_path):
    """--profile DIR through the CLI: one Chrome trace per EC round, and
    every output byte-identical with and without the option."""
    from hifiasm_tpu_torch.cli import main

    rng = np.random.default_rng(11)
    reads, _, _ = sample_reads(rng, make_genome(rng, 6000), depth=10,
                               read_len=1500, err_rate=0.004)
    fa = tmp_path / "reads.fa"
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{''.join('ACGT'[c] for c in r)}\n")
    prof = tmp_path / "prof"
    for tag, extra in (("plain", []), ("prof", ["--profile", str(prof)])):
        assert main(["-o", str(tmp_path / tag), "-r", "2", "-i",
                     "--device", "cpu", *extra, str(fa)]) == 0
    assert sorted(os.listdir(prof)) == ["ec_r0.json", "ec_r1.json"]
    for p in os.listdir(prof):
        assert os.path.getsize(prof / p) > 0
    files = {t: sorted(f[len(t):] for f in os.listdir(tmp_path)
                       if f.startswith(t + ".")) for t in ("plain", "prof")}
    assert files["plain"] == files["prof"]
    assert set(f".{s}" for s in SUFFIXES) <= set(files["plain"])
    for suf in files["plain"]:
        a, b = tmp_path / f"plain{suf}", tmp_path / f"prof{suf}"
        assert a.read_bytes() == b.read_bytes(), suf


def test_trace_idle_reads_a_trace(tmp_path):
    """scripts/trace_idle.py on a small hand-made trace: busy time is the
    union of device intervals, kernels count toward the innermost ec.*
    range open at their launch (here ec.L2 inside ec.round)."""
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location(
        "trace_idle", os.path.join(os.path.dirname(__file__), "..",
                                   "scripts", "trace_idle.py"))
    ti = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ti)

    def ev(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7,
                "ts": ts, "dur": dur, "args": args}

    trace = {"traceEvents": [
        ev("user_annotation", "ec.round", 0, 200),
        ev("user_annotation", "ec.L2", 0, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 2, correlation=2),
        ev("kernel", "k_a", 30, 40, correlation=1),
        ev("kernel", "k_b", 50, 30, correlation=2),
        ev("gpu_memcpy", "copy", 150, 10),
        ev("cpu_op", "aten::x", 190, 10)]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(trace))
    rep = ti.analyse(str(p))
    assert rep["window_us"] == 200
    assert rep["device_busy_us"] == 60           # [30, 80) and [150, 160)
    assert rep["idle_share"] == pytest.approx(0.7)
    assert rep["gaps"][0] == {"at_us": 80, "us": 70}
    st = rep["stages"]["ec.L2"]
    assert (st["kernels"], st["device_us"], st["wall_us"]) == (2, 70, 100)
    assert rep["stages"]["ec.round"]["kernels"] == 0
    assert rep["vote"]["device_busy_us"] == 50    # [30, 80) in [0, 100)
    assert rep["vote"]["busy_share"] == pytest.approx(0.5)


def test_plan_windows_many_with_tws_matches_per_read():
    """DeviceEC plans host-chained reads (the mesh path) in one pass:
    every field, t_ws included, equals plan_read_windows read by read."""
    from hifiasm_tpu_torch.ec.window_align import (
        plan_read_windows, plan_windows_many,
    )
    from tests.test_torch_device_ec import _ec_inputs

    _, _, read_ovs, cfg = _ec_inputs()
    many = plan_windows_many(read_ovs, cfg.ec_window, cfg.max_ov_diff_ec,
                             with_tws=True)
    n = 0
    for rid, ov in read_ovs:
        one = plan_read_windows(ov, cfg.ec_window, cfg.max_ov_diff_ec)
        assert sorted(one) == sorted(many[rid])
        for k, v in one.items():
            np.testing.assert_array_equal(many[rid][k], v, k)
        n += len(one["ws"])
    assert n > 1000
