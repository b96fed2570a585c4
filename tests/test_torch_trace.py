"""The port's span helper (hifiasm_tpu_torch/utils/trace.py) and the
counters it feeds, on tiny assemblies on the CPU: every span's summed
range in a torch.profiler trace equals the seconds key it feeds, no
range is opened without a profiler, the EC round and consensus-read
counters, the vote scatter-add counters against a direct count of the
masks, ``trace.reset`` and ``--profile``'s per-round trace."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hifiasm_tpu_torch.ec.device_ec as D
import hifiasm_tpu_torch.ec.pipeline as P
import hifiasm_tpu_torch.index.pos_table_dev as A
import hifiasm_tpu_torch.overlap.chain_device as C
import hifiasm_tpu_torch.parallel.index_shard  # noqa: F401  (registers)
import hifiasm_tpu_torch.phasing.hic  # noqa: F401  (registers)
import hifiasm_tpu_torch.ul  # noqa: F401  (registers)
from hifiasm_tpu_torch.assemble import assemble
from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.utils import trace
from tests.synth import make_genome, sample_reads

# each span name and the seconds keys it feeds: (dict, key) pairs, the
# dicts named as in the ``traced`` fixture
FEEDS = {
    "ft.filter_table": [("stage", "filter_table")],
    "ec.run": [("stage", "ec")],
    "graph.string_graph": [("stage", "string_graph")],
    "graph.chimeric": [("stage", "chimeric")],
    "graph.clean_unitig": [("stage", "clean_unitig")],
    "graph.purge": [("stage", "purge")],
    "graph.write": [("stage", "write")],
    "phase.unitigs": [("stage", "phase")],
    "ec.index": [("P", "index_s")],
    "ec.frontend": [("P", "chain_s")],
    "ec.anchors": [("P", "anchors_s"), ("A", "anchors_s")],
    "ec.upload": [("A", "upload_s")],
    "ec.quick": [("C", "quick_s")],
    "ec.host_dp": [("C", "host_dp_s")],
    "ec.plan_many": [("P", "plan_many_s")],
    "ec.tws": [("P", "tws_s")],
    "ec.device_ec": [("P", "device_ec_s")],
    "ec.bank": [("D", "bank_s")],
    "ec.plan": [("D", "plan_s")],
    "ec.L1": [("D", "align_s")],
    "ec.L1_retry": [],               # with ec.L1 in align_s
    "ec.prep": [("D", "host_s")],
    "ec.package": [],                # with ec.prep in host_s
    "ec.vote": [("D", "vote_s")],
    "ec.dag_gather": [("D", "dag_gather_s")],
    "ec.consensus": [("P", "consensus_s")],
}
PAIRS = {"ec.L1": ["ec.L1", "ec.L1_retry"],
         "ec.prep": ["ec.prep", "ec.package"]}


def _reads():
    rng = np.random.default_rng(11)
    reads, _, _ = sample_reads(rng, make_genome(rng, 6000), depth=10,
                               read_len=1500, err_rate=0.01)
    return [f"r{i}" for i in range(len(reads))], reads


def _assemble(pfx, rounds, **kw):
    names, reads = _reads()
    cfg = HifiasmConfig(output_prefix=pfx, ignore_bin=True,
                        n_rounds_ec=rounds, **kw)
    return assemble(ReadStore.from_arrays(names, reads), cfg, device="cpu")


def _count_cns_reads(mp):
    """Wraps ``DeviceEC.process`` to count the reads with device
    consensus input, round by round, into the returned list."""
    n = [0]
    orig = D.DeviceEC.process

    def process(dec, *a, **kw):
        outs, cns_in = orig(dec, *a, **kw)
        n[0] += len(cns_in)
        return outs, cns_in

    mp.setattr(D.DeviceEC, "process", process)
    return n


def _span_seconds(prof):
    """Summed seconds of each host range in a finished profile."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            out[ev.name()] = out.get(ev.name(), 0.0) + \
                ev.duration_ns() * 1e-9
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One EC round under torch.profiler on the CPU."""
    d = tmp_path_factory.mktemp("trace1")
    trace.reset()
    with pytest.MonkeyPatch.context() as mp:
        cns = _count_cns_reads(mp)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res = _assemble(str(d / "asm"), 1)
    stats = {"stage": dict(res.stage_s), "P": dict(P.STATS),
             "D": dict(D.STATS), "A": dict(A.STATS), "C": dict(C.STATS)}
    return stats, _span_seconds(prof), cns[0]


@pytest.fixture(scope="module")
def untraced(tmp_path_factory):
    """Three EC rounds with no profiler, counting record_function
    calls."""
    d = tmp_path_factory.mktemp("trace3")
    trace.reset()
    calls = []

    def counted(name):
        calls.append(name)
        return torch.autograd.profiler.record_function(name)

    with pytest.MonkeyPatch.context() as mp:
        cns = _count_cns_reads(mp)
        mp.setattr(trace, "record_function", counted)
        res = _assemble(str(d / "asm"), 3)
    return dict(P.STATS), dict(D.STATS), res.stage_s, calls, cns[0]


@pytest.mark.parametrize("name", sorted(FEEDS))
def test_span_equals_its_key(traced, name):
    """The shared clock: a span's summed range is the seconds it fed,
    within 1 ms + 1%."""
    stats, spans, _ = traced
    if not FEEDS[name]:
        assert any(name in v for v in PAIRS.values())
        return
    got = sum(spans.get(n, 0.0) for n in PAIRS.get(name, [name]))
    want = sum(stats[src][key] for src, key in FEEDS[name])
    assert want > 0 or name in ("ec.host_dp", "phase.unitigs"), name
    assert abs(got - want) <= 1e-3 + 0.01 * want, (name, got, want)


def test_spans_nest_in_the_round(traced):
    """Every EC stage's range lies inside ``ec.round``."""
    stats, spans, _ = traced
    assert spans["ec.round"] >= spans["ec.index"] + spans["ec.frontend"] + \
        spans["ec.device_ec"] + spans["ec.consensus"]
    assert spans["ec.vote"] >= sum(spans.get(n, 0.0) for n in (
        "ec.L2", "ec.het", "ec.L3", "ec.L4", "ec.L5"))
    # host_s is measured, not a remainder
    assert stats["D"]["host_s"] > 0


def test_off_path_opens_no_range(untraced, monkeypatch):
    """With no profiler a whole assembly times every stage and enters
    no record_function; under one, a span enters it once."""
    p_stats, d_stats, stage_s, calls, _ = untraced
    assert calls == []
    assert p_stats["consensus_s"] > 0 and d_stats["vote_s"] > 0
    assert stage_s["filter_table"] > 0
    probe = []

    def counted(name):
        probe.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(trace, "record_function", counted)
    with trace.span("ec.probe"):
        pass
    assert probe == []
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("ec.probe"):
            pass
    assert probe == ["ec.probe"]


def test_rounds_counted(traced, untraced):
    assert traced[0]["P"]["ec_rounds"] == 1
    assert untraced[0]["ec_rounds"] == 3


@pytest.mark.parametrize("run", ["traced", "untraced"])
def test_consensus_reads(request, run):
    """consensus_reads counts the reads with device consensus input, the
    base of host_dag_reads; host_dag_s times those re-runs."""
    got = request.getfixturevalue(run)
    p_stats = got[0]["P"] if run == "traced" else got[0]
    n = got[2] if run == "traced" else got[4]
    assert p_stats["consensus_reads"] == n > 0
    assert 0 <= p_stats["host_dag_reads"] <= n
    assert (p_stats["host_dag_s"] > 0) == (p_stats["host_dag_reads"] > 0)
    assert p_stats["host_dag_s"] <= p_stats["consensus_s"]


@pytest.mark.parametrize("chunk", [None, 256])
def test_vote_counters_count_the_masks(monkeypatch, chunk):
    """vote_adds and vote_dropped_adds on one CPU batch equal a direct
    count of the keep masks given to the plain vote scatter-adds
    (vote_scatter.masked_add_torch, through which every CPU vote passes);
    with a small CHUNK_CPU the votes come in many aggregation steps, and
    the counts and the decisions do not change."""
    from hifiasm_tpu_torch.ops import vote_scatter as V
    from tests.test_torch_device_ec import _ec_inputs

    store, _, read_ovs, cfg = _ec_inputs()

    def run():
        seen = {"adds": 0, "dropped": 0}
        orig = V.masked_add_torch

        def counted(acc, idx, keep, dropped=None):
            seen["adds"] += idx.numel()
            seen["dropped"] += int((~keep).sum())
            orig(acc, idx, keep, dropped)

        with monkeypatch.context() as m:
            m.setattr(V, "masked_add_torch", counted)
            trace.reset()
            _, cns_in = D.DeviceEC(store, wl=cfg.ec_window,
                                   e_rate=cfg.max_ov_diff_ec,
                                   device="cpu").process(read_ovs)
        assert D.STATS["vote_adds"] == seen["adds"] > 0
        assert D.STATS["vote_dropped_adds"] == seen["dropped"] > 0
        assert seen["dropped"] < seen["adds"]
        return cns_in, seen

    cns_in, seen = run()
    if chunk:
        monkeypatch.setattr(D, "CHUNK_CPU", chunk)
        got, seen_c = run()
        assert D.STATS["windows"] > 4 * chunk
        assert seen_c == seen
        assert sorted(got) == sorted(cns_in)
        for rid, planes in cns_in.items():
            for a, b in zip(planes, got[rid]):
                np.testing.assert_array_equal(a, b)


def test_reset_zeroes_every_registered_dict():
    regs = trace._REGISTRY
    assert {"pipeline", "device_ec", "device_ec.shards", "chain_device",
            "pos_table_dev", "index_shard", "hic", "ul"} <= set(regs)
    for name, st in regs.items():
        if name == "device_ec.shards":
            st[0] = {"windows": 3, "k1_launches": 1}
            continue
        for k, v in st.items():
            st[k] = type(v)(7)
    trace.reset()
    for name, st in regs.items():
        if name == "device_ec.shards":
            assert st == {}
            continue
        for k, v in st.items():
            assert v == 0, (name, k)
            assert type(v) is (float if k.endswith("_s") else int), (name, k)


def test_span_adds_to_a_missing_key():
    d = {}
    with trace.span(None, d, "x") as sp:
        pass
    with trace.span(None, d, "x"):
        pass
    assert d["x"] >= sp.s >= 0


def test_profile_trace_holds_the_round(tmp_path):
    """--profile (cfg.profile_dir) writes one Chrome trace of the whole
    round: it holds the index build and consensus, not only DeviceEC."""
    from hifiasm_tpu_torch.ec.pipeline import ec_round

    names, reads = _reads()
    prof = tmp_path / "prof"
    cfg = HifiasmConfig(output_prefix=str(tmp_path / "asm"),
                        ignore_bin=True, profile_dir=str(prof))
    ec_round(ReadStore.from_arrays(names, reads), cfg, None, 0,
             device="cpu")
    assert os.listdir(prof) == ["ec_r0.json"]
    with open(prof / "ec_r0.json") as f:
        got = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ec.round", "ec.index", "ec.frontend", "ec.device_ec",
            "ec.L1", "ec.vote", "ec.consensus"} <= got
