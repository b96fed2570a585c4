"""The arithmetic of the metrics on hand-made inputs: the idle share and
gaps of a trace, K1's work and roofline share, and the per-assembly
readers."""

import pytest

from benchmark import harness, roofline
from benchmark.devtrace import ASSEMBLY_SPAN, Trace, merge


def _trace():
    # two assemblies, [0, 10) and [12, 20); kernels overlap in the first
    device = [("k_a", 1.0, 3.0), ("k_b", 2.0, 4.0), ("banded_tb_kernel<31>",
                                                      6.0, 7.0),
              ("k_a", 11.0, 11.5),               # between the assemblies
              ("k_a", 13.0, 14.0)]
    spans = [(ASSEMBLY_SPAN, 0.0, 10.0), (ASSEMBLY_SPAN, 12.0, 20.0),
             ("ec.L2", 4.0, 9.0), ("ec.L3", 4.5, 5.5)]
    return Trace(device, spans)


def test_merge():
    assert merge([(3, 4), (1, 2), (1.5, 3.5)]) == [[1, 4]]


def test_busy_and_idle():
    t = _trace()
    assert t.window_s() == pytest.approx(18.0)
    # busy: [1, 4) + [6, 7) + [13, 14) = 5 s; the kernel between the
    # assemblies lies outside the window
    assert t.busy_s() == pytest.approx(5.0)
    assert t.idle_pct() == pytest.approx(100 * (1 - 5 / 18))
    assert t.kernel_s("banded_tb_kernel") == pytest.approx(1.0)
    assert t.top_ops(2) == [["k_a", pytest.approx(3.5)],
                            ["k_b", pytest.approx(2.0)]]


def test_idle_gaps_labelled():
    gaps = _trace().idle_gaps(3)
    # the longest: [14, 20) in assembly 1, outside any ec.* span
    assert gaps[0][1] == pytest.approx(6.0)
    assert gaps[0][0].startswith("outside DeviceEC (assembly 1, at 2.00")
    # [7, 10): ec.L2 is open at its midpoint
    assert gaps[1] == ["ec.L2 (assembly 0, at 7.00 s)", pytest.approx(3.0)]
    # [4, 6): at 5.0 the inner ec.L3 is open too
    assert gaps[2][0].startswith("ec.L3 (assembly 0, at 4.00")


def test_no_device_no_idle_share():
    t = Trace([], [(ASSEMBLY_SPAN, 0.0, 1.0)])
    assert t.idle_pct() is None


def test_innermost_span_names_gap():
    t = Trace([("k", 0.0, 1.0)], [(ASSEMBLY_SPAN, 0.0, 3.0),
                                  ("ec.L2", 0.5, 3.0), ("ec.L4", 0.9, 2.5)])
    assert t.idle_gaps(1)[0][0].startswith("ec.L4 ")      # gap [1, 3)
    t = Trace([("k", 0.0, 1.0)], [(ASSEMBLY_SPAN, 0.0, 5.0),
                                  ("ec.L5", 0.5, 1.5)])
    assert t.idle_gaps(1)[0][0].startswith("outside DeviceEC ")


def test_k1_work_and_bound():
    w = roofline.k1_work(65536)
    assert w["ops"] == 65536 * 775 * 30
    assert w["bytes"] == 65536 * (775 + 837 + 8 + 12 + 3 * 775)
    least, by = roofline.bound_s(w)
    t_ops = w["ops"] / (132 * 64 * 1.98e9)
    t_mem = w["bytes"] / 3.35e12
    assert least == pytest.approx(max(t_ops, t_mem))
    assert by == ("int32 operations" if t_ops > t_mem else "HBM bytes")


def test_window_rate():
    # three assemblies back to back from t = 10 s to t = 40 s, with 1 s
    # of the harness's own between two of them: it counts
    recs = [{"bases": 300, "t0": 10.0, "t1": 20.0, "peak_bytes": 2 ** 30},
            {"bases": 300, "t0": 21.0, "t1": 30.0, "peak_bytes": 3 * 2 ** 29},
            {"bases": 300, "t0": 30.0, "t1": 40.0, "peak_bytes": 2 ** 29}]
    got = harness.end_to_end(recs, 12.5)
    assert got == {"bases_per_s": pytest.approx(900 / 30),
                   "peak_device_gib": pytest.approx(1.5), "setup_s": 12.5}
    assert harness.end_to_end([], 1.0)["bases_per_s"] == 0.0


def _window(trace=None):
    a = {"bases": 100, "wall_s": 2.0,
         "stage_s": {"filter_table": 0.5, "string_graph": 1.0,
                     "clean_unitig": 0.5, "purge": 0.25, "write": 2.0,
                     "hic_map": 0.75, "phase": 0.5, "scaffold": 0.25},
         "ec": {"index_s": 1.0, "chain_s": 2.0, "consensus_s": 3.0},
         "chain": {"host_dp_s": 0.5},
         "device_ec": {"align_s": 1.5, "vote_s": 4.0, "windows": 65536,
                       "retry_windows": 0}}
    b = {**a, "stage_s": {k: 2 * v for k, v in a["stage_s"].items()},
         "device_ec": {**a["device_ec"], "vote_s": 6.0}}
    return harness.Window([a, b], trace)


@pytest.mark.parametrize("name,value", [
    ("ft.filter_table_s", 0.75), ("ec.index_s", 1.0),
    ("ec.frontend_s", 2.0), ("ec.host_dp_s", 0.5), ("ec.align_s", 1.5),
    ("ec.vote_s", 5.0), ("ec.consensus_s", 3.0),
    # (1 + 0.5 + 0.25 + 2 - 0.75 - 0.5 - 0.25) = 2.25, and twice that
    ("graph_s", 3.375),
])
def test_readers(name, value):
    assert harness.Spec().reader(name).read(_window()) == \
        pytest.approx(value)


def test_readers_without_their_source():
    spec = harness.Spec()
    w = _window()
    assert spec.reader("k1_roofline").read(w) is None
    assert spec.reader("device.idle_pct").read(w) is None
    assert spec.reader("ec.vote_s").read(harness.Window()) is None


def test_k1_roofline_reader():
    w = _window(_trace())                 # 1 s of K1 for 131,072 windows
    least, _ = roofline.bound_s(roofline.k1_work(2 * 65536))
    got = harness.Spec().reader("k1_roofline").read(w)
    assert got == pytest.approx(100 * least)
    assert harness.Spec().reader("device.idle_pct").read(w) == \
        pytest.approx(100 * (1 - 5 / 18))
