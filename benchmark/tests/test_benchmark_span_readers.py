"""The arithmetic of the per-layer readers of EC's span timers and
counters (host DAG re-runs, dropped vote scatter-adds, DeviceEC host work)
on a hand-made window, and their silence where a program keeps none of
those timers and counters."""

import pytest

from benchmark import harness

NEW_READERS = ("ec.host_dag_s", "ec.host_dag_read_pct", "ec.vote_dropped_pct",
               "ec.dec_host_s")


def _window():
    a = {"bases": 100, "wall_s": 2.0,
         "stage_s": {"filter_table": 0.5},
         "ec": {"index_s": 1.0, "chain_s": 2.0, "consensus_s": 3.0,
                "host_dag_s": 1.25, "consensus_reads": 300,
                "host_dag_reads": 15},
         "chain": {"host_dp_s": 0.5},
         "device_ec": {"align_s": 1.5, "vote_s": 4.0, "windows": 65536,
                       "retry_windows": 0, "bank_s": 0.25, "plan_s": 0.5,
                       "host_s": 1.0, "vote_adds": 1000,
                       "vote_dropped_adds": 600}}
    b = {**a,
         "ec": {**a["ec"], "host_dag_s": 0.75, "consensus_reads": 100,
                "host_dag_reads": 25},
         "device_ec": {**a["device_ec"], "host_s": 2.0,
                       "vote_adds": 3000, "vote_dropped_adds": 600}}
    return harness.Window([a, b])


@pytest.mark.parametrize("name,value", [
    ("ec.host_dag_s", 1.0),
    # (15 + 25) of (300 + 100) reads; (600 + 600) of (1000 + 3000) adds
    ("ec.host_dag_read_pct", 10.0), ("ec.vote_dropped_pct", 30.0),
    # (0.25 + 0.5 + 1) and (0.25 + 0.5 + 2)
    ("ec.dec_host_s", 2.25),
])
def test_readers(name, value):
    assert harness.Spec().reader(name).read(_window()) == \
        pytest.approx(value)


@pytest.mark.parametrize("name", NEW_READERS)
def test_readers_without_their_counters(name):
    """A program that keeps none of these timers and counters gives no
    reading, and no error."""
    w = _window()
    for a in w.assemblies:
        for k in ("host_dag_s", "consensus_reads", "host_dag_reads"):
            a["ec"].pop(k, None)
        a["device_ec"] = {k: v for k, v in a["device_ec"].items()
                          if k not in ("vote_adds", "vote_dropped_adds",
                                       "host_s")}
    assert harness.Spec().reader(name).read(w) is None
    assert harness.Spec().reader(name).read(harness.Window()) is None


def test_shares_without_a_base():
    w = _window()
    for a in w.assemblies:
        a["ec"]["consensus_reads"] = a["ec"]["host_dag_reads"] = 0
        a["device_ec"]["vote_adds"] = a["device_ec"]["vote_dropped_adds"] = 0
    spec = harness.Spec()
    assert spec.reader("ec.host_dag_read_pct").read(w) is None
    assert spec.reader("ec.vote_dropped_pct").read(w) is None
