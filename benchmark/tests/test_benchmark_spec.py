"""BENCHMARK.json and the files it names: every configuration, traffic
mix, limit file and metric reader parses and is found by its name, and a
file added as data is found without an edit to the code."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

SPEC = harness.Spec()
CELLS = [w["name"] for w in SPEC.doc["workloads"]]


def test_keys_and_names():
    d = SPEC.doc
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["paths"] == ["benchmark"]
    assert 1 <= d["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in d[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in d[k]}) == len(d[k])
    metrics = d["end_to_end"] + d["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    assert {m["name"] for m in d["end_to_end"]} == \
        {"bases_per_s", "peak_device_gib", "setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in d["end_to_end"])
    assert all(m["moves"] == "bases_per_s" for m in d["per_layer"])
    pairs = {(w["config"], w["traffic"]) for w in d["workloads"]}
    assert len(pairs) == len(d["workloads"])
    assert all(w["chips"] == 1 and len(w["why"]) <= 200
               for w in d["workloads"])
    assert len(json.dumps(d)) < 64 * 1024


KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and \
        "\n" not in s and "\t" not in s


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entry_keys(kind):
    need, may = KEYS[kind]
    for x in SPEC.doc[kind]:
        assert need <= set(x) <= need | may, (kind, x["name"])
        for k in ("why", "layer", "source"):
            if k in x:
                assert _line(x[k]), (kind, x["name"], k)
        if kind == "configs":
            assert len(x["reduced"]) <= 16
            assert all(NAME.match(k) for k in x["reduced"])
        if kind == "per_layer" and "roofline" in x["name"]:
            assert x["name"].endswith("_roofline") and x["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = SPEC.cell(cell)
    assert c.limits, "every cell has its limits"
    assert c.config["name"] == c.entry["config"]
    assert set(c.config["reduced"]) == set(next(
        x for x in SPEC.doc["configs"]
        if x["name"] == c.entry["config"])["reduced"])
    gen = SPEC.generator(c.traffic["generator"])
    assert callable(gen.make)
    if c.config["phased"]:
        assert "phase_err_pct" in c.limits
    for m in SPEC.metrics(cell, "per_layer"):
        assert callable(SPEC.reader(m["name"]).read)


def test_every_cell_has_its_limits():
    assert {f[:-5] for f in os.listdir(os.path.join(SPEC.bench, "limits"))} \
        == set(CELLS)


def test_added_traffic_file_is_listed(tiny_root, tmp_path):
    spec = harness.Spec(tiny_root)
    before = spec.traffic_names()
    path = os.path.join(spec.bench, "workloads", "added_mix.json")
    with open(path, "w") as f:
        json.dump({"generator": "hifi", "genome": "unique"}, f)
    try:
        assert spec.traffic_names() == sorted(before + ["added_mix"])
    finally:
        os.remove(path)
    assert "tiny_unique" in before and "tiny_hic" in before
    assert spec.cell("tiny.haploid").traffic["mean_len"] == 2500
