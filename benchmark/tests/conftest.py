"""Fixtures of the benchmark's own tests.

    python -m pytest benchmark/tests -q

``tiny_spec`` is a copy of the benchmark with two cells small enough for
the CPU: ``tiny.haploid`` (a 10 kb genome) and ``tiny.hic`` (2 x 10 kb
with Hi-C pairs).  Their limits are set for these sizes on the CPU, not
for the cells of ``BENCHMARK.json``.  Tests marked ``cuda`` run only
where a card is present; the fixture ``card`` decides that.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_TRAFFIC = {"mean_len": 2500, "depth": 20, "inputs": 2,
                "warmup_scale": 0.5}
# set from CPU readings of tiny.haploid (6 seeds): sound runs up to
# 108.7 ppm of edits in the corrected reads, 8,874 ppm and 1.96%; the
# faults from 1,511 ppm (ec_half), 62,601 ppm (ctg_altered) and about
# 50% (ctg_half); one and two EC rounds read as three here (4.9-19.8 ppm)
TINY_LIMITS = {"ec_edit_ppm": 500.0, "ctg_err_ppm": 25000.0,
               "ctg_missed_pct": 10.0}


def make_tiny(dest: str) -> str:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dest``
    with the two tiny cells added as data files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(dest, "benchmark")

    def put(rel, obj):
        with open(os.path.join(b, rel), "w") as f:
            json.dump(obj, f)

    doc = json.load(open(os.path.join(dest, "BENCHMARK.json")))
    for conf, traffic, base_conf, base_traffic, cell in (
            ("tiny_haploid", "tiny_unique", "hifi_haploid", "unique30x",
             "tiny.haploid"),
            ("tiny_diploid", "tiny_hic", "hifi_hic_diploid", "diploid15x",
             "tiny.hic")):
        c = json.load(open(os.path.join(b, "configs", f"{base_conf}.json")))
        c.update(name=conf, genome_size=10000, threads=2)
        put(f"configs/{conf}.json", c)
        t = json.load(open(os.path.join(b, "workloads",
                                        f"{base_traffic}.json")))
        t.update(TINY_TRAFFIC)
        if t["genome"] == "unique":
            t["repeat_frac"] = 0.0
        else:
            t.update(genome="unique", repeat_frac=0.0, hic_pairs=1500)
        put(f"workloads/{traffic}.json", t)
        lim = dict(TINY_LIMITS)
        if c["phased"]:
            lim["phase_err_pct"] = 10.0
        put(f"limits/{cell}.json", lim)
        doc["configs"].append({"name": conf, "source": "tiny test copy",
                               "file": f"benchmark/configs/{conf}.json",
                               "reduced": ["genome_size"],
                               "why": "CPU test"})
        doc["workloads"].append({"name": cell, "config": conf,
                                 "traffic": traffic, "chips": 1,
                                 "why": "CPU test"})
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
