"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the program.  Module names are compared by
their top-level name (the part before the first dot), whole."""

import json
import os
import subprocess
import sys

from benchmark import run as run_py

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_NAMES = {"jax", "jaxlib", "flax", "hifiasm_tpu"}


def _top_level_names(code: str) -> set:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


PRINT = "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def test_no_jax_after_a_cpu_cell(tiny_root):
    names = _top_level_names(f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from benchmark import calibrate, devtrace, faults, harness, roofline, run
from benchmark.reference import check, edits, kmers
spec = harness.Spec({tiny_root!r})
for m in spec.doc["per_layer"]:
    spec.reader(m["name"])
out = harness.run("tiny.haploid", 5, 0.1, True, "cpu", spec=spec)
assert out["correct"], out
assert run.forbidden_modules() == []
{PRINT}
""")
    assert "hifiasm_tpu_torch" in names and "torch" in names
    assert not names & JAX_NAMES


def test_reference_loads_nothing_of_the_program():
    names = _top_level_names(f"""
import json, sys
sys.path.insert(0, {ROOT!r})
import benchmark.reference.check, benchmark.reference.edits
import benchmark.reference.kmers
{PRINT}
""")
    assert not names & (JAX_NAMES | {"hifiasm_tpu_torch", "torch"})


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "hifiasm_tpu_torch_like", sys)
    found = set(run_py.forbidden_modules())
    assert "jaxtyping_like" not in found and "hifiasm_tpu_torch_like" \
        not in found
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run_py.forbidden_modules()
