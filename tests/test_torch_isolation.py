"""The port stands alone: hifiasm_tpu_torch imports neither jax nor any
module of hifiasm_tpu, at import time or while it runs."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hifiasm_tpu_torch")

_RUN = r"""
import importlib.util, os, sys
import numpy as np
root = sys.argv[1]
sys.path.insert(0, root)
import hifiasm_tpu_torch
from hifiasm_tpu_torch.assemble import assemble
from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.io.readstore import ReadStore
spec = importlib.util.spec_from_file_location(
    "synth", os.path.join(root, "tests", "synth.py"))
synth = importlib.util.module_from_spec(spec)
spec.loader.exec_module(synth)
rng = np.random.default_rng(11)
g = synth.make_genome(rng, 6000)
reads, _, _ = synth.sample_reads(rng, g, depth=8, read_len=1500,
                                 err_rate=0.004)
store = ReadStore.from_arrays([f"r{i}" for i in range(len(reads))], reads)
res = assemble(store, HifiasmConfig(output_prefix=sys.argv[2], n_rounds_ec=1,
                                    ignore_bin=True), device="cpu")
assert res.ug is not None
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "hifiasm_tpu" or k.startswith("hifiasm_tpu."))
print("BAD" if bad else "CLEAN", bad)
"""


def test_cpu_run_imports_no_jax(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-c", _RUN, ROOT, str(tmp_path / "iso")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("CLEAN []"), r.stdout[-2000:]
    assert os.path.getsize(tmp_path / "iso.bp.p_ctg.gfa") > 0


def test_sources_import_no_jax():
    pat = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+hifiasm_tpu\b(?!_)|"
        r"from\s+hifiasm_tpu\b(?!_))", re.M)
    seen = 0
    for d, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(d, fn)) as f:
                    hits = pat.findall(f.read())
                assert not hits, (fn, hits)
                seen += 1
    assert seen > 30
