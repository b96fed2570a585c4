"""One run of one cell: set-up, a window of whole assemblies run back to
back, the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file that the harness finds by its name in
``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the deployment (genome size and
  ploidy, the assembler's options, the outputs that hold its contigs);
- ``benchmark/workloads/<traffic>.json``: the traffic's parameters and
  the generator under ``benchmark/inputs/`` that reads them;
- ``benchmark/limits/<cell>.json``: the limit of each number compared;
- ``benchmark/metrics/<metric>.py``: a reader with ``read(window)``.

The window drives ``hifiasm_tpu_torch.assemble.assemble(store, cfg,
device=...)`` back to back, each call on an input of its own that set-up
made from the seed, with its read store built; a window that outlasts
the traffic's ``inputs`` fails.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from benchmark import faults
from benchmark.reference import check

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict            # the cell's entry in BENCHMARK.json
    config: dict
    traffic: dict
    limits: Optional[dict]


class Spec:
    """``BENCHMARK.json`` at ``root`` and the files it names under
    ``root/benchmark``."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench = os.path.join(root, "benchmark")
        self.doc = _json(os.path.join(root, "BENCHMARK.json"))

    def traffic_names(self) -> List[str]:
        d = os.path.join(self.bench, "workloads")
        return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".json"))

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.doc["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        conf = next(c for c in self.doc["configs"]
                    if c["name"] == entry["config"])
        lim = os.path.join(self.bench, "limits", f"{name}.json")
        return Cell(name, entry, _json(os.path.join(self.root, conf["file"])),
                    _json(os.path.join(self.bench, "workloads",
                                       f"{entry['traffic']}.json")),
                    _json(lim) if os.path.exists(lim) else None)

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
        reports."""
        return [m for m in self.doc[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        return _module(os.path.join(self.bench, "metrics", f"{metric}.py"),
                       f"benchmark_metric_{metric.replace('.', '_')}")

    def generator(self, name: str):
        return _module(os.path.join(self.bench, "inputs", f"{name}.py"),
                       f"benchmark_inputs_{name}")


@dataclass
class Window:
    """What the per-layer readers read: one record a timed assembly
    (counters, stage walls) and the trace of the window, if taken."""
    assemblies: List[dict] = field(default_factory=list)
    trace: object = None

    def per_assembly(self, fn) -> Optional[float]:
        """``fn`` summed over the assemblies, over their number."""
        if not self.assemblies:
            return None
        return sum(fn(a) for a in self.assemblies) / len(self.assemblies)


def _stats_modules():
    import hifiasm_tpu_torch.ec.device_ec as D
    import hifiasm_tpu_torch.ec.pipeline as P
    import hifiasm_tpu_torch.index.pos_table_dev as A
    import hifiasm_tpu_torch.overlap.chain_device as C
    import hifiasm_tpu_torch.phasing.hic as H

    return {"ec": P.STATS, "device_ec": D.STATS, "chain": C.STATS,
            "anchors": A.STATS, "hic": H.STATS}, D.SHARD_STATS


def _zero_stats() -> None:
    stats, shard = _stats_modules()
    for st in stats.values():
        for k in st:
            st[k] = type(st[k])(0)
    shard.clear()


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Runner:
    """Builds the assembler's configuration for a cell and runs one
    assembly of an input, with a variant of ``faults`` if asked."""

    def __init__(self, cell: Cell, device: str, variant: Optional[str]):
        self.cell, self.device = cell, device
        self.variant = faults.VARIANTS[variant] if variant else \
            faults.Variant()

    def outputs(self, prefix: str) -> List[str]:
        return [f"{prefix}.{o}" for o in self.cell.config["outputs"]]

    @staticmethod
    def store(inp):
        """The program's read store of ``inp``."""
        from hifiasm_tpu_torch.io.readstore import ReadStore

        return ReadStore.from_arrays(
            [f"r{i}" for i in range(len(inp.reads))], inp.reads)

    def assemble(self, inp, outdir: str, store=None) -> tuple:
        """One timed assembly of ``inp`` (from ``store``, if built);
        returns its record, the store EC left behind and the output
        prefix."""
        import torch

        from hifiasm_tpu_torch.assemble import assemble
        from hifiasm_tpu_torch.config import HifiasmConfig

        os.makedirs(outdir, exist_ok=True)
        if store is None:
            store = self.store(inp)
        conf = self.cell.config
        kw = dict(conf["options"])
        kw.update(self.variant.cfg)
        if inp.hic:
            kw.update(hic_reads_1=[inp.hic[0]], hic_reads_2=[inp.hic[1]])
        prefix = os.path.join(outdir, "asm")
        cfg = HifiasmConfig(output_prefix=prefix, ignore_bin=True,
                            mesh_devices=1, threads=self.threads(), **kw)
        cuda = self.device == "cuda"
        bases = int(store.total_bases)      # before EC changes them
        _zero_stats()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        patch = self.variant.patch() if self.variant.patch else \
            contextlib.nullcontext()
        t0 = time.perf_counter()
        with patch:
            res = assemble(store, cfg, device=self.device)
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats, _ = _stats_modules()
        rec = {"bases": bases, "wall_s": t1 - t0,
               "t0": t0, "t1": t1,
               "peak_bytes": int(torch.cuda.max_memory_allocated())
               if cuda else 0,
               "stage_s": dict(res.stage_s),
               **{k: dict(v) for k, v in stats.items()}}
        if self.variant.post:
            for path in self.outputs(prefix):
                self.variant.post(path)
        return rec, res.store, prefix

    def threads(self) -> int:
        return max(1, min(int(self.cell.config["threads"]),
                          os.cpu_count() or 1))


class InputMaker:
    """The inputs of a run, made from its seed: window input ``k`` (0 to
    ``n - 1``) from child ``k`` of the seed's ``SeedSequence``, the
    warm-up input from child ``n``, their files under a fresh directory
    in ``TMPDIR``.  ``dataset_seed``, if given, replaces the traffic's
    own (``calibrate.py``)."""

    def __init__(self, spec: Spec, cell: Cell, seed: int,
                 dataset_seed: Optional[int] = None):
        self.cell = cell
        self.gen = spec.generator(cell.traffic["generator"])
        self.n = int(cell.traffic["inputs"])
        self.seeds = np.random.SeedSequence(seed).spawn(self.n + 1)
        self.dataset_seed = dataset_seed
        self.workdir = tempfile.mkdtemp(prefix="hifiasm-bench-",
                                        dir=os.environ.get("TMPDIR"))

    def _make(self, children, scale: float, name: str) -> list:
        d = os.path.join(self.workdir, name)
        os.makedirs(d)
        return self.gen.make([np.random.default_rng(self.seeds[c])
                              for c in children], self.cell.config,
                             self.cell.traffic, scale, d,
                             dataset_seed=self.dataset_seed)

    def window(self, count: Optional[int] = None) -> list:
        """The first ``count`` (default all) window inputs."""
        return self._make(range(count or self.n), 1.0, "window")

    def warmup(self):
        return self._make([self.n], float(self.cell.traffic["warmup_scale"]),
                          "warm")[0]


def ec_pairs(store, inp) -> list:
    """Each read that error correction left in ``store`` with the truth
    it was drawn from (the store keeps the input's order)."""
    return [(store.get_codes(i), inp.truth(i)) for i in range(store.n_reads)]


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        variant: Optional[str] = None, spec: Optional[Spec] = None) -> dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and
    ``checks`` last).  ``t_start`` is when the process began (set-up is
    timed from there)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or Spec()
    cell = spec.cell(cell_name)
    if cell.limits is None:
        raise FileNotFoundError(f"no limits file for cell {cell_name!r}")
    import torch

    from hifiasm_tpu_torch.native import set_threads
    runner = Runner(cell, device, variant)
    if device == "cuda":
        from hifiasm_tpu_torch.ops import cuda_build
        cuda_build.load("banded_tb")
        cuda_build.load("banded_fwd")
    set_threads(runner.threads())
    maker = InputMaker(spec, cell, seed)
    n_inputs = maker.n
    workdir = maker.workdir
    try:
        warm = maker.warmup()
        inputs = maker.window()
        stores = [runner.store(inp) for inp in inputs]
        for inp in inputs:
            inp.reads = None           # the stores hold them now
        runner.assemble(warm, os.path.join(workdir, "warm"))
        shutil.rmtree(os.path.join(workdir, "warm"))
        setup_s = time.perf_counter() - t_start

        window = Window()
        kept = []          # (input, store EC left behind, output prefix)
        errors = []
        prof = _profiler(device) if trace else None
        with prof if prof else contextlib.nullcontext():
            k = 0
            while not window.assemblies or \
                    window.assemblies[-1]["t1"] - \
                    window.assemblies[0]["t0"] < seconds:
                if k == n_inputs:
                    errors.append(f"the window used all {n_inputs} inputs "
                                  f"and ran on; a cell needs more\n")
                    break
                inp = inputs[k]
                try:
                    with _span(trace):
                        rec, store, prefix = runner.assemble(
                            inp, os.path.join(workdir, f"a{k}"),
                            store=_take(stores, k))
                except Exception:              # the program failed: report
                    errors.append(traceback.format_exc())
                    break
                window.assemblies.append(rec)
                sys.stderr.write(f"[bench] assembly {k}: {rec['bases']} "
                                 f"bases in {rec['wall_s']:.3f} s\n")
                kept.append((inp, store, prefix))
                k += 1
        del stores
        if prof:
            from benchmark.devtrace import from_profiler
            window.trace = from_profiler(prof)
            del prof
        recs = window.assemblies
        peak = max((r["peak_bytes"] for r in recs), default=0)

        per = []
        while kept:
            inp, store, prefix = kept.pop(0)
            per.append(check.numbers(inp.haps, ec_pairs(store, inp),
                                     runner.outputs(prefix),
                                     bool(cell.config.get("phased"))))
            del store
            shutil.rmtree(os.path.dirname(prefix))
        checks = check.verdict(per, cell.limits)
        n_bad = sum(1 for p in per if not check.passed(
            check.verdict([p], cell.limits)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    for e in errors:
        sys.stderr.write(e)
    if trace:
        metrics = {}
        for m in spec.metrics(cell_name, "per_layer"):
            v = spec.reader(m["name"]).read(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(recs, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics(cell_name, "end_to_end")}
    cuda = device == "cuda"
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": torch.cuda.device_count() if cuda else 1,
           "memory_peak_bytes": peak,
           "power_limit_w": power_limit_w() if cuda else None}
    out = {"correct": not errors and bool(recs) and n_bad == 0,
           "attempted": len(recs) + len(errors),
           "failed": n_bad + len(errors), "metrics": metrics, "device": dev}
    if trace and window.trace is not None:
        dev["busy_s"] = window.trace.busy_s()
        dev["window_s"] = window.trace.window_s()
        out["breakdown"] = {"device_ops": window.trace.top_ops(),
                            "idle_gaps": window.trace.idle_gaps()}
    out["checks"] = checks
    return out


def end_to_end(recs: List[dict], setup_s: float) -> Dict[str, float]:
    """The end-to-end metrics of a window's assembly records: the input
    bases of every assembly over the wall from the first one's start to
    the last one's end, the largest device peak, and the set-up."""
    window_s = recs[-1]["t1"] - recs[0]["t0"] if recs else 0.0
    return {"bases_per_s": sum(r["bases"] for r in recs) / window_s
            if window_s else 0.0,
            "peak_device_gib": max((r["peak_bytes"] for r in recs),
                                   default=0) / 2 ** 30,
            "setup_s": setup_s}


def _take(items: list, k: int):
    """``items[k]``, which the list then lets go of."""
    item, items[k] = items[k], None
    return item


def _profiler(device: str):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _span(on: bool):
    from torch.profiler import record_function

    from benchmark.devtrace import ASSEMBLY_SPAN

    return record_function(ASSEMBLY_SPAN) if on else contextlib.nullcontext()
