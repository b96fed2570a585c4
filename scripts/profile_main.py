#!/usr/bin/env python3
"""Phase 4 of chip_smoke.py (the main path at its full size: a 4 Mb
genome, 15 kb HiFi reads at 30x, 3 EC rounds, one card) run once with
``--profile``: one torch.profiler trace per EC round, each read by
scripts/trace_idle.py.

    python3 scripts/profile_main.py [OUT_DIR]

Prints the card's name and power limit, the run's wall time and EC
stage seconds (``device_ec.STATS``: vote_s is L2-L5), and per round the
trace's device idle share, its largest gaps and, per DeviceEC stage, the
host wall time, kernels launched, their device time and the host time
they leave uncovered.  The traces stay in OUT_DIR (default
build/profile_main; each is tens of MB).  Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_main: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    out = argv[0] if argv else os.path.join(ROOT, "build", "profile_main")
    os.makedirs(out, exist_ok=True)
    smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    ti = _load("trace_idle", os.path.join(ROOT, "scripts", "trace_idle.py"))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    smoke.phase_build()

    import hifiasm_tpu_torch.ec.device_ec as D
    import hifiasm_tpu_torch.ec.pipeline as P
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.utils import trace

    store = smoke._store(4_000_000, smoke.MAIN_DEPTH, 15000, 0.003, seed=11)
    prof = os.path.join(out, "traces")
    cfg = HifiasmConfig(output_prefix=os.path.join(out, "asm"),
                        ignore_bin=True, mesh_devices=1, profile_dir=prof)
    trace.reset()
    t0 = time.time()
    res = assemble(store, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    print("[profile-main] " + json.dumps(
        {"bases": int(store.total_bases), "wall_s": wall,
         "stage_s": res.stage_s,
         "ec_s": {k: v for k, v in P.STATS.items() if k.endswith("_s")},
         "device_ec_parts_s": {k: v for k, v in D.STATS.items()
                               if k.endswith("_s")}}), flush=True)
    for n in sorted(os.listdir(prof)):
        print("[trace] " + json.dumps(ti.analyse(os.path.join(prof, n))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
