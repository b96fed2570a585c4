#!/usr/bin/env python3
"""Time K1 (``banded_tb``) and K2 (``banded_forward``) of one tree of the
PyTorch/CUDA port on one CUDA card, at the production shape of
chip_smoke.py phase 3 (XL = 775, e = 31, 65,536 windows, seed 7).

    python3 scripts/bench_banded.py [--root TREE] [--reps N]

TREE (default: this checkout) is the root of a checkout whose
``hifiasm_tpu_torch`` is built and timed.  The windows come from this
checkout's chip_smoke.py ``k1_problems`` (cached in build/bench/), so
every tree sees the same inputs.  To compare two trees, run them in turns
in one call on one card (A, B, B, A).  Prints one JSON line: the card,
the tree, for each kernel the median milliseconds per call of its
wrapper (CUDA events around 10 calls in a row, and around one call),
the device milliseconds per call of each CUDA kernel the wrapper runs
(torch.profiler), and a sha256 of its outputs (equal digests: equal
outputs).  Needs a CUDA card; the build's compiler output goes to
stderr.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _windows(smoke):
    path = os.path.join(HERE, "build", "bench", "windows.npz")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prob = smoke.k1_problems(np.random.default_rng(7), smoke.K1_WINDOWS,
                                 775, 31)
        np.savez(path, *prob)
    with np.load(path) as f:
        return [f[f"arr_{i}"] for i in range(4)]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_ms(fn, calls: int = 10) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches
    (torch.profiler's CUDA activity), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t > 0:
            out[ev.key[:60]] = t / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_banded: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from hifiasm_tpu_torch.ops import cuda_build
    from hifiasm_tpu_torch.ops.banded_fwd import banded_forward
    from hifiasm_tpu_torch.ops.banded_tb import banded_tb

    if not cuda_build.__file__.startswith(root):
        raise RuntimeError(f"imported {cuda_build.__file__}, not {root}")
    cuda_build.build()
    for n, log in cuda_build.BUILD_LOGS.items():
        print(f"[build:{n}]\n{log}", file=sys.stderr)
    smoke = _load("chip_smoke_windows", os.path.join(HERE, "chip_smoke.py"))
    e = 31
    dev = [torch.as_tensor(a).cuda() for a in _windows(smoke)]
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0],
        "tree": root, "B": int(dev[0].shape[0]), "XL": int(dev[0].shape[1]),
        "e": e}
    for name, fn, outs in (
            ("banded_tb", lambda: banded_tb(*dev, e), lambda r: r),
            ("banded_fwd", lambda: banded_forward(*dev, e),
             lambda r: (r.err, r.y_end))):
        res = fn()                                  # build, warm-up
        torch.cuda.synchronize()
        out[name] = {"ms": smoke._cuda_ms(fn, args.reps, 10),
                     "ms_one_call": smoke._cuda_ms(fn, args.reps),
                     "device_ms": _device_ms(fn),
                     "sha256": _digest(outs(res))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
