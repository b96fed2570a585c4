#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hifiasm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --kernels    # phases 1-3b: build, K1 and K2

Phases, in order; any failure raises and the script exits nonzero:

1. card identity (nvidia-smi name and power limit);
2. build every CUDA kernel (one nvcc per source, all at once) and the
   native host library from the sources in this checkout, side by side,
   so that no later phase times a build;
3. K1 (csrc/banded_tb.cu) against its plain PyTorch version on the card,
   first on a boundary stress set (xlen at multiples of the checkpoint
   segment and one either side, runs of insertions and deletions,
   ylen < xlen, dead lanes), then at the production shape (XL = 775,
   e = 31, 65,536 windows with ragged lengths and dead lanes): every
   output bit-equal; times of both (the wrapper's call), and the build's
   registers, shared memory and blocks per SM;
3b. K2 (csrc/banded_fwd.cu) on the same windows through its own path,
   the engine-shaped entry point ``banded_forward`` (no assembly path
   calls it, as in the JAX package): bit-equal to its plain version and
   to K1's err and y_end; times of both, and its occupancy;
4. the main path end to end on the card: a synthetic 4 Mb genome, HiFi
   reads of 15 kb at 30x depth with 0.3% error (~120 Mb), the default
   3 EC rounds through ``assemble(..., device="cuda")``, whose EC rounds
   must take the device front end (anchors, quick chaining and t_ws on
   the card); the kernel launch counts are zeroed just before and read
   just after;
5. card against plain end to end: a small store assembled with
   device="cuda" (device front end on) and with device="cpu" and
   ``device_frontend=False`` gives byte-identical outputs.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM (NVIDIA data sheet and Hopper whitepaper): 3.35 TB/s HBM3;
# 132 SMs at 1.98 GHz boost, each SM with 64 lanes a clock on the integer
# ALU pipe and 64 on the FMA pipe (which also runs IMAD)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Operations of K1 and K2: instructions in `cuobjdump -sass` of the e = 31
# kernels that phase 2 builds (python -m hifiasm_tpu_torch.ops.cuda_build
# DIR dumps them; scripts/sass_counts.py counts an address range), as
# (integer ALU pipe, IMAD on the FMA pipe); loads, stores, branches and
# barriers are left out.  Per x row: the 16-row unrolled body of
# csrc/banded_myers.cuh `forward_pass` / 16, alike in both kernels.  K1
# per backward step: pass B's 16 unrolled row steps / 16 (the step has no
# branch, so an insertion run costs nothing beyond its row).  Per window:
# the free-end scan (62 steps, unrolled x2) and, in K1, the y code planes
# built before pass B.  K1's recompute (783 + 80 per 16 rows) is the
# design's cost, not the function's work, and is left out, as are staging
# and the write-out (bytes, counted in the bytes bound).
K1_ROW = (47.0, 5.125)
K1_BACK_ROW = (56.25, 15.375)
K1_END = (1420, 196)
K2_ROW = (47.0625, 5.0625)
K2_END = (733, 8)

# the production shapes the gate runs at; a cut is recorded in PERF.md
K1_WINDOWS = 65536          # one DeviceEC chunk of windows
K1_STRESS = 8192            # K1's boundary stress windows
MAIN_DEPTH = 30.0           # read depth of the main-path run


def _mutate(seq, n_err, rng):
    s = list(seq)
    for _ in range(n_err):
        k = rng.choice(3)
        p = int(rng.integers(0, len(s)))
        if k == 0:
            s[p] = int(rng.integers(0, 4))
        elif k == 1 and len(s) > 1:
            del s[p]
        else:
            s.insert(p, int(rng.integers(0, 4)))
    return np.array(s, np.uint8)


def k1_problems(rng, B: int, XL: int, e: int):
    """Windows made by mutating random sequences: ragged xlen/ylen, some
    ylen < xlen, and dead lanes (xlen = 0, ylen = 0)."""
    YL = XL + 2 * e
    x = np.full((B, XL), 4, np.uint8)
    y = np.full((B, YL), 4, np.uint8)
    xlen = np.zeros(B, np.int32)
    ylen = np.zeros(B, np.int32)
    for b in range(B):
        xl = XL if b % 3 else int(rng.integers(XL // 2, XL + 1))
        base = rng.integers(0, 4, xl).astype(np.uint8)
        yb = _mutate(base, int(rng.integers(0, 40)), rng)
        off = int(rng.integers(0, 2 * e + 1))
        yfull = np.concatenate(
            [rng.integers(0, 4, off).astype(np.uint8), yb,
             rng.integers(0, 4, YL).astype(np.uint8)])[:YL]
        yl = YL if b % 4 else int(rng.integers(1, YL))
        if b % 17 == 0:
            yl = int(rng.integers(1, max(xl, 2)))
        x[b, :xl] = base
        xlen[b] = xl
        y[b, :yl] = yfull[:yl]
        ylen[b] = yl
    xlen[::997] = 0
    ylen[1::1009] = 0
    return x, xlen, y, ylen


def k1_stress(rng, B: int, XL: int, e: int, rc: int = 16):
    """Windows at K1's segment boundaries: xlen at every multiple of
    ``rc`` and one either side (0, 1 and XL among them), cycling through
    y made of x with runs of insertions, with runs of deletions, with
    mixed errors, unrelated to x, or cut below xlen; every 29th lane has
    ylen = 0."""
    YL = XL + 2 * e
    lens = sorted({v for k in range(XL // rc + 2)
                   for v in (k * rc - 1, k * rc, k * rc + 1)
                   if 0 <= v <= XL} | {XL})
    x = np.full((B, XL), 4, np.uint8)
    y = np.full((B, YL), 4, np.uint8)
    xlen = np.zeros(B, np.int32)
    ylen = np.zeros(B, np.int32)
    runs = max(e // 3, 1)
    for b in range(B):
        xl = lens[b % len(lens)]
        base = rng.integers(0, 4, xl).astype(np.uint8)
        s = list(base)
        kind = (b // len(lens) + b) % 5
        if kind == 0:                    # insertion runs, one up to e
            for n in [int(rng.integers(1, max(e, 1) + 1))] + \
                    list(rng.integers(1, runs + 1, int(rng.integers(0, 3)))):
                p = int(rng.integers(0, len(s) + 1))
                s[p:p] = list(rng.integers(0, 4, int(n)))
        elif kind == 1:                  # deletion runs
            for _ in range(int(rng.integers(1, 4))):
                if s:
                    p = int(rng.integers(0, len(s)))
                    del s[p:p + int(rng.integers(1, runs + 1))]
        elif kind == 2 and xl:
            s = list(_mutate(base, int(rng.integers(0, e + 1)), rng))
        elif kind == 3:
            s = list(rng.integers(0, 4, xl))
        off = int(rng.integers(0, 2 * e + 1))
        yfull = np.concatenate(
            [rng.integers(0, 4, off), np.array(s, np.int64),
             rng.integers(0, 4, YL)]).astype(np.uint8)[:YL]
        yl = int(rng.integers(0, max(xl, 1))) if kind == 4 else YL
        if b % 29 == 7:
            yl = 0
        x[b, :xl] = base
        xlen[b] = xl
        y[b, :yl] = yfull[:yl]
        ylen[b] = yl
    return x, xlen, y, ylen


def _cuda_ms(fn, reps: int, calls: int = 1) -> float:
    """Median milliseconds per call of ``fn`` on the card: CUDA events
    around ``calls`` calls in a row (so that the host's time to enqueue a
    call hides behind the card's work on the one before), over ``reps``
    runs."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def _work(x, e: int, n: dict, per: dict, out_bytes: int) -> dict:
    """What a banded kernel must do for these windows: the bytes it must
    move (each input read once, each output written once) and the
    instructions it runs, per pipe, for this data: ``n`` counts each
    event, ``per`` gives its (ALU, FMA) instructions."""
    B, XL = x.shape
    n = dict(n)
    n["alu"] = sum(n[k] * per[k][0] for k in per)
    n["fma"] = sum(n[k] * per[k][1] for k in per)
    n["bytes"] = B * (XL + XL + 2 * e + 8) + out_bytes
    return n


def _rows(x, xlen) -> int:
    return int(np.clip(xlen.astype(np.int64), 0, x.shape[1]).sum())


def k1_bound(x, xlen, tb, e: int) -> dict:
    """K1's work: the forward rows once, the backward steps (one per x
    row of an aligned window; an insertion run is one bit scan inside
    its row's step, so it adds nothing), the free-end scan and the y
    planes per window; not the recompute.  err, y_start, y_end and the
    three [B, XL] planes out."""
    B, XL = x.shape
    return _work(x, e,
                 {"rows": _rows(x, xlen), "bwd_rows": int((tb < 5).sum()),
                  "windows": B},
                 {"rows": K1_ROW, "bwd_rows": K1_BACK_ROW,
                  "windows": K1_END},
                 B * (12 + 3 * XL))


def k2_bound(x, xlen, e: int) -> dict:
    """K2's work: the forward rows and the free-end scan per window; err
    and y_end out."""
    B = x.shape[0]
    return _work(x, e, {"rows": _rows(x, xlen), "windows": B},
                 {"rows": K2_ROW, "windows": K2_END}, B * 8)


def _bound(rec: dict, work: dict) -> dict:
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    # the two pipes run side by side: the busier one sets the time
    t_ops = max(work["alu"], work["fma"]) / INT32_OPS_PER_S * 1e3
    rec["bound_ms"] = max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return rec


def _equal(tag: str, names, got, ref) -> int:
    """Raise unless every output equals its plain version's; the largest
    absolute difference (0)."""
    import torch

    max_err = 0
    for n, a, b in zip(names, got, ref):
        d = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        max_err = max(max_err, d)
        if not torch.equal(a, b):
            raise AssertionError(f"{tag} {n} differs from the plain version "
                                 f"(max abs diff {d})")
    return max_err


def phase_k1(prob, stress, e: int = 31):
    """K1 against its plain version on the production windows and on the
    boundary stress set (bit-equal), then the wrapper's time."""
    import torch

    from hifiasm_tpu_torch.ops import cuda_build
    from hifiasm_tpu_torch.ops.banded_tb import banded_tb, banded_tb_torch

    names = ("err", "y_start", "y_end", "tb", "ic", "ib")
    saved = banded_tb.launches
    st_args = [torch.as_tensor(a).cuda() for a in stress]
    _equal("K1 (stress set)", names, banded_tb(*st_args, e),
           banded_tb_torch(*st_args, e))
    print(f"[k1] bit-equal on the {len(stress[0])} boundary stress windows "
          f"(xlen at multiples of 16 and +-1, insertion and deletion runs, "
          f"ylen < xlen, dead lanes)", flush=True)
    x, xlen, y, ylen = prob
    B, XL = x.shape
    args = [torch.as_tensor(a).cuda() for a in prob]
    got = banded_tb(*args, e)
    max_err = _equal("K1", names, got, banded_tb_torch(*args, e))
    torch.cuda.synchronize()
    ok = int((got[0] >= 0).sum())
    print(f"[k1] bit-equal on all {B} windows ({ok} aligned, "
          f"{B - ok} failed)", flush=True)
    banded_tb(*args, e)                              # warm-up
    ms = _cuda_ms(lambda: banded_tb(*args, e), 5, 10)
    plain_ms = _cuda_ms(lambda: banded_tb_torch(*args, e), 3)
    banded_tb.launches = saved       # comparison launches do not count
    work = k1_bound(x, xlen, got[3].cpu().numpy(), e)
    rec = _bound({"name": "banded_tb", "route": "cuda",
                  "source": "hifiasm_tpu_torch/csrc/banded_tb.cu",
                  "replaces": "hifiasm_tpu/ops/pallas_tb.py:440",
                  "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": None, **cuda_build.info("banded_tb")}, work)
    print(f"[k1] XL={XL} e={e} B={B}: kernel {ms:.3f} ms "
          f"({B / ms * 1e3:.0f} windows/s), plain {plain_ms:.3f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{json.dumps(work)}), {rec['regs']} registers, "
          f"{rec['smem_bytes']} B shared, {rec['blocks_per_sm']} "
          f"blocks/SM", flush=True)
    return rec, got


def phase_k2(prob, k1_out, e: int = 31):
    """K2 through its path, the entry point banded_forward, with its
    launch count zeroed just before and read just after; then held
    against its plain version and K1 on the same windows, and timed."""
    import torch

    from hifiasm_tpu_torch.ops import cuda_build
    from hifiasm_tpu_torch.ops.banded_fwd import (
        banded_forward, banded_forward_torch,
    )

    x, xlen, y, ylen = prob
    B, XL = x.shape
    args = [torch.as_tensor(a).cuda() for a in prob]
    banded_forward.launches = 0
    got = banded_forward(*args, e)
    torch.cuda.synchronize()
    launches = banded_forward.launches
    if launches == 0:
        raise AssertionError("banded_forward launched no K2 kernel")
    max_err = _equal("K2", ("err", "y_end"), (got.err, got.y_end),
                     banded_forward_torch(*args, e))
    for n, a, k1 in (("err", got.err, k1_out[0]),
                     ("y_end", got.y_end, k1_out[2])):
        if not torch.equal(a, k1):
            raise AssertionError(f"K2 {n} differs from K1's")
    print(f"[k2] bit-equal to its plain version and to K1's err/y_end on "
          f"all {B} windows ({launches} launch on its path)", flush=True)
    banded_forward(*args, e)                          # warm-up
    ms = _cuda_ms(lambda: banded_forward(*args, e), 5, 10)
    plain_ms = _cuda_ms(lambda: banded_forward_torch(*args, e), 3)
    work = k2_bound(x, xlen, e)
    rec = _bound({"name": "banded_fwd", "route": "cuda",
                  "source": "hifiasm_tpu_torch/csrc/banded_fwd.cu",
                  "replaces": "hifiasm_tpu/ops/banded_pallas.py:165",
                  "launches": launches, "max_abs_err": max_err, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": None,
                  **cuda_build.info("banded_fwd")}, work)
    print(f"[k2] XL={XL} e={e} B={B}: kernel {ms:.3f} ms "
          f"({B / ms * 1e3:.0f} windows/s), plain {plain_ms:.3f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{json.dumps(work)}), {rec['regs']} registers, "
          f"{rec['smem_bytes']} B shared, {rec['blocks_per_sm']} "
          f"blocks/SM", flush=True)
    return rec


def _n50(lens):
    lens = sorted(lens, reverse=True)
    half, acc = sum(lens) / 2, 0
    for n in lens:
        acc += n
        if acc >= half:
            return n
    return 0


def _contig_lens(path):
    lens, cur = [], None
    with open(path) as f:
        for ln in f:
            if ln.startswith(">"):
                if cur is not None:
                    lens.append(cur)
                cur = 0
            else:
                cur += len(ln.strip())
    if cur is not None:
        lens.append(cur)
    return lens


def _synth():
    """tests/synth.py (numpy only), loaded by path: another installed
    package named ``tests`` must not shadow it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "hifiasm_synth", os.path.join(ROOT, "tests", "synth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _store(genome_len, depth, read_len, err, seed):
    from hifiasm_tpu_torch.io.readstore import ReadStore

    synth = _synth()
    rng = np.random.default_rng(seed)
    g = synth.make_genome(rng, genome_len)
    reads, _, _ = synth.sample_reads(rng, g, depth=depth,
                                     read_len=read_len, err_rate=err)
    return ReadStore.from_arrays([f"r{i}" for i in range(len(reads))],
                                 reads)


def phase_main(out_dir: str, genome_len: int, depth: float, read_len: int,
               err: float):
    import torch

    import hifiasm_tpu_torch.ec.device_ec as D
    import hifiasm_tpu_torch.ec.pipeline as P
    import hifiasm_tpu_torch.index.pos_table_dev as A
    import hifiasm_tpu_torch.overlap.chain_device as C
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.ops.banded_tb import banded_tb

    t0 = time.time()
    store = _store(genome_len, depth, read_len, err, seed=11)
    print(f"[main] {store.n_reads} reads, {store.total_bases} bases "
          f"(genome {genome_len}, {depth}x, {read_len} bp, err {err}) "
          f"made in {time.time() - t0:.1f} s", flush=True)
    pfx = os.path.join(out_dir, "asm")
    cfg = HifiasmConfig(output_prefix=pfx, ignore_bin=True)
    torch.cuda.reset_peak_memory_stats()
    for st in (D.STATS, P.STATS, A.STATS, C.STATS):
        for k in st:
            st[k] = 0
    banded_tb.launches = 0
    t0 = time.time()
    res = assemble(store, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"banded_tb": banded_tb.launches}
    gfa = f"{pfx}.bp.p_ctg.gfa"
    with open(gfa) as f:
        n_seg = sum(1 for ln in f if ln.startswith("S\t"))
    if n_seg == 0:
        raise AssertionError(f"{gfa} has no contigs")
    if launches["banded_tb"] == 0:
        raise AssertionError("the main path launched no K1 kernel")
    if P.STATS["frontend_rounds"] == 0 or A.STATS["chunks"] == 0:
        raise AssertionError("the EC rounds did not take the device "
                             "front end")
    lens = _contig_lens(f"{pfx}.p_ctg.fa")
    tot = sum(lens)
    if not 0.8 * genome_len <= tot <= 1.25 * genome_len:
        raise AssertionError(f"p_ctg total {tot} bp is not within "
                             f"[0.8, 1.25] x the {genome_len} bp genome")
    stats = {"bases": int(store.total_bases), "reads": int(store.n_reads),
             "wall_s": wall, "bases_per_s": store.total_bases / wall,
             "contigs": len(lens), "n50": _n50(lens), "p_ctg_bp": tot,
             "stage_s": res.stage_s,
             "ec_s": {k: v for k, v in P.STATS.items() if k.endswith("_s")},
             "frontend_rounds": P.STATS["frontend_rounds"],
             "anchors": dict(A.STATS), "chaining": dict(C.STATS),
             "device_ec_parts_s": {k: v for k, v in D.STATS.items()
                                   if k.endswith("_s")},
             "k1_launches": launches["banded_tb"],
             "windows_aligned": D.STATS["windows"],
             "retry_windows": D.STATS["retry_windows"],
             "host_dag_reads": P.STATS["host_dag_reads"],
             "peak_device_bytes": torch.cuda.max_memory_allocated()}
    print("[main] " + json.dumps(stats), flush=True)
    return launches, stats


def phase_small(out_dir: str):
    """Small store (12 kb genome, depth 12, 1,800 bp reads): the four
    outputs must be byte-identical between the card, with the device
    front end, and the CPU, with the host front end."""
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig

    outs = {}
    for dev, fe in (("cuda", True), ("cpu", False)):
        store = _store(12000, 12, 1800, 0.004, seed=11)
        pfx = os.path.join(out_dir, f"small_{dev}")
        assemble(store, HifiasmConfig(output_prefix=pfx, ignore_bin=True,
                                      device_frontend=fe), device=dev)
        outs[dev] = pfx
    for suf in ("bp.p_ctg.gfa", "bp.r_utg.gfa", "bp.p_utg.gfa", "p_ctg.fa"):
        with open(f"{outs['cuda']}.{suf}", "rb") as a, \
                open(f"{outs['cpu']}.{suf}", "rb") as b:
            da, db = a.read(), b.read()
        if da != db or not da:
            raise AssertionError(f"small store: {suf} differs between "
                                 "cuda and cpu (or is empty)")
    print("[small] cuda (device front end) and cpu (host front end) "
          "outputs byte-identical", flush=True)


def phase_build():
    """Compile every CUDA kernel (nvcc) and the native host library (g++)
    at once; raise if any does not load."""
    from concurrent.futures import ThreadPoolExecutor

    from hifiasm_tpu_torch import native
    from hifiasm_tpu_torch.ops import cuda_build

    def timed(fn):
        t0 = time.time()
        return fn(), time.time() - t0

    def kernels():
        cuda_build.build()
        return [cuda_build.load(n) for n in cuda_build.SOURCES]

    with ThreadPoolExecutor(2) as ex:
        kern = ex.submit(timed, kernels)
        nat = ex.submit(timed, native.get_lib)
        _, k_s = kern.result()
        lib, nat_s = nat.result()
    for n in cuda_build.SOURCES:
        for ln in cuda_build.BUILD_LOGS.get(n, "").strip().splitlines():
            print(f"[build:{n}] {ln}", flush=True)
    if lib is None:
        raise RuntimeError("the native host library did not build:\n"
                           + native.BUILD_LOG)
    print(f"[build] CUDA kernels {', '.join(cuda_build.SOURCES)} "
          f"{k_s:.1f} s, native host library {nat_s:.1f} s (in parallel)",
          flush=True)


def main(argv) -> int:
    import torch

    kernels_only = argv == ["--kernels"]
    if argv and not kernels_only:
        print("usage: chip_smoke.py [--kernels]", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "hifiasm_tpu_torch")):
        print("chip_smoke: hifiasm_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.time()

    # 1. card identity
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build every kernel and the native host library
    phase_build()

    # 3. K1 against its plain version at the production shape, then K2
    # on the same windows
    t0 = time.time()
    prob = k1_problems(np.random.default_rng(7), K1_WINDOWS, 775, 31)
    print(f"[k1] made {K1_WINDOWS} windows in {time.time() - t0:.1f} s",
          flush=True)
    stress = k1_stress(np.random.default_rng(8), K1_STRESS, 775, 31)
    rec, k1_out = phase_k1(prob, stress)
    rec_k2 = phase_k2(prob, k1_out)
    del k1_out
    if kernels_only:
        print(json.dumps({"kernels": [rec, rec_k2]}), flush=True)
        return 0

    out_dir = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    # 4. the main path end to end on the card
    launches, _ = phase_main(out_dir, 4_000_000, MAIN_DEPTH, 15000, 0.003)
    rec["launches"] = launches["banded_tb"]
    # 5. card against plain end to end
    phase_small(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)

    print(f"[done] {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [rec, rec_k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
