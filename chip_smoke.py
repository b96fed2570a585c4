#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hifiasm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --kernels    # phases 1-3c: build, K1, K2 and
                                       # the vote kernel
    python3 chip_smoke.py --mesh       # phases 1, 2, 4 and 9-9d: the
                                       # multi-device path beside phase 4
    python3 chip_smoke.py --index      # phases 1, 2, 10 and 10b: the
                                       # device index stages
    python3 chip_smoke.py --ont        # phases 1, 2 and 11-11b: the
                                       # ONT mode (--ont)
    python3 chip_smoke.py --dag        # phases 1, 2 and 12: the host DAG
                                       # pass from gathered tracebacks

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
3b. K2 (csrc/banded_fwd.cu) on the same windows through its entry point
   ``banded_forward``: bit-equal to its plain version and to K1's err
   and y_end; times of both, and its occupancy;
3c. the EC vote kernel (csrc/vote_scatter.cu) in its L4 form on K1's
   tracebacks of those windows, placed on 128 read rows of 16,384
   columns: accumulators and dropped count bit-equal to its plain
   version and to a spare-slot ``index_add_`` route;
   the kernel's time beside its bytes bound, the plain version's and
   that of ``index_add_`` (``library_ms``), and its occupancy;
4. the main path end to end on the card: a synthetic 4 Mb genome, HiFi
   reads of 15 kb at 30x depth with 0.3% error (~120 Mb), the default
   3 EC rounds through ``assemble(..., device="cuda")``, whose EC rounds
   must take the device front end (anchors, quick chaining and t_ws on
   the card) and whose votes must launch the vote kernel in L2 and L4;
   the kernel launch counts are zeroed just before and read just after;
5. card against plain end to end: a small store assembled with
   device="cuda" (device front end on) and with device="cpu" and
   ``device_frontend=False`` gives byte-identical outputs;
6. the diploid modes on the card: a 2 x 1 Mb diploid (het rate 0.002),
   HiFi reads of 15 kb at 15x per haplotype with 0.3% error (~30 Mb),
   50,000 Hi-C pairs per haplotype (150 bp mates, 0.3% error) and yak
   dumps of each haplotype, assembled twice with ``device="cuda"``: a
   ``hic`` run, whose Hi-C seed-extend rescue must launch K2, and a
   ``dip`` run; both must launch K1, give each haplotype 0.5-1.6x its
   length, the hic run its scaffolds and the dip hap1 mostly paternal
   reads; launch counts are zeroed just before each run and read after;
6b. K2 at the rescue's shape (e = 8): the largest rescue batch of
   phase 6 replayed, bit-equal to its plain version, timed, and bounded
   by the function's work (K2's per-row counts, the free-end scan
   scaled to 2e steps); also tiled to 131,072 rows;
7. card against CPU for the new modes: a 16 kb diploid store with Hi-C
   pairs, trio lists and yak dumps; a hic run (with the lists, so
   bench.tsv too) and a dip run resumed from its EC checkpoint, on
   cuda and on cpu: every output byte-identical;
8. the UL mode on the card: a 2 Mb genome with four copies of a 20 kb
   segment, HiFi reads of 15 kb at 20x with 0.3% error (40 Mb) and
   ONT-like UL reads (log-normal lengths, mean 100 kb, clipped to
   50-200 kb, 8x, both strands, 5% error as run-stretching insertions,
   deletions and substitutions) passed as ``--ul``, assembled with
   ``device="cuda"``; it must launch K1, launch K2 in the UL screen
   (``ul.ul_band_err``) at most once per mapping pass per 65,536 rows,
   map at least half of the UL reads and give a p_ctg of 0.8-1.3x the
   genome; then the same reads without ``--ul``, resumed from the UL
   run's EC checkpoint, for the contig count and N50 beside it;
8b. card against CPU for UL: the two UL end-to-end test scenarios
   (tests/test_ul_assembly.py, tests/test_ul_gapfill.py) on cuda and
   on cpu: every output byte-identical, K2 launched in the cuda runs;
8c. K2 at the UL shapes: the largest screen batch (e = 15) and the
   largest junction batch of phase 8 replayed, bit-equal to the plain
   version, timed and bounded; the screen rows also tiled to 131,072;
9. the multi-device path: phase 4's store assembled on a mesh of every
   card when the host has two or more, else of 4 logical shards on
   cuda:0 (``assemble(..., mesh=)``); bp.p_ctg.gfa must be byte-identical
   to phase 4's, K1 must launch on every shard, every EC round must take
   the mesh gather (no device front end) with no lane overflow; wall
   time, bases/s, windows and K1 launches per shard, the host fallback
   count and peak memory per card are printed;
9b. a small store (phase 5's) on the cuda mesh, on a mesh of 4 logical
   CPU shards and on cuda with no mesh: byte-identical outputs;
9c. ``parallel.dryrun.dryrun_multichip`` on the card's mesh;
9d. ``--profile``: phase 5's small store with ``profile_dir`` set must
   write one Chrome trace per EC round, with K1's kernel in it
   (scripts/trace_idle.py reads it);
10. the device index stages that no entry point calls yet, on phase 4's
   store and settings (k = w = 51, the filter table ``assemble`` builds),
   each held to its host mirror and timed beside it: the device sketch
   (``ops/sketch_dev.sketch_many_device``) against the native sketch on
   every field of every read; the device table build
   (``index/pos_table_dev.build_table_device``) against the host build,
   peaks included, and serving the grouped gather's first chunk as the
   uploaded host table does; the per-read anchor gather
   (``collect_anchors_device``) against ``collect_anchors_many``; the
   exact chain DP and extraction (``ops/chain_dev.chain_exact_batch``,
   ``extract_chains_batch``) on the groups the device front end sends to
   the host DP (not quick, at most 2,048 anchors; bucketed by 32, 128,
   512 and 2,048 anchors; up to CHAIN_CELLS cells a bucket in group
   order, the rest counted as left out) and QUICK_BATCH quick groups a
   bucket, against ``chain_dp_native`` and ``extract_chains``;
10b. the five functions on phase 5's small store on cuda and on cpu:
   every output equal.

11. K1 at the ONT mode's window width (XL = 375, hifiasm's WINDOW_OHC,
    e = 31) against its plain version, on the boundary stress set at that
    width and on 65,536 windows of ONT-error reads (``k1_ont_windows``):
    every output bit-equal; the wrapper's time and the bound, printed as
    a kernel JSON line;
11a. the vote kernel's L4 form on phase 11's tracebacks (375-wide
    windows), as phase 3c: bit-equal to its plain version and to the
    ``index_add_`` route, timed beside its bound;
11b. a small ONT store (``ont_store``: 20 kb with repeats, 12x, 3 kb
    reads at ONT R10 errors, 5% chimeric) assembled with ``--ont`` and
    the bloom filter on (-f37), three EC rounds, on cuda and on cpu: the
    four outputs and the corrected reads byte-identical; the cuda run's
    launch counts, zeroed before it, must show K1 and the vote kernel's
    L2 and L4 forms, and are the ``launches`` of both kernel records.

12. the host DAG pass of reads with an ambiguity cluster, whose strings
    come from the columns of K1's tracebacks that DeviceEC gathers on
    the card: a small store of the benchmark's human-repeat proxy (40 kb,
    15x HiFi of 6 kb) and ``ont_store`` (with --ont), three EC rounds
    each, on cuda with the native pass (a thread a CPU), on cuda with
    the Python pass (``_host_dag``, one read after another) and on cpu
    with the native pass on one thread: the corrected reads and
    bp.p_ctg.gfa byte-identical, reads on the host DAG pass in all
    three, none of them without its columns, every one served natively
    in the native runs and none in the Python run; the gather's counters
    (``dag_gather_windows``, ``dag_gather_bytes``, ``dag_gather_s``) and
    the host DAG's (``host_dag_s`` times the pass) are printed as
    ``{"dag": ...}``.

Phase 11 runs with ``--ont`` only.  The line before the kernel table
holds phase 10's times and counts as ``{"device_index": ...}``, the
line before it phase 12's as ``{"dag": ...}``.  The line before the
last is the kernel
table as JSON; the last line is
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
# The bound at another e (the Hi-C rescue's e = 8) takes the same per-row
# counts and scales the free-end scan to its 2e steps.  K2's any-e build
# spends more (a runtime e); that is the build's overhead, not the
# function's work, and PERF.md keeps its counts as a note.
K2_END_STEPS = 62

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


# ONT R10.4.1 simplex reads as phases 11 and 11b and the CPU tests make
# them (the numbers of the benchmark's ont_proxy30x traffic, written out
# so that a change to that traffic leaves these inputs as they are):
# log-normal lengths (CV ``sigma``) clipped below at 1 kb, a per-read
# error rate log-normal around 1% (Q20) clipped to 0.2-5%, 20%
# substitutions, 25% insertions and 55% deletions
ONT_READS = {"mean_len": 20000, "sigma": 0.5, "min_len": 1000,
             "err_rate": 0.01, "err_sigma": 0.5, "err_min": 0.002,
             "err_max": 0.05, "sub_frac": 0.20, "ins_frac": 0.25,
             "chimera_frac": 0.01}


def k1_ont_windows(rng, B: int, XL: int = 375, e: int = 31):
    """EC windows of ONT reads: x is ``XL`` bases of a read and y the
    same stretch of another read with ``e`` bases of flank either side,
    each read with ``ONT_READS``' errors (a per-read rate log-normal
    around 1%, clipped to 0.2-5%, 20% substitutions, 25% insertions, 55%
    deletions at homopolymer-weighted sites), so that the windows of the
    noisiest reads fail the band; every 7th window is the short last
    window of its read, and every 13th y is cut short."""
    from benchmark.inputs.ont import ont_errors

    t = ONT_READS
    YL = XL + 2 * e
    x = np.full((B, XL), 4, np.uint8)
    y = np.full((B, YL), 4, np.uint8)
    xlen = np.zeros(B, np.int32)
    ylen = np.zeros(B, np.int32)
    rates = np.clip(t["err_rate"] * np.exp(
        t["err_sigma"] * rng.standard_normal((B, 2))),
        t["err_min"], t["err_max"])
    for b in range(B):
        g = rng.integers(0, 4, 2 * YL).astype(np.uint8)
        xs = ont_errors(rng, g[e:e + XL + 16], rates[b, 0], t["sub_frac"],
                        t["ins_frac"])
        ys = ont_errors(rng, g[:YL + 16], rates[b, 1], t["sub_frac"],
                        t["ins_frac"])
        xl = int(rng.integers(XL // 4, XL + 1)) if b % 7 == 3 else XL
        xl = min(xl, len(xs))
        yl = min(YL, len(ys))
        if b % 13 == 5:
            yl = int(rng.integers(xl // 2, yl + 1))
        x[b, :xl] = xs[:xl]
        y[b, :yl] = ys[:yl]
        xlen[b] = xl
        ylen[b] = yl
    return x, xlen, y, ylen


def ont_store(seed: int = 19, genome_len: int = 20000, depth: float = 12,
              mean_len: int = 3000, chimera_frac: float = 0.05):
    """A small ONT store: a genome with three copies of a 500-base repeat
    (``make_genome``, repeat_frac 0.1) and reads of it with
    ``ONT_READS``' length spread and errors, lengths of mean ``mean_len``
    and a ``chimera_frac`` share of chimeric reads.  At the defaults the
    ONT graph branches both act (one EC round on the CPU: 6 records kept
    by the el rescue, 6 reads cut by the chemical-arc rule)."""
    from benchmark.inputs.ont import ont_reads
    from hifiasm_tpu_torch.io.readstore import ReadStore

    rng = np.random.default_rng(seed)
    g = _synth().make_genome(rng, genome_len, repeat_frac=0.1)
    t = dict(ONT_READS, depth=depth, mean_len=mean_len,
             chimera_frac=chimera_frac)
    reads, _ = ont_reads(rng, g, t)
    return ReadStore.from_arrays([f"r{i}" for i in range(len(reads))],
                                 reads)


def proxy_store(seed: int = 3, genome_len: int = 40000, depth: float = 15,
                mean_len: int = 6000):
    """A small HiFi store of the benchmark's human-repeat proxy genome
    (``proxy_genome``: an alpha-satellite HOR array, LINEs, STR/VNTR
    runs, segmental duplications), 0.3% errors, 1.5% chimeric reads."""
    from benchmark.inputs.synth import hifi_reads, proxy_genome
    from hifiasm_tpu_torch.io.readstore import ReadStore

    rng = np.random.default_rng(seed)
    g = proxy_genome(rng, genome_len)
    reads, _ = hifi_reads(rng, g, depth, mean_len, 0.003, 0.015, 0.35)
    return ReadStore.from_arrays([f"r{i}" for i in range(len(reads))],
                                 reads)


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
    """K2's work: the forward rows and the free-end scan per window (its
    e = 31 count scaled to 2e steps); err and y_end out."""
    B = x.shape[0]
    end = tuple(c * 2 * e / K2_END_STEPS for c in K2_END)
    return _work(x, e, {"rows": _rows(x, xlen), "windows": B},
                 {"rows": K2_ROW, "windows": end}, B * 8)


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


# the vote kernel's stand-in read rows (phase 3c): K1's windows tile each
# row at multiples of the window width, about 24 deep, as a 30x batch
VOTE_ROWS = 128
VOTE_L = 16384


def vote_inputs(rng, k1_out, prob):
    """Phase 3c's L4 inputs on the card: K1's (tb, ic, ib) planes of the
    production windows, each window at a random row and a random multiple
    of XL on it, kept where K1 aligned it and, nine in ten, cis."""
    import torch

    x, xlen, _, _ = prob
    B, XL = x.shape
    dev = k1_out[3].device
    qlen_row = rng.integers(VOTE_L * 3 // 4, VOTE_L + 1, VOTE_ROWS)
    q_row = rng.integers(0, VOTE_ROWS, B)
    q_ws = rng.integers(0, VOTE_L // XL + 1, B) * XL
    err = k1_out[0].cpu().numpy()
    mask = (err >= 0) & (rng.random(B) < 0.9)
    t = [torch.as_tensor(a, dtype=torch.int64, device=dev)
         for a in (q_row, q_ws, xlen, qlen_row[q_row])]
    return (*k1_out[3:6], *t, torch.as_tensor(mask, device=dev))


def _vote_accs(dev):
    import torch

    RL = VOTE_ROWS * VOTE_L
    return [torch.zeros(k * RL + 1, dtype=torch.int32, device=dev)
            for k in (5, 1, 4, 9)]


def _index_add_route(accs, tb, ic, ib, q_row, q_ws, xlen, qlen_w, mask):
    """The L4 votes as plain ``index_add_`` calls, the library route the
    kernel is timed beside: the masked entries go to each accumulator's
    spare last slot, which counts them."""
    import torch

    from hifiasm_tpu_torch.ops.vote_scatter import cis_entries

    for acc, idx, keep in cis_entries(*accs, VOTE_L, tb, ic, ib, q_row, q_ws,
                                      xlen, qlen_w, mask):
        idx = torch.where(keep, idx, torch.full_like(idx, acc.numel() - 1))
        idx = idx.reshape(-1)
        acc.index_add_(0, idx, torch.ones_like(idx, dtype=acc.dtype))


def phase_votes(k1_out, prob):
    """Phase 3c: the vote kernel's L4 form on K1's windows against its
    plain version and the spare-slot index_add_ route (bit-equal
    accumulators and dropped counts), then timed beside its bound."""
    import torch

    from hifiasm_tpu_torch.ops import cuda_build
    from hifiasm_tpu_torch.ops import vote_scatter as V

    args = vote_inputs(np.random.default_rng(9), k1_out, prob)
    tb, ic, ib, q_row, q_ws, xlen, qlen_w, mask = args
    B, XL = tb.shape
    dev = tb.device
    saved = V.cis_votes.launches
    outs = {}
    for tag in ("kernel", "plain", "index_add"):
        accs = _vote_accs(dev)
        if tag == "index_add":
            _index_add_route(accs, *args)
            dropped = sum(int(a[-1]) for a in accs)
            for a in accs:        # the spare slots held the drops
                a[-1] = 0
        else:
            fn = V.cis_votes if tag == "kernel" else V.cis_votes_torch
            d = torch.zeros((), dtype=torch.int64, device=dev)
            fn(*accs, VOTE_L, *args, d)
            dropped = int(d)
        torch.cuda.synchronize()
        outs[tag] = (accs, dropped)
    if V.cis_votes.launches == saved:
        raise AssertionError("cis_votes launched no vote kernel")
    names = ("votes", "ins_tot", "ins_bc", "ins_lc")
    for tag in ("plain", "index_add"):
        _equal(f"vote kernel against {tag}", names, outs["kernel"][0],
               outs[tag][0])
        if outs["kernel"][1] != outs[tag][1]:
            raise AssertionError(f"vote kernel dropped {outs['kernel'][1]} "
                                 f"entries, {tag} {outs[tag][1]}")
    accs = outs["kernel"][0]
    given = 4 * B * XL
    dropped = outs["kernel"][1]
    kept = given - dropped
    touched = sum(int((a != 0).sum()) for a in accs)
    print(f"[votes] bit-equal to the plain version and to index_add_ on "
          f"{B} windows: {given} entries, {dropped} dropped "
          f"({100 * dropped / given:.2f}%), {kept} kept, {touched} "
          f"accumulator words touched", flush=True)

    def kernel():
        V.cis_votes(*accs, VOTE_L, *args, None)

    kernel()                                            # warm-up
    ms = _cuda_ms(kernel, 5, 10)
    plain_ms = _cuda_ms(lambda: V.cis_votes_torch(*accs, VOTE_L, *args), 3)
    lib_accs = _vote_accs(dev)
    library_ms = _cuda_ms(lambda: _index_add_route(lib_accs, *args), 3)
    V.cis_votes.launches = saved     # comparison launches do not count
    # bytes the function needs: the plane bytes of the columns it reads
    # (tb of every kept-window column in range, ic of those, ib where
    # ic > 0), the descriptors, and a read and a write of every
    # accumulator word it touches
    pos, valid = V.abs_index(XL, VOTE_L, q_row, q_ws, xlen, qlen_w, mask)
    n_cols = int(valid.sum())
    n_ib = int((valid & (ic > 0)).sum())
    del pos, valid
    work = {"entries": given, "kept_atomics": kept, "dropped": dropped,
            "columns_read": n_cols, "bytes": 2 * n_cols + n_ib + B * 33 +
            8 * touched}
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    rec = {"name": "vote_scatter", "route": "cuda",
           "source": "hifiasm_tpu_torch/csrc/vote_scatter.cu",
           "replaces": None, "shape": {"B": B, "XL": XL, "form": "L4"},
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": t_bytes, "bound_by": "bytes",
           "atomics_per_s": kept / (ms * 1e-3), "max_abs_err": 0,
           **cuda_build.info("vote_scatter")}
    print(f"[votes] XL={XL} B={B} (L4): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound "
          f"{t_bytes:.4f} ms (bytes: {json.dumps(work)}), "
          f"{rec['atomics_per_s'] / 1e9:.1f} G kept atomics/s, "
          f"{rec['regs']} registers, {rec['smem_bytes']} B shared, "
          f"{rec['blocks_per_sm']} blocks/SM", flush=True)
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
    from hifiasm_tpu_torch.ops import vote_scatter as V
    from hifiasm_tpu_torch.ops.banded_tb import banded_tb
    from hifiasm_tpu_torch.utils import trace

    t0 = time.time()
    store = _store(genome_len, depth, read_len, err, seed=11)
    print(f"[main] {store.n_reads} reads, {store.total_bases} bases "
          f"(genome {genome_len}, {depth}x, {read_len} bp, err {err}) "
          f"made in {time.time() - t0:.1f} s", flush=True)
    pfx = os.path.join(out_dir, "asm")
    # one device on any host (a host of several cards would take the mesh)
    cfg = HifiasmConfig(output_prefix=pfx, ignore_bin=True, mesh_devices=1)
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    banded_tb.launches = 0
    V.raw_counts.launches = V.cis_votes.launches = V.masked_add.launches = 0
    t0 = time.time()
    res = assemble(store, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"banded_tb": banded_tb.launches,
                "vote_scatter": {"L2": V.raw_counts.launches,
                                 "L4": V.cis_votes.launches,
                                 "seam": V.masked_add.launches}}
    gfa = f"{pfx}.bp.p_ctg.gfa"
    with open(gfa) as f:
        n_seg = sum(1 for ln in f if ln.startswith("S\t"))
    if n_seg == 0:
        raise AssertionError(f"{gfa} has no contigs")
    if launches["banded_tb"] == 0:
        raise AssertionError("the main path launched no K1 kernel")
    if not (launches["vote_scatter"]["L2"] and launches["vote_scatter"]["L4"]):
        raise AssertionError("the main path's votes launched no vote kernel "
                             f"in L2 or L4: {launches['vote_scatter']}")
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
             "vote_launches": launches["vote_scatter"],
             "vote_adds": D.STATS["vote_adds"],
             "vote_dropped_adds": D.STATS["vote_dropped_adds"],
             "windows_aligned": D.STATS["windows"],
             "retry_windows": D.STATS["retry_windows"],
             "host_dag_reads": P.STATS["host_dag_reads"],
             "peak_device_bytes": torch.cuda.max_memory_allocated()}
    print("[main] " + json.dumps(stats), flush=True)
    return launches, stats


def card_mesh():
    """Every card when the host has two or more, else 4 logical shards
    on cuda:0; and which of the two it is."""
    import torch

    from hifiasm_tpu_torch.parallel.mesh import Mesh

    n = torch.cuda.device_count()
    if n >= 2:
        return Mesh([f"cuda:{i}" for i in range(n)]), f"{n} cards"
    return Mesh(["cuda:0"] * 4), "4 logical shards on cuda:0"


def phase_mesh(out_dir: str, main_gfa: str, genome_len: int, depth: float,
               read_len: int, err: float):
    """Phase 9: phase 4's store assembled on the card's mesh; its
    bp.p_ctg.gfa must be byte-identical to phase 4's.  Returns the K1
    launches and the stats."""
    import torch

    import hifiasm_tpu_torch.ec.device_ec as D
    import hifiasm_tpu_torch.ec.pipeline as P
    import hifiasm_tpu_torch.parallel.index_shard as I
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.ops.banded_tb import banded_tb
    from hifiasm_tpu_torch.utils import trace

    mesh, how = card_mesh()
    print(f"[mesh] {how}: {[str(d) for d in mesh.devices]}", flush=True)
    store = _store(genome_len, depth, read_len, err, seed=11)
    pfx = os.path.join(out_dir, "mesh")
    cfg = HifiasmConfig(output_prefix=pfx, ignore_bin=True)
    for dev in mesh.distinct:
        torch.cuda.reset_peak_memory_stats(dev)
    trace.reset()
    banded_tb.launches = 0
    t0 = time.time()
    res = assemble(store, cfg, device="cuda", mesh=mesh)
    for dev in mesh.distinct:
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    launches = banded_tb.launches
    with open(main_gfa, "rb") as a, open(f"{pfx}.bp.p_ctg.gfa", "rb") as b:
        if a.read() != b.read():
            raise AssertionError("the mesh run's bp.p_ctg.gfa differs from "
                                 "phase 4's")
    shards = {s: dict(D.SHARD_STATS.get(s, {})) for s in range(len(mesh))}
    idle = [s for s, st in shards.items() if not st.get("k1_launches")]
    if idle:
        raise AssertionError(f"K1 did not launch on shards {idle}")
    if P.STATS["mesh_rounds"] == 0 or P.STATS["frontend_rounds"]:
        raise AssertionError(
            f"{P.STATS['mesh_rounds']} rounds took the mesh gather and "
            f"{P.STATS['frontend_rounds']} the device front end")
    if I.STATS["overflow"]:
        raise AssertionError(f"{I.STATS['overflow']} queries overflowed "
                             "their lanes")
    stats = {"mesh": how, "shards": len(mesh),
             "bases": int(store.total_bases), "wall_s": wall,
             "bases_per_s": store.total_bases / wall,
             "p_ctg_identical_to_phase_4": True,
             "stage_s": res.stage_s,
             "ec_s": {k: v for k, v in P.STATS.items() if k.endswith("_s")},
             "mesh_rounds": P.STATS["mesh_rounds"],
             "host_fallback_queries": P.STATS["mesh_fallback"],
             "lanes": dict(I.STATS),
             "device_ec_parts_s": {k: v for k, v in D.STATS.items()
                                   if k.endswith("_s")},
             "k1_launches": launches, "per_shard": shards,
             "windows_aligned": D.STATS["windows"],
             "retry_windows": D.STATS["retry_windows"],
             "host_dag_reads": P.STATS["host_dag_reads"],
             "peak_device_bytes": {str(d): torch.cuda.max_memory_allocated(d)
                                   for d in mesh.distinct}}
    print("[mesh] " + json.dumps(stats), flush=True)
    return launches, stats


def phase_mesh_small(out_dir: str):
    """Phase 9b: phase 5's small store on the card's mesh, on a mesh of 4
    logical CPU shards, and on cuda with no mesh: the four outputs must
    be byte-identical, and K1 must launch in the cuda mesh run."""
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.ops.banded_tb import banded_tb
    from hifiasm_tpu_torch.parallel.mesh import Mesh

    mesh, _ = card_mesh()
    runs = {"cuda_mesh": ("cuda", mesh),
            "cpu_mesh": ("cpu", Mesh(["cpu"] * 4)), "cuda_one": ("cuda", None)}
    for tag, (dev, m) in runs.items():
        n0 = banded_tb.launches
        assemble(_store(12000, 12, 1800, 0.004, seed=11), HifiasmConfig(
            output_prefix=os.path.join(out_dir, f"m_{tag}"), ignore_bin=True,
            mesh_devices=1 if m is None else 0), device=dev, mesh=m)
        if tag == "cuda_mesh" and banded_tb.launches == n0:
            raise AssertionError("the small cuda mesh run launched no K1")
    for suf in ("bp.p_ctg.gfa", "bp.r_utg.gfa", "bp.p_utg.gfa", "p_ctg.fa"):
        data = []
        for tag in runs:
            with open(os.path.join(out_dir, f"m_{tag}.{suf}"), "rb") as f:
                data.append(f.read())
        if not data[0] or any(d != data[0] for d in data[1:]):
            raise AssertionError(f"small store on the mesh: {suf} differs "
                                 "between the cuda mesh, the cpu mesh and "
                                 "cuda alone (or is empty)")
    print("[mesh-small] cuda mesh, cpu mesh (4 logical shards) and cuda "
          "without a mesh: outputs byte-identical", flush=True)


def phase_dryrun():
    """Phase 9c: dryrun_multichip on the card's mesh."""
    from hifiasm_tpu_torch.parallel.dryrun import dryrun_multichip

    mesh, how = card_mesh()
    t0 = time.time()
    out = dryrun_multichip(mesh, _synth())
    print(f"[dryrun] {how}: {json.dumps(out)} in {time.time() - t0:.1f} s",
          flush=True)


def phase_profile(out_dir: str):
    """Phase 9d: --profile on phase 5's small store: one trace per EC
    round, each naming K1's kernel; the trace's device numbers from
    scripts/trace_idle.py."""
    import importlib.util

    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig

    prof = os.path.join(out_dir, "prof")
    cfg = HifiasmConfig(output_prefix=os.path.join(out_dir, "prof_small"),
                        ignore_bin=True, profile_dir=prof, mesh_devices=1)
    assemble(_store(12000, 12, 1800, 0.004, seed=11), cfg, device="cuda")
    spec = importlib.util.spec_from_file_location(
        "trace_idle", os.path.join(ROOT, "scripts", "trace_idle.py"))
    ti = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ti)
    names = sorted(os.listdir(prof))
    if not names or names != [f"ec_r{r}.json" for r in range(len(names))]:
        raise AssertionError(f"--profile wrote {names}")
    for n in names:
        path = os.path.join(prof, n)
        with open(path) as f:
            if "banded_tb_kernel" not in f.read():
                raise AssertionError(f"{n} does not name K1's kernel")
        rep = ti.analyse(path)
        print(f"[profile] {n} names K1's kernel: " + json.dumps(
            {k: rep[k] for k in ("window_us", "device_events",
                                 "device_busy_us", "idle_share",
                                 "vote")}), flush=True)


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


def phase_ont_small(out_dir: str):
    """Phase 11b: ``ont_store`` assembled with --ont on cuda and on cpu;
    the four outputs and the corrected reads must be byte-identical, and
    the cuda run must launch K1 and the vote kernel's L2 and L4 forms.
    The cuda run's host DAG pass runs on a thread a CPU, the cpu run's
    on one.  Returns the cuda run's launch counts."""
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.ops import vote_scatter as V
    from hifiasm_tpu_torch.ops.banded_tb import banded_tb

    outs, reads = {}, {}
    for dev in ("cuda", "cpu"):
        store = ont_store()
        pfx = os.path.join(out_dir, f"ont_{dev}")
        if dev == "cuda":
            banded_tb.launches = 0
            V.raw_counts.launches = V.cis_votes.launches = 0
            V.masked_add.launches = 0
        t0 = time.time()
        res = assemble(store, HifiasmConfig(
            output_prefix=pfx, ignore_bin=True, mesh_devices=1,
            threads=(os.cpu_count() or 1) if dev == "cuda" else 1,
            is_ont=True, bf_shift=37, n_rounds_ec=3), device=dev)
        if dev == "cuda":
            launches = {"banded_tb": banded_tb.launches,
                        "vote_scatter": {"L2": V.raw_counts.launches,
                                         "L4": V.cis_votes.launches,
                                         "seam": V.masked_add.launches}}
            votes = launches["vote_scatter"]
            if launches["banded_tb"] == 0:
                raise AssertionError("the ONT run launched no K1 kernel")
            if not (votes["L2"] and votes["L4"]):
                raise AssertionError(f"the ONT run launched no vote kernel "
                                     f"in L2 or L4: {votes}")
            print(f"[ont] launches on cuda: {json.dumps(launches)}",
                  flush=True)
        print(f"[ont] {dev}: {store.n_reads} reads, {store.total_bases} "
              f"bases in {time.time() - t0:.1f} s", flush=True)
        outs[dev] = pfx
        reads[dev] = [res.store.get_codes(i).tobytes()
                      for i in range(res.store.n_reads)]
    if reads["cuda"] != reads["cpu"]:
        raise AssertionError("ONT store: the corrected reads differ "
                             "between cuda and cpu")
    for suf in ("bp.p_ctg.gfa", "bp.r_utg.gfa", "bp.p_utg.gfa", "p_ctg.fa"):
        with open(f"{outs['cuda']}.{suf}", "rb") as a, \
                open(f"{outs['cpu']}.{suf}", "rb") as b:
            da, db = a.read(), b.read()
        if da != db or not da:
            raise AssertionError(f"ONT store: {suf} differs between cuda "
                                 "and cpu (or is empty)")
    print("[ont] cuda and cpu outputs and corrected reads byte-identical",
          flush=True)
    return launches


def _fastq(path, seqs):
    nt = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        f.writelines(f"@p{i}\n{nt[s].tobytes().decode()}\n+\n{'I' * len(s)}\n"
                     for i, s in enumerate(seqs))


def _yak(path, hashes, count=20, k=31, pre=10):
    """A yak dump (YAK\\2, 10-bit counters, 2^pre buckets; the layout
    hifiasm_tpu_torch.trio reads) of ``hashes`` at ``count``, written
    bucket by bucket from one stable sort."""
    import struct

    from hifiasm_tpu_torch.trio import YAK_COUNTER_BITS, YAK_MAGIC

    h = np.unique(np.asarray(hashes, np.uint64))
    bucket = (h & np.uint64((1 << pre) - 1)).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    keys = ((h[order] >> np.uint64(pre)) << np.uint64(YAK_COUNTER_BITS)) | \
        np.uint64(min(count, (1 << YAK_COUNTER_BITS) - 1))
    n = np.bincount(bucket, minlength=1 << pre)
    off = np.concatenate([[0], np.cumsum(n)])
    with open(path, "wb") as f:
        f.write(YAK_MAGIC)
        f.write(struct.pack("<3i", k, pre, YAK_COUNTER_BITS))
        for b in range(1 << pre):
            f.write(struct.pack("<2i", int(n[b]), int(n[b])))
            keys[off[b]:off[b + 1]].astype("<u8").tofile(f)


def diploid_inputs(out_dir, genome_len, depth, read_len, err, n_pairs,
                   pair_err, seed):
    """A diploid genome (``make_genome``, het rate 0.002), HiFi reads of
    each haplotype (hap 1's first: the paternal ones), Hi-C pairs whose
    150 bp mates both come from one haplotype at uniform positions with
    errors injected at ``pair_err``, yak dumps of each haplotype's
    31-mers at count 20 (-1/-2) and name lists of the reads (-3/-4).
    Returns (store, n_paternal_reads, options by name)."""
    from hifiasm_tpu_torch.io.readstore import ReadStore
    from hifiasm_tpu_torch.phasing.hic import _seq_kmers

    synth = _synth()
    rng = np.random.default_rng(seed)
    haps = synth.make_genome(rng, genome_len, het_rate=0.002)
    reads = []
    n_pat = 0
    for h in haps:
        reads += synth.sample_reads(rng, h, depth=depth, read_len=read_len,
                                    err_rate=err)[0]
        n_pat = n_pat or len(reads)
    names = [f"r{i}" for i in range(len(reads))]
    mates = ([], [])
    for h in haps:
        pos = rng.integers(0, genome_len - 150, (n_pairs, 2))
        for a, b in pos:
            mates[0].append(synth.inject_errors(rng, h[a:a + 150], pair_err))
            mates[1].append(synth.inject_errors(rng, h[b:b + 150], pair_err))
    f = [os.path.join(out_dir, f"hic_{i + 1}.fq") for i in range(2)]
    for path, m in zip(f, mates):
        _fastq(path, m)
    y = [os.path.join(out_dir, f"{t}.yak") for t in ("pat", "mat")]
    for path, h in zip(y, haps):
        _yak(path, _seq_kmers(h, 31))
    lst = [os.path.join(out_dir, f"{t}.txt") for t in ("pat", "mat")]
    for path, part in zip(lst, (names[:n_pat], names[n_pat:])):
        with open(path, "w") as fh:
            fh.writelines(f"{n}\n" for n in part)
    opts = {"hic": {"hic_reads_1": [f[0]], "hic_reads_2": [f[1]]},
            "yak": {"fn_bin_yak_pat": y[0], "fn_bin_yak_mat": y[1]},
            "lists": {"fn_bin_list_pat": lst[0], "fn_bin_list_mat": lst[1]}}
    return ReadStore.from_arrays(names, reads), n_pat, opts


def _gfa_total(path) -> int:
    with open(path) as f:
        return sum(len(ln.split("\t")[2]) for ln in f if ln.startswith("S\t"))


class RescueCapture:
    """Wraps phasing.hic.rescue_align during a run: keeps the inputs of
    its largest call (the K2 batch phase 6b replays)."""

    def __init__(self):
        import hifiasm_tpu_torch.phasing.hic as H

        self.H, self.orig, self.batch = H, H.rescue_align, None

    def __enter__(self):
        def wrapped(X, xl, Y, yl, e, device="cuda"):
            if self.batch is None or len(X) > len(self.batch[0]):
                self.batch = (X.copy(), xl.copy(), Y.copy(), yl.copy(), e)
            return self.orig(X, xl, Y, yl, e, device)
        self.H.rescue_align = wrapped
        return self

    def __exit__(self, *exc):
        self.H.rescue_align = self.orig


def phase_diploid(out_dir: str, genome_len: int, depth: float,
                  read_len: int, n_pairs: int):
    """Phase 6: the diploid modes on the card.  The same reads assembled
    twice with ``device="cuda"``: ``hic`` (--h1/--h2) and ``dip``
    (-1/-2).  Each run must launch K1; the hic run must launch K2 inside
    the Hi-C rescue; each hap's p_ctg must total 0.5-1.6x the haplotype;
    ``hic.hap[12].scaf.fa`` must be written and not empty; the dip hap1
    must hold more paternal reads than maternal.  Returns the K2 launch
    count of the hic run, its largest rescue batch, and the stats."""
    import torch

    import hifiasm_tpu_torch.phasing.hic as H
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.ops.banded_fwd import banded_forward
    from hifiasm_tpu_torch.ops.banded_tb import banded_tb
    from hifiasm_tpu_torch.utils import trace

    t0 = time.time()
    store, n_pat, opts = diploid_inputs(out_dir, genome_len, depth,
                                        read_len, 0.003, n_pairs, 0.003, 13)
    print(f"[diploid] {store.n_reads} reads ({n_pat} paternal), "
          f"{store.total_bases} bases, 2 x {n_pairs} Hi-C pairs, yak dumps "
          f"made in {time.time() - t0:.1f} s", flush=True)
    out = {}
    capture = None
    for mode, kw in (("hic", opts["hic"]), ("dip", opts["yak"])):
        pfx = os.path.join(out_dir, mode)
        run_store = _copy_store(store)     # EC corrects a store in place
        torch.cuda.reset_peak_memory_stats()
        trace.reset()
        banded_tb.launches = 0
        banded_forward.launches = 0
        t0 = time.time()
        with RescueCapture() as cap:
            res = assemble(run_store, HifiasmConfig(
                output_prefix=pfx, ignore_bin=True, **kw), device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        k1, k2 = banded_tb.launches, banded_forward.launches
        if k1 == 0:
            raise AssertionError(f"the {mode} run launched no K1 kernel")
        tot = [_gfa_total(f"{pfx}.{mode}.hap{h}.p_ctg.gfa") for h in (1, 2)]
        for h, t in zip((1, 2), tot):
            if not 0.5 * genome_len < t < 1.6 * genome_len:
                raise AssertionError(
                    f"{mode}.hap{h}.p_ctg totals {t} bp, not within "
                    f"(0.5, 1.6) x the {genome_len} bp haplotype")
        st = {"mode": mode, "wall_s": wall,
              "bases_per_s": store.total_bases / wall, "k1_launches": k1,
              "k2_launches": k2, "hap_p_ctg_bp": tot,
              "stage_s": dict(res.stage_s),
              "peak_device_bytes": torch.cuda.max_memory_allocated()}
        if mode == "hic":
            if k2 == 0:
                raise AssertionError("the hic run launched no K2 kernel in "
                                     "the Hi-C rescue")
            for h in (1, 2):
                p = f"{pfx}.hic.hap{h}.scaf.fa"
                if not os.path.exists(p) or os.path.getsize(p) == 0:
                    raise AssertionError(f"{p} is missing or empty")
            st["hic"] = dict(H.STATS)
            capture = cap.batch
            if capture is None:
                raise AssertionError(
                    "K2 launched but no rescue batch was captured: "
                    "phasing.hic no longer calls rescue_align through the "
                    "module global that RescueCapture replaces")
        else:
            with open(f"{pfx}.dip.hap1.p_ctg.gfa") as f:
                rids = [int(ln.split("\t")[4][1:]) for ln in f
                        if ln.startswith("A\t")]
            pat = sum(1 for r in rids if r < n_pat)
            st["hap1_reads"] = {"paternal": pat, "maternal": len(rids) - pat}
            if pat <= len(rids) - pat:
                raise AssertionError(f"dip.hap1 holds {pat} paternal and "
                                     f"{len(rids) - pat} maternal reads")
        print("[diploid] " + json.dumps(st), flush=True)
        out[mode] = st
    return out["hic"]["k2_launches"], capture, out


def _copy_store(store):
    """A fresh store of the same reads (EC rewrites a store in place)."""
    from hifiasm_tpu_torch.io.readstore import ReadStore

    return ReadStore.from_arrays(
        list(store.names), [store.get_codes(i).copy()
                            for i in range(store.n_reads)])


def _k2_shape(tag: str, batch, rows: int, launches: int, log: str) -> dict:
    """K2 on a captured batch (X, xl, Y, yl, e) with its rows cycled to
    ``rows``: bit-equal to its plain version on the card, both timed,
    with its bound from the function's work; a shape of K2's record.
    The comparison's launches are not counted."""
    import torch

    from hifiasm_tpu_torch.ops.banded_fwd import (
        banded_forward, banded_forward_torch,
    )

    X, xl, Y, yl, e = batch
    saved = banded_forward.launches
    idx = np.resize(np.arange(len(X)), rows)
    prob = (X[idx], xl[idx].astype(np.int32), Y[idx],
            yl[idx].astype(np.int32))
    args = [torch.as_tensor(np.ascontiguousarray(a)).cuda() for a in prob]
    got = banded_forward(*args, e)
    max_err = _equal(f"K2 ({tag}, e={e})", ("err", "y_end"),
                     (got.err, got.y_end), banded_forward_torch(*args, e))
    ms = _cuda_ms(lambda: banded_forward(*args, e), 5, 10)
    plain_ms = _cuda_ms(lambda: banded_forward_torch(*args, e), 3)
    banded_forward.launches = saved
    work = k2_bound(prob[0], prob[1], e)
    sh = _bound({"shape": tag, "e": e, "XL": int(X.shape[1]), "B": rows,
                 "launches": launches, "max_abs_err": max_err, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": None}, work)
    print(f"[{log}] {tag}: XL={X.shape[1]} e={e} B={rows}: "
          f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {sh['bound_ms']:.5f} ms ({sh['bound_by']}: "
          f"{json.dumps(work)})", flush=True)
    return sh


def phase_k2_rescue(batch, launches: int, rec: dict):
    """Phase 6b: K2 on the largest rescue batch that phase 6 sent it (e
    = 8), bit-equal to its plain version on the card, both timed, with
    its bound from the function's work; then the same rows tiled to
    the most a rescue call can hold (2 x 65,536), timed alike.  Both go
    into K2's record as shapes."""
    shapes = [_k2_shape("rescue", batch, len(batch[0]), launches,
                        "k2-rescue"),
              _k2_shape("rescue_tiled", batch, 2 * 65536, 0, "k2-rescue")]
    rec["shapes"] = [{"shape": "ec_windows", "e": 31, "XL": 775,
                      "B": K1_WINDOWS, "launches_own_path": 1,
                      **{k: rec[k] for k in ("max_abs_err", "ms",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}}
                     ] + shapes
    rec["launches"] = launches
    return rec


def phase_diploid_small(out_dir: str):
    """Phase 7: card against CPU for the new modes on a diploid store of
    the JAX tests' size (16 kb, Hi-C pairs, yak dumps and name lists):
    per device, a hic run with trio lists (hic.*, scaf.fa, bench.tsv)
    and a dip run resumed from its EC checkpoint; every output of both
    runs must be byte-identical between cuda and cpu."""
    import shutil as sh

    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.io.binfiles import checkpoint_paths

    store, _, opts = diploid_inputs(out_dir, 16000, 13, 2000, 0.002, 800,
                                    0.02, 11)
    runs = {}
    for dev in ("cuda", "cpu"):
        pa = os.path.join(out_dir, f"{dev}_hic")
        assemble(_copy_store(store), HifiasmConfig(
            output_prefix=pa, n_rounds_ec=1, ignore_bin=True,
            **opts["hic"], **opts["lists"]), device=dev)
        pb = os.path.join(out_dir, f"{dev}_dip")
        for src, dst in zip(checkpoint_paths(pa), checkpoint_paths(pb)):
            sh.copyfile(src, dst)
        assemble(_copy_store(store), HifiasmConfig(
            output_prefix=pb, n_rounds_ec=1, ignore_bin=False,
            **opts["yak"]), device=dev)
        runs[dev] = (pa, pb)
    n = 0
    for pa, pb in zip(runs["cuda"], runs["cpu"]):
        ta, tb = os.path.basename(pa), os.path.basename(pb)
        fa = sorted(f[len(ta):] for f in os.listdir(out_dir)
                    if f.startswith(ta + "."))
        fb = sorted(f[len(tb):] for f in os.listdir(out_dir)
                    if f.startswith(tb + "."))
        if fa != fb:
            raise AssertionError(f"{ta} and {tb} wrote different files")
        for suf in fa:
            with open(pa + suf, "rb") as a, open(pb + suf, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"{suf} differs between cuda "
                                         f"and cpu")
            n += 1
        for must in (".hic.hap1.scaf.fa", ".bench.tsv", ".hic.p_ctg.gfa") \
                if "hic" in ta else (".dip.hap1.p_ctg.gfa",):
            if must not in fa or os.path.getsize(pa + must) == 0:
                raise AssertionError(f"{ta}{must} missing or empty")
    print(f"[diploid-small] cuda and cpu: all {n} outputs of the hic "
          f"(+ trio lists) and dip runs byte-identical", flush=True)


def ont_ul_reads(rng, genome, depth: float, mean: int = 100_000,
                 lo: int = 50_000, hi: int = 200_000, err: float = 0.05):
    """ONT-like ultralong reads of ``genome`` to ``depth``: log-normal
    lengths with mean ``mean`` (sigma 0.5) clipped to [lo, hi], uniform
    starts, either strand, and ``err`` errors drawn in one vectorised
    pass per read: 40% run-stretching insertions (a base doubled), 30%
    deletions, 30% substitutions."""
    sigma = 0.5
    mu = np.log(mean) - sigma * sigma / 2
    reads, total = [], 0
    while total < depth * len(genome):
        n = int(np.clip(rng.lognormal(mu, sigma), lo, hi))
        p = int(rng.integers(0, len(genome) - n + 1))
        s = genome[p:p + n].copy()
        if rng.integers(0, 2):
            s = (3 - s[::-1]) & 3
        u = rng.random(n)
        sub = u < 0.3 * err
        s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) & 3
        rep = np.ones(n, np.int64)
        rep[(u >= 0.3 * err) & (u < 0.6 * err)] = 0
        rep[(u >= 0.6 * err) & (u < err)] = 2
        reads.append(np.repeat(s, rep).astype(np.uint8))
        total += n
    return reads


def _fasta(path, seqs):
    nt = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        f.writelines(f">u{i}\n{nt[s].tobytes().decode()}\n"
                     for i, s in enumerate(seqs))


class ULCapture:
    """Wraps ul._score_rows and ul.ul_band_err during a run: keeps the
    largest screen and junction batches (the K2 batches phase 8c
    replays) and counts the K2 launches made from each site."""

    def __init__(self):
        import hifiasm_tpu_torch.ul as U

        self.U, self.kind = U, None
        self.batch = {"screen": None, "junction": None}
        self.k2 = {"screen": 0, "junction": 0}

    def __enter__(self):
        from hifiasm_tpu_torch.ops.banded_fwd import banded_forward

        self.orig = score, band = self.U._score_rows, self.U.ul_band_err

        def score_rows(rows, e, device, kind):
            self.kind = kind
            return score(rows, e, device, kind)

        def band_err(X, xl, Y, yl, e, device="cuda"):
            b = self.batch[self.kind]
            if b is None or len(X) > len(b[0]):
                self.batch[self.kind] = (X.copy(), xl.copy(), Y.copy(),
                                         yl.copy(), e)
            n0 = banded_forward.launches
            out = band(X, xl, Y, yl, e, device)
            self.k2[self.kind] += banded_forward.launches - n0
            return out
        self.U._score_rows, self.U.ul_band_err = score_rows, band_err
        return self

    def __exit__(self, *exc):
        self.U._score_rows, self.U.ul_band_err = self.orig


def phase_ul(out_dir: str, genome_len: int, depth: float, read_len: int,
             ul_depth: float):
    """Phase 8: the UL mode on the card.  A genome with four copies of a
    segment longer than a HiFi read, HiFi reads and ONT-like UL reads
    (``ont_ul_reads``) in a FASTA passed as ``--ul``, assembled with
    ``device="cuda"`` and the default EC rounds.  Raises unless K1 ran,
    K2 ran in the UL screen at most once per mapping pass per 65,536
    rows, at least half of the UL reads mapped and bp.p_ctg.gfa totals
    0.8-1.3x the genome.  Then the HiFi reads alone, resumed from the UL
    run's EC checkpoint, for the contig count and N50 beside the UL
    run's (a report, not a gate).  Returns the capture and the stats."""
    import torch

    import hifiasm_tpu_torch.ul as U
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.io.binfiles import checkpoint_paths
    from hifiasm_tpu_torch.io.readstore import ReadStore
    from hifiasm_tpu_torch.ops.banded_fwd import banded_forward
    from hifiasm_tpu_torch.ops.banded_tb import banded_tb
    from hifiasm_tpu_torch.utils import trace

    synth = _synth()
    t0 = time.time()
    rng = np.random.default_rng(17)
    g = synth.make_genome(rng, genome_len, repeat_frac=0.04)
    reads, _, _ = synth.sample_reads(rng, g, depth=depth, read_len=read_len,
                                     err_rate=0.003)
    store = ReadStore.from_arrays([f"r{i}" for i in range(len(reads))],
                                  reads)
    uls = ont_ul_reads(rng, g, ul_depth)
    ulf = os.path.join(out_dir, "ul.fa")
    _fasta(ulf, uls)
    ul_bases = sum(len(u) for u in uls)
    print(f"[ul] {store.n_reads} HiFi reads, {store.total_bases} bases; "
          f"{len(uls)} UL reads, {ul_bases} bases (N50 "
          f"{_n50([len(u) for u in uls])}); genome {genome_len} made in "
          f"{time.time() - t0:.1f} s", flush=True)
    pfx = os.path.join(out_dir, "ul")
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    banded_tb.launches = 0
    banded_forward.launches = 0
    t0 = time.time()
    with ULCapture() as cap:
        res = assemble(store, HifiasmConfig(output_prefix=pfx,
                                            ignore_bin=True, ul_reads=[ulf]),
                       device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    k1, k2 = banded_tb.launches, banded_forward.launches
    st = dict(U.STATS)
    if k1 == 0:
        raise AssertionError("the UL run launched no K1 kernel")
    if cap.k2["screen"] == 0:
        raise AssertionError("ul_band_err launched no K2 kernel in the UL "
                             "screen")
    if st["screen_launches"] > st["passes"] + st["screen_rows"] // 65536:
        raise AssertionError(f"{st['screen_launches']} screen launches for "
                             f"{st['passes']} passes of "
                             f"{st['screen_rows']} rows")
    if cap.batch["screen"] is None or cap.batch["junction"] is None:
        raise AssertionError("no UL screen or junction batch was captured: "
                             "ul no longer scores through _score_rows and "
                             "ul_band_err")
    if 2 * st["mapped"] < st["reads"]:
        raise AssertionError(f"{st['mapped']} of {st['reads']} UL reads "
                             f"mapped (over {st['passes']} passes)")
    tot = _gfa_total(f"{pfx}.bp.p_ctg.gfa")
    if not 0.8 * genome_len <= tot <= 1.3 * genome_len:
        raise AssertionError(f"p_ctg totals {tot} bp, not within "
                             f"[0.8, 1.3] x the {genome_len} bp genome")
    lens = _contig_lens(f"{pfx}.p_ctg.fa")
    stats = {"hifi_bases": int(store.total_bases), "ul_bases": ul_bases,
             "ul_reads": len(uls), "wall_s": wall,
             "bases_per_s": store.total_bases / wall,
             "bases_per_s_with_ul": (store.total_bases + ul_bases) / wall,
             "contigs": len(lens), "n50": _n50(lens), "p_ctg_bp": tot,
             "stage_s": dict(res.stage_s), "ul": st,
             "k1_launches": k1, "k2_launches": k2,
             "k2_launches_by_site": dict(cap.k2),
             "peak_device_bytes": torch.cuda.max_memory_allocated()}
    print("[ul] " + json.dumps(stats), flush=True)

    pfx2 = os.path.join(out_dir, "noul")
    for src, dst in zip(checkpoint_paths(pfx), checkpoint_paths(pfx2)):
        shutil.copyfile(src, dst)
    t0 = time.time()
    assemble(ReadStore.from_arrays(["x"], [np.zeros(10, np.uint8)]),
             HifiasmConfig(output_prefix=pfx2, ignore_bin=False),
             device="cuda")
    lens2 = _contig_lens(f"{pfx2}.p_ctg.fa")
    print(f"[ul] contigs with --ul {len(lens)} (N50 {_n50(lens)}), without "
          f"--ul {len(lens2)} (N50 {_n50(lens2)}; resumed from the EC "
          f"checkpoint in {time.time() - t0:.1f} s)", flush=True)
    return cap, stats


def ul_scenarios(out_dir: str):
    """The UL end-to-end test scenarios (tests/test_torch_ul.py): a 20 kb
    genome spanned by three 5% error UL reads, and a 30 kb genome whose
    HiFi coverage has a 3 kb hole that three UL reads span.  Yields
    (name, names, reads, options)."""
    synth = _synth()
    for name in ("spanning", "gapfill"):
        rng = np.random.default_rng(11)
        if name == "spanning":
            g = synth.make_genome(rng, 20000)
            reads, _, _ = synth.sample_reads(rng, g, depth=12, read_len=2000,
                                             err_rate=0.002)
            uls = [synth.inject_errors(rng, g[1000:19000].copy(), 0.05)
                   for _ in range(3)]
        else:
            g = synth.make_genome(rng, 30000)
            reads = [r for part in (g[:14000], g[17000:])
                     for r in synth.sample_reads(rng, part, depth=14,
                                                 read_len=2500,
                                                 err_rate=0.002)[0]]
            uls = [g[10000:21000].copy() for _ in range(3)]
        f = os.path.join(out_dir, f"{name}_ul.fa")
        _fasta(f, uls)
        yield name, [f"r{i}" for i in range(len(reads))], reads, \
            {"ul_reads": [f], "ul_min_base": 1000}


def phase_ul_small(out_dir: str):
    """Phase 8b: the two UL scenarios assembled on cuda and on cpu (one
    EC round): every output byte-identical, K2 launched in each cuda
    run."""
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.io.readstore import ReadStore
    from hifiasm_tpu_torch.ops.banded_fwd import banded_forward

    n = 0
    for name, names, reads, kw in ul_scenarios(out_dir):
        pf = {}
        for dev in ("cuda", "cpu"):
            pf[dev] = os.path.join(out_dir, f"{name}_{dev}")
            n0 = banded_forward.launches
            assemble(ReadStore.from_arrays(names, [r.copy() for r in reads]),
                     HifiasmConfig(output_prefix=pf[dev], n_rounds_ec=1,
                                   ignore_bin=True, **kw), device=dev)
            if dev == "cuda" and banded_forward.launches == n0:
                raise AssertionError(f"the {name} UL run on cuda launched "
                                     "no K2 kernel")
        ta, tb = (os.path.basename(pf[d]) for d in ("cuda", "cpu"))
        fa = sorted(f[len(ta):] for f in os.listdir(out_dir)
                    if f.startswith(ta + "."))
        fb = sorted(f[len(tb):] for f in os.listdir(out_dir)
                    if f.startswith(tb + "."))
        if fa != fb or ".bp.p_ctg.gfa" not in fa:
            raise AssertionError(f"{ta} and {tb} wrote different files")
        for suf in fa:
            with open(pf["cuda"] + suf, "rb") as a, \
                    open(pf["cpu"] + suf, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"{name}: {suf} differs between "
                                         f"cuda and cpu")
            n += 1
    print(f"[ul-small] cuda and cpu: all {n} outputs of the two UL "
          f"scenarios byte-identical", flush=True)


def phase_k2_ul(cap, rec: dict):
    """Phase 8c: K2 on the largest UL screen batch (e = 15) and the
    largest junction batch of phase 8, each bit-equal to its plain
    version, timed and bounded, and the screen rows tiled to 131,072;
    added to K2's record as shapes with their launches on the UL path."""
    rec["shapes"] += [
        _k2_shape("ul_screen", cap.batch["screen"],
                  len(cap.batch["screen"][0]), cap.k2["screen"], "k2-ul"),
        _k2_shape("ul_screen_tiled", cap.batch["screen"], 2 * 65536, 0,
                  "k2-ul"),
        _k2_shape("ul_junction", cap.batch["junction"],
                  len(cap.batch["junction"][0]), cap.k2["junction"],
                  "k2-ul")]
    rec["launches_by_path"] = {"hic_rescue": rec["launches"],
                               "ul": sum(cap.k2.values())}
    rec["launches"] = sum(rec["launches_by_path"].values())
    return rec


# ---------------------------------------------------------------------------
# phase 10: the device index stages that no entry point calls yet

CHAIN_CELLS = 1 << 22       # [groups, N] cells a bucket's DP call may take
QUICK_BATCH = 256           # quick groups run through the DP a bucket


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _timed(dev, fn):
    """(result, host seconds) of fn(), synced on ``dev`` at the end."""
    _sync(dev)
    t0 = time.time()
    out = fn()
    _sync(dev)
    return out, time.time() - t0


def _same_mz(a, b, tag):
    """Raise unless two per-read minimizer lists are equal field by
    field."""
    if len(a) != len(b):
        raise AssertionError(f"{tag}: {len(a)} vs {len(b)} reads")
    for i, (x, y) in enumerate(zip(a, b)):
        for f in ("hash", "pos", "rev", "span", "cnt"):
            u, v = getattr(x, f), getattr(y, f)
            if u.dtype != v.dtype or not np.array_equal(u, v):
                raise AssertionError(f"{tag}: read {i} differs in {f}")


def _same_fields(a, b, fields, tag):
    for f in fields:
        u, v = getattr(a, f), getattr(b, f)
        if hasattr(u, "cpu"):
            u, v = u.cpu().numpy(), v.cpu().numpy()
        if u.dtype != v.dtype or not np.array_equal(u, v):
            raise AssertionError(f"{tag}: {f} differs")


def _same_anchors(a, b, tag):
    if len(a) != len(b):
        raise AssertionError(f"{tag}: {len(a)} vs {len(b)} reads")
    for i, (x, y) in enumerate(zip(a, b)):
        _same_fields(x, y, ("tid", "rev", "self_off", "t_off", "span",
                            "weight"), f"{tag}: read {i}")


def _chain_batches(mzs, table, lens, hom, params, dev):
    """The (read, tid, rev) groups of the device front end (its grouped
    gather and quick pass, as overlap/chain_device.py runs them), by
    bucket: the groups the front end sends to the host DP (not quick,
    at most 2,048 anchors), in group order up to CHAIN_CELLS cells a
    bucket, and the first QUICK_BATCH quick groups.  Returns
    {Nb: {"full": cols, "quick": cols, "nonquick_total": n}} with cols
    the host (so, to, span, w, n, xl, yl) arrays."""
    import torch

    from hifiasm_tpu_torch.index.pos_table_dev import (
        collect_anchor_groups_device,
    )
    from hifiasm_tpu_torch.ops.chain_batch import chain_quick_batch
    from hifiasm_tpu_torch.overlap.chain_device import (
        _BUCKETS, _SLAB_CELLS, gather_groups,
    )

    lens_d = torch.from_numpy(np.asarray(lens, np.int64)).to(dev)
    out = {Nb: {"full": [], "quick": [], "nonquick_total": 0}
           for Nb in _BUCKETS}
    for cols, meta in collect_anchor_groups_device(
            mzs, table, list(range(len(mzs))), lens, hom):
        if cols is None:
            continue
        gs_d = torch.from_numpy(meta["g_start"]).to(dev)
        sz_d = torch.from_numpy(meta["g_end"] - meta["g_start"]).to(dev)
        xl_d = lens_d[torch.from_numpy(meta["g_read"]).to(dev)]
        yl_d = lens_d[torch.from_numpy(meta["g_tid"]).to(dev)]
        sizes = meta["g_end"] - meta["g_start"]
        lo = 0
        for Nb in _BUCKETS:
            gids = np.flatnonzero((sizes > lo) & (sizes <= Nb))
            lo = Nb
            rec = out[Nb]
            slab = max(1, _SLAB_CELLS // Nb)
            for r0 in range(0, len(gids), slab):
                gi = torch.from_numpy(gids[r0:r0 + slab]).to(dev)
                so, to, sp, w = gather_groups(cols, gs_d, gi, sz_d[gi], Nb)
                _, _, quick = chain_quick_batch(
                    so, to, sp, w, sz_d[gi], xl_d[gi], yl_d[gi],
                    quick_check=params.quick_check, pg_q16=params.pg_q16,
                    pskip_q16=params.pskip_q16, bw_q16=params.bw_q16,
                    invbw_q4=params.invbw_q4)
                allc = (so, to, sp, w, sz_d[gi], xl_d[gi], yl_d[gi])
                nq = torch.nonzero(~quick).flatten()
                rec["nonquick_total"] += int(nq.numel())
                for key, rows, cap in (
                        ("full", nq, CHAIN_CELLS // Nb),
                        ("quick", torch.nonzero(quick).flatten(),
                         QUICK_BATCH)):
                    room = cap - sum(len(c[4]) for c in rec[key])
                    if room > 0 and rows.numel():
                        r = rows[:room]
                        rec[key].append(tuple(t[r].cpu().numpy()
                                              for t in allc))
    for rec in out.values():
        for key in ("full", "quick"):
            rec[key] = tuple(np.concatenate(c) for c in zip(*rec[key])) \
                if rec[key] else None
    return out


def _run_chains(cols, params, dev):
    """chain_exact_batch then extract_chains_batch on ``dev``; returns
    the host outputs and the two times."""
    from hifiasm_tpu_torch.ops.chain_dev import (
        chain_exact_batch, extract_chains_batch,
    )

    so, to, sp, w, n, xl, yl = cols
    (f, pre, quick), t_dp = _timed(dev, lambda: chain_exact_batch(
        so, to, sp, w, n, xl, yl, max_iter=params.max_iter,
        max_skip=params.max_skip, max_dis=params.max_dis,
        quick_check=params.quick_check, pg_q16=params.pg_q16,
        pskip_q16=params.pskip_q16, bw_q16=params.bw_q16,
        invbw_q4=params.invbw_q4, device=dev))
    ext, t_ex = _timed(dev, lambda: extract_chains_batch(
        f, pre, quick, so, to, n, xl, yl, mcopy_num=params.mcopy_num,
        mcopy_khit_cut=params.mcopy_khit_cut, mcopy_q16=params.mcopy_q16,
        device=dev))
    return ((f.cpu().numpy(), pre.cpu().numpy(), quick.cpu().numpy()),
            tuple(t.cpu().numpy() for t in ext), t_dp, t_ex)


def _check_chains(cols, dp, ext, params, tag):
    """Hold the device DP and extraction to the native DP
    (chain_dp_native) and the host extraction (extract_chains), group by
    group; returns (host DP seconds, host extraction seconds)."""
    from hifiasm_tpu_torch.native import chain_dp_native
    from hifiasm_tpu_torch.ops.chain import extract_chains

    so, to, sp, w, n, xl, yl = cols
    f, pre, quick = dp
    label, cnt, sc, _, _, nh = ext
    t_dp = t_ex = 0.0
    for b in range(len(n)):
        m = int(n[b])
        g = tuple(a[b, :m].astype(np.int64) for a in (so, to, sp, w))
        t0 = time.time()
        fr, prer, qr = chain_dp_native(*g, int(xl[b]), int(yl[b]), params)
        t1 = time.time()
        chains = extract_chains(fr, prer, g[0], g[1], int(xl[b]),
                                int(yl[b]), params, quick=qr)
        t_dp += t1 - t0
        t_ex += time.time() - t1
        if bool(quick[b]) != qr or not np.array_equal(f[b, :m], fr) or \
                not np.array_equal(pre[b, :m], prer):
            raise AssertionError(f"{tag}: group {b} (n {m}): the DP "
                                 "differs from chain_dp_native")
        if int(cnt[b]) != len(chains):
            raise AssertionError(f"{tag}: group {b}: {int(cnt[b])} chains "
                                 f"against the host's {len(chains)}")
        for k, (sck, idx) in enumerate(chains):
            if int(sc[b, k]) != sck or int(nh[b, k]) != len(idx) or \
                    not np.array_equal(np.flatnonzero(label[b, :m] == k),
                                       idx):
                raise AssertionError(f"{tag}: group {b} chain {k} differs "
                                     "from extract_chains")
    return t_dp, t_ex


def phase_index(genome_len: int, depth: float, read_len: int, err: float,
                dev="cuda"):
    """Phase 10: the five device index stages on phase 4's store and
    settings, each held to its host mirror and timed beside it: the
    device sketch (against the native sketch), the device table build
    (against the host build, peaks included; it must serve the grouped
    gather as the uploaded host table does), the per-read anchor gather
    (against collect_anchors_many), and the exact chain DP and
    extraction on the groups the front end sends to the host DP, plus a
    batch of quick groups a bucket (against chain_dp_native and
    extract_chains).  Returns the record of times and counts."""
    import torch

    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.index.pos_table import (
        build_filter_table, build_position_table,
    )
    from hifiasm_tpu_torch.index.pos_table_dev import (
        build_table_device, collect_anchor_groups_device,
        collect_anchors_device, device_table_from_host,
    )
    from hifiasm_tpu_torch.native import sketch_many_native
    from hifiasm_tpu_torch.ops.chain import ChainParams
    from hifiasm_tpu_torch.ops.sketch_dev import (
        default_rows, sketch_many_device,
    )
    from hifiasm_tpu_torch.overlap.anchors import collect_anchors_many

    t_all = time.time()
    store = _store(genome_len, depth, read_len, err, seed=11)
    codes = [store.get_codes(i) for i in range(store.n_reads)]
    cfg = HifiasmConfig()
    k, w = cfg.k, cfg.w
    ft, _, _ = build_filter_table(
        codes, k, high_factor=cfg.high_factor, max_kmer_cnt=cfg.max_kmer_cnt,
        min_hist_cnt=cfg.min_hist_kmer_cnt, bf_shift=cfg.bf_shift)
    keep_max = min(cfg.max_kmer_cnt, 4095)     # as ec/pipeline._index
    rec = {"reads": store.n_reads, "bases": int(store.total_bases),
           "k": k, "w": w, "filter_keys": len(ft)}
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # 10.1 sketch
    sketch_many_device(codes[:64], k, w, ft=ft, device=dev)   # warm-up
    mz_h, rec["sketch_host_s"] = _timed(
        dev, lambda: sketch_many_native(codes, k, w, ft))
    mz_d, rec["sketch_dev_s"] = _timed(
        dev, lambda: sketch_many_device(codes, k, w, ft=ft, device=dev))
    if torch.device(dev).type == "cuda":
        rec["sketch_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    _same_mz(mz_d, mz_h, "sketch")
    rec["sketch_rows_a_chunk"] = default_rows(max(map(len, codes)))
    rec["minimizers"] = int(sum(map(len, mz_d)))
    print(f"[index] sketch: {rec['minimizers']} minimizers of "
          f"{store.n_reads} reads equal to the native sketch; device "
          f"{rec['sketch_dev_s']:.3f} s ({rec['sketch_rows_a_chunk']} rows "
          f"a chunk), host {rec['sketch_host_s']:.3f} s", flush=True)

    # 10.2 table build
    it = iter(mz_h)
    (pt, ph, pht, _), rec["build_host_s"] = _timed(
        dev, lambda: build_position_table(
            codes, k, w, ft=ft, min_hist_cnt=cfg.min_hist_kmer_cnt,
            keep_max=keep_max, sketcher=lambda _c: next(it)))
    (tbl, dph, dpht), rec["build_dev_s"] = _timed(
        dev, lambda: build_table_device(
            mz_d, keep_max=keep_max, min_hist_cnt=cfg.min_hist_kmer_cnt,
            device=dev))
    _same_fields(tbl.to_host(), pt, ("hashes", "start", "count", "rid",
                                     "pos", "rev", "span"), "table")
    if (dph, dpht) != (ph, pht):
        raise AssertionError(f"peaks {(dph, dpht)} against the host's "
                             f"{(ph, pht)}")
    rec.update(keys=tbl.n_distinct, postings=tbl.tot_pos, peak_hom=ph,
               peak_het=pht)
    hom = ph if ph > 0 else cfg.hom_cov
    rids = list(range(store.n_reads))
    up = device_table_from_host(pt, dev)
    (ca, ma), (cb, mb) = (next(collect_anchor_groups_device(
        mz_d, t, rids, store.lens, hom)) for t in (tbl, up))
    for f in ("g_start", "g_end", "g_read", "g_tid", "g_rev"):
        if not np.array_equal(ma[f], mb[f]):
            raise AssertionError(f"grouped gather on the device-built "
                                 f"table: {f} differs")
    for f in ca:
        if not torch.equal(ca[f], cb[f]):
            raise AssertionError(f"grouped gather on the device-built "
                                 f"table: column {f} differs")
    rec["served_groups_first_chunk"] = len(ma["g_start"])
    del ca, cb, up
    print(f"[index] table: {tbl.n_distinct} keys, {tbl.tot_pos} postings "
          f"and peaks ({ph}, {pht}) equal to the host build; device "
          f"{rec['build_dev_s']:.3f} s, host {rec['build_host_s']:.3f} s; "
          f"serves {rec['served_groups_first_chunk']} groups of the first "
          f"chunk as the uploaded table does", flush=True)

    # 10.3 per-read anchors
    an_h, rec["anchors_host_s"] = _timed(
        dev, lambda: collect_anchors_many(mz_h, pt, rids, store.lens, hom))
    an_d, rec["anchors_dev_s"] = _timed(
        dev, lambda: collect_anchors_device(mz_d, tbl, rids, store.lens,
                                            hom))
    _same_anchors(an_d, an_h, "anchors")
    rec["anchors"] = int(sum(map(len, an_d)))
    del an_h, an_d
    print(f"[index] anchors: {rec['anchors']} equal to "
          f"collect_anchors_many; device {rec['anchors_dev_s']:.3f} s, "
          f"host {rec['anchors_host_s']:.3f} s", flush=True)

    # 10.4 exact chains
    params = ChainParams.for_k(k)
    batches = _chain_batches(mz_d, tbl, store.lens, hom, params, dev)
    rec["chains"] = {}
    for Nb, b in batches.items():
        r = {"N": Nb, "nonquick_groups": b["nonquick_total"]}
        for key in ("full", "quick"):
            cols = b[key]
            if cols is None:
                r[key] = None
                continue
            dp, ext, t_dp, t_ex = _run_chains(cols, params, dev)
            h_dp, h_ex = _check_chains(cols, dp, ext, params,
                                       f"chains N={Nb} {key}")
            B, nq = len(cols[4]), int(dp[2].sum())
            steps = int(cols[4][~dp[2]].max(initial=0))
            # the DP's traffic: ~40 int32 [B, N] planes a step, one step
            # an anchor of the longest group the quick pass leaves to it
            r[key] = {"groups": B, "max_n": int(cols[4].max()),
                      "quick": nq, "dp_s": t_dp, "extract_s": t_ex,
                      "host_dp_s": h_dp, "host_extract_s": h_ex,
                      "est_bytes": 160 * (B - nq) * Nb * steps}
        r["left_out_by_cap"] = b["nonquick_total"] - (
            r["full"]["groups"] if r["full"] else 0)
        rec["chains"][str(Nb)] = r
        print(f"[index] chains N={Nb}: " + json.dumps(r), flush=True)
    if torch.device(dev).type == "cuda":
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    rec["wall_s"] = time.time() - t_all
    return rec


def phase_index_small(dev_a="cuda", dev_b="cpu"):
    """Phase 10b: the five functions on phase 5's small store, on
    ``dev_a`` and on ``dev_b``: every output equal."""
    import torch

    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.index.pos_table import build_filter_table
    from hifiasm_tpu_torch.index.pos_table_dev import (
        build_table_device, collect_anchors_device,
    )
    from hifiasm_tpu_torch.ops.chain import ChainParams
    from hifiasm_tpu_torch.ops.sketch_dev import sketch_many_device

    store = _store(12000, 12, 1800, 0.004, seed=11)
    codes = [store.get_codes(i) for i in range(store.n_reads)]
    cfg = HifiasmConfig()
    k, w = cfg.k, cfg.w
    ft, _, _ = build_filter_table(codes, k, bf_shift=cfg.bf_shift)
    params = ChainParams.for_k(k)
    rids = list(range(store.n_reads))
    outs = {}
    for dev in (dev_a, dev_b):
        mzs = sketch_many_device(codes, k, w, ft=ft, device=dev,
                                 row_chunk=7)
        tbl, ph, pht = build_table_device(mzs, device=dev)
        hom = ph if ph > 0 else cfg.hom_cov
        an = collect_anchors_device(mzs, tbl, rids, store.lens, hom,
                                    chunk_mz=500)
        # every (read, tid, rev) group as one [B, N] batch
        groups = []
        for r, a in enumerate(an):
            cut = np.flatnonzero((np.diff(a.tid.astype(np.int64)) != 0) |
                                 (np.diff(a.rev) != 0)) + 1
            for s, e in zip(np.r_[0, cut], np.r_[cut, len(a)]):
                if e > s:
                    groups.append((r, a, s, e))
        N = max(e - s for _, _, s, e in groups)
        cols = [np.zeros((len(groups), N), np.int64) for _ in range(4)]
        n = np.zeros(len(groups), np.int64)
        xl = np.zeros(len(groups), np.int64)
        yl = np.zeros(len(groups), np.int64)
        for g, (r, a, s, e) in enumerate(groups):
            for c, f in zip(cols, ("self_off", "t_off", "span", "weight")):
                c[g, :e - s] = getattr(a, f)[s:e]
            n[g], xl[g], yl[g] = e - s, store.lens[r], store.lens[a.tid[s]]
        dp, ext, _, _ = _run_chains((*cols, n, xl, yl), params, dev)
        outs[dev] = (mzs, tbl.to_host(), (ph, pht), an, dp, ext)
    (ma, ta, pa, aa, da, ea), (mb, tb, pb, ab, db, eb) = \
        outs[dev_a], outs[dev_b]
    _same_mz(ma, mb, "10b sketch")
    _same_fields(ta, tb, ("hashes", "start", "count", "rid", "pos", "rev",
                          "span"), "10b table")
    if pa != pb:
        raise AssertionError(f"10b peaks {pa} against {pb}")
    _same_anchors(aa, ab, "10b anchors")
    for x, y, name in zip(da + ea, db + eb, ("f", "pre", "quick", "label",
                                             "cnt", "sc", "first", "last",
                                             "nh")):
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"10b chains: {name} differs")
    print(f"[index-small] {dev_a} and {dev_b}: sketch ({sum(map(len, ma))} "
          f"minimizers), table ({len(ta.hashes)} keys), anchors "
          f"({sum(map(len, aa))}), chains ({len(da[2])} groups, N "
          f"{da[0].shape[1]}, {int(da[2].sum())} quick) equal", flush=True)
    return {"reads": store.n_reads, "groups": int(len(da[2])),
            "N": int(da[0].shape[1]), "quick": int(da[2].sum())}


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


def phase_dag(out_dir: str) -> dict:
    """Phase 12: the host DAG pass from traceback columns gathered on the
    card, on ``proxy_store`` and ``ont_store`` (--ont): cuda with the
    native pass (a thread a CPU) and with the Python pass, against cpu
    (the native pass on one thread); returns each run's counters."""
    import hifiasm_tpu_torch.ec.device_ec as D
    import hifiasm_tpu_torch.ec.pipeline as P
    from hifiasm_tpu_torch import native
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.utils import trace

    out = {}
    ncpu = len(os.sched_getaffinity(0))
    runs = (("cuda", "cuda", ncpu, True), ("cuda_python", "cuda", ncpu, False),
            ("cpu", "cpu", 1, True))
    for name, make, kw in (("proxy", proxy_store, {}),
                           ("ont", ont_store,
                            {"is_ont": True, "bf_shift": 37})):
        reads, gfa = {}, {}
        for run, dev, threads, use_native in runs:
            pfx = os.path.join(out_dir, f"dag_{name}_{run}")
            trace.reset()
            t0 = time.time()
            dag_native = native.dag_reads_native
            if not use_native:
                native.dag_reads_native = lambda reads, threads: None
            try:
                res = assemble(make(), HifiasmConfig(
                    output_prefix=pfx, ignore_bin=True, mesh_devices=1,
                    threads=threads, n_rounds_ec=3, **kw), device=dev)
            finally:
                native.dag_reads_native = dag_native
            c = {k: P.STATS[k] for k in (
                "ec_rounds", "consensus_reads", "host_dag_reads",
                "host_dag_native_reads", "dag_clusters",
                "host_dag_fallback_reads", "host_dag_s", "consensus_s")}
            c.update({k: D.STATS[k] for k in (
                "dag_gather_windows", "dag_gather_bytes", "dag_gather_s")})
            c["threads"] = threads
            c["wall_s"] = time.time() - t0
            out[f"{name}_{run}"] = c
            print(f"[dag] {name} {run}: {json.dumps(c)}", flush=True)
            if c["host_dag_reads"] == 0 or c["dag_gather_windows"] == 0:
                raise AssertionError(f"{name} on {run}: no read took the "
                                     "host DAG pass")
            if c["host_dag_fallback_reads"]:
                raise AssertionError(f"{name} on {run}: reads on the host "
                                     "DAG pass without their columns")
            want = c["host_dag_reads"] if use_native else 0
            if c["host_dag_native_reads"] != want:
                raise AssertionError(
                    f"{name} on {run}: {c['host_dag_native_reads']} of "
                    f"{c['host_dag_reads']} DAG reads served natively, "
                    f"not {want}")
            reads[run] = [res.store.get_codes(i).tobytes()
                          for i in range(res.store.n_reads)]
            with open(f"{pfx}.bp.p_ctg.gfa", "rb") as f:
                gfa[run] = f.read()
        for run in ("cuda_python", "cpu"):
            if reads[run] != reads["cuda"]:
                raise AssertionError(f"{name}: the corrected reads differ "
                                     f"between cuda and {run}")
            if gfa[run] != gfa["cuda"] or not gfa["cuda"]:
                raise AssertionError(f"{name}: bp.p_ctg.gfa differs between "
                                     f"cuda and {run} (or is empty)")
        print(f"[dag] {name}: cuda (native), cuda (Python) and cpu "
              "corrected reads and bp.p_ctg.gfa byte-identical", flush=True)
    return out


def main(argv) -> int:
    import torch

    kernels_only = argv == ["--kernels"]
    mesh_only = argv == ["--mesh"]
    index_only = argv == ["--index"]
    ont_only = argv == ["--ont"]
    dag_only = argv == ["--dag"]
    if argv and not (kernels_only or mesh_only or index_only or ont_only
                     or dag_only):
        print("usage: chip_smoke.py [--kernels | --mesh | --index | --ont "
              "| --dag]", file=sys.stderr)
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
    out_dir = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    if index_only:
        index = phase_index(4_000_000, MAIN_DEPTH, 15000, 0.003)
        index["small"] = phase_index_small()
        print(f"[done] {time.time() - t_start:.1f} s", flush=True)
        print(json.dumps({"device_index": index}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if dag_only:
        dag = phase_dag(out_dir)
        shutil.rmtree(out_dir, ignore_errors=True)
        print(f"[done] {time.time() - t_start:.1f} s", flush=True)
        print(json.dumps({"dag": dag}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if ont_only:
        # 11. K1 and the vote kernel at XL = 375 on ONT windows; 11b. the
        # ONT mode cuda vs cpu, with its launches
        prob = k1_ont_windows(np.random.default_rng(9), K1_WINDOWS)
        stress = k1_stress(np.random.default_rng(10), K1_STRESS, 375, 31)
        rec, k1_out = phase_k1(prob, stress)
        rec_votes = phase_votes(k1_out, prob)
        del k1_out
        launches = phase_ont_small(out_dir)
        rec["launches"] = launches["banded_tb"]
        rec_votes["launches_by_path"] = {"ont": launches["vote_scatter"]}
        rec_votes["launches"] = sum(launches["vote_scatter"].values())
        shutil.rmtree(out_dir, ignore_errors=True)
        print(f"[done] {time.time() - t_start:.1f} s", flush=True)
        print(json.dumps({"kernels": [rec, rec_votes]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if mesh_only:
        phase_main(out_dir, 4_000_000, MAIN_DEPTH, 15000, 0.003)
        phase_mesh(out_dir, os.path.join(out_dir, "asm.bp.p_ctg.gfa"),
                   4_000_000, MAIN_DEPTH, 15000, 0.003)
        phase_mesh_small(out_dir)
        phase_dryrun()
        phase_profile(out_dir)
        shutil.rmtree(out_dir, ignore_errors=True)
        print(f"[done] {time.time() - t_start:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. K1 against its plain version at the production shape, then K2
    # on the same windows
    t0 = time.time()
    prob = k1_problems(np.random.default_rng(7), K1_WINDOWS, 775, 31)
    print(f"[k1] made {K1_WINDOWS} windows in {time.time() - t0:.1f} s",
          flush=True)
    stress = k1_stress(np.random.default_rng(8), K1_STRESS, 775, 31)
    rec, k1_out = phase_k1(prob, stress)
    rec_k2 = phase_k2(prob, k1_out)
    # 3c. the vote kernel on K1's tracebacks
    rec_votes = phase_votes(k1_out, prob)
    del k1_out
    if kernels_only:
        print(json.dumps({"kernels": [rec, rec_k2, rec_votes]}), flush=True)
        return 0

    # 4. the main path end to end on the card
    launches, _ = phase_main(out_dir, 4_000_000, MAIN_DEPTH, 15000, 0.003)
    # 5. card against plain end to end
    phase_small(out_dir)
    # 6. the diploid modes on the card, K2 in the Hi-C rescue
    k2_launches, batch, _ = phase_diploid(out_dir, 1_000_000, 15.0, 15000,
                                          50_000)
    # 6b. K2 at the rescue's shape
    phase_k2_rescue(batch, k2_launches, rec_k2)
    # 7. card against CPU for the new modes
    phase_diploid_small(out_dir)
    # 8. the UL mode on the card, K2 in the UL screen and junctions
    cap, _ = phase_ul(out_dir, 2_000_000, 20.0, 15000, 8.0)
    # 8b. card against CPU for UL
    phase_ul_small(out_dir)
    # 8c. K2 at the UL shapes
    phase_k2_ul(cap, rec_k2)
    # 9. the multi-device path at phase 4's size, against phase 4's contigs
    mesh_launches, _ = phase_mesh(
        out_dir, os.path.join(out_dir, "asm.bp.p_ctg.gfa"), 4_000_000,
        MAIN_DEPTH, 15000, 0.003)
    rec["launches_by_path"] = {"main": launches["banded_tb"],
                               "mesh": mesh_launches}
    rec["launches"] = sum(rec["launches_by_path"].values())
    rec_votes["launches_by_path"] = {"main": launches["vote_scatter"]}
    rec_votes["launches"] = sum(launches["vote_scatter"].values())
    # 9b-9d. mesh against cpu mesh and one card; the dryrun; --profile
    phase_mesh_small(out_dir)
    phase_dryrun()
    phase_profile(out_dir)
    # 10. the device index stages at phase 4's size; 10b card against CPU
    index = phase_index(4_000_000, MAIN_DEPTH, 15000, 0.003)
    index["small"] = phase_index_small()
    # 12. the host DAG pass from tracebacks gathered on the card
    dag = phase_dag(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)

    print(f"[done] {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"dag": dag}), flush=True)
    print(json.dumps({"device_index": index}), flush=True)
    print(json.dumps({"kernels": [rec, rec_k2, rec_votes]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
