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
3b. K2 (csrc/banded_fwd.cu) on the same windows through its entry point
   ``banded_forward``: bit-equal to its plain version and to K1's err
   and y_end; times of both, and its occupancy;
4. the main path end to end on the card: a synthetic 4 Mb genome, HiFi
   reads of 15 kb at 30x depth with 0.3% error (~120 Mb), the default
   3 EC rounds through ``assemble(..., device="cuda")``, whose EC rounds
   must take the device front end (anchors, quick chaining and t_ws on
   the card); the kernel launch counts are zeroed just before and read
   just after;
5. card against plain end to end: a small store assembled with
   device="cuda" (device front end on) and with device="cpu" and
   ``device_frontend=False`` gives byte-identical outputs;
6. the diploid modes on the card: a 2 x 2 Mb diploid (het rate 0.002),
   HiFi reads of 15 kb at 15x per haplotype with 0.3% error (~60 Mb),
   100,000 Hi-C pairs per haplotype (150 bp mates, 0.3% error) and yak
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
   cuda and on cpu: every output byte-identical.

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
        for k in H.STATS:
            H.STATS[k] = 0
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


def phase_k2_rescue(batch, launches: int, rec: dict):
    """Phase 6b: K2 on the largest rescue batch that phase 6 sent it (e
    = 8), bit-equal to its plain version on the card, both timed, with
    its bound from the function's work; then the same rows tiled to
    the most a rescue call can hold (2 x 65,536), timed alike.  Both go
    into K2's record as shapes."""
    import torch

    from hifiasm_tpu_torch.ops.banded_fwd import (
        banded_forward, banded_forward_torch,
    )

    X, xl, Y, yl, e = batch
    saved = banded_forward.launches
    shapes = []
    for tag, reps in (("rescue", 1), ("rescue_tiled", None)):
        idx = np.resize(np.arange(len(X)), len(X) * reps if reps else
                        2 * 65536)
        prob = (X[idx], xl[idx].astype(np.int32), Y[idx],
                yl[idx].astype(np.int32))
        args = [torch.as_tensor(np.ascontiguousarray(a)).cuda() for a in prob]
        got = banded_forward(*args, e)
        max_err = _equal(f"K2 ({tag}, e={e})", ("err", "y_end"),
                         (got.err, got.y_end),
                         banded_forward_torch(*args, e))
        ms = _cuda_ms(lambda: banded_forward(*args, e), 5, 10)
        plain_ms = _cuda_ms(lambda: banded_forward_torch(*args, e), 3)
        work = k2_bound(prob[0], prob[1], e)
        sh = _bound({"shape": tag, "e": e, "XL": int(X.shape[1]),
                     "B": len(idx),
                     "launches": launches if tag == "rescue" else 0,
                     "max_abs_err": max_err, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": None}, work)
        print(f"[k2-rescue] {tag}: XL={X.shape[1]} e={e} B={len(idx)}: "
              f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {sh['bound_ms']:.5f} ms ({sh['bound_by']}: "
              f"{json.dumps(work)})", flush=True)
        shapes.append(sh)
    banded_forward.launches = saved  # comparison launches do not count
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
    # 6. the diploid modes on the card, K2 in the Hi-C rescue
    k2_launches, batch, _ = phase_diploid(out_dir, 2_000_000, 15.0, 15000,
                                          100_000)
    # 6b. K2 at the rescue's shape
    phase_k2_rescue(batch, k2_launches, rec_k2)
    # 7. card against CPU for the new modes
    phase_diploid_small(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)

    print(f"[done] {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [rec, rec_k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
