"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload CELL --seeds 1-12 \
        --variants program,ec_rounds_1 [--datasets seed] [--device cuda] \
        [--out FILE]

For each variant (``program``, or a name in ``faults.VARIANTS``) and
each seed, one assembly of the first input that a run of that seed
times, through the same call, and the numbers that ``correct`` compares,
one JSON line each (with ``edits``, the reads that kept an error and
how many); then, per variant, each number's least and greatest reading.
``--datasets seed`` draws each seed's genome and reads from the seed
itself instead of the traffic's ``dataset_seed``, so that the limits
hold on other datasets than the one the timed runs assemble.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import shutil
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.reference import check  # noqa: E402

NUMBERS = ("ec_edit_ppm", "ctg_err_ppm", "ctg_missed_pct", "phase_err_pct",
           "wall_s")


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def one(spec, cell, runner, seed: int, datasets: str) -> dict:
    """One assembly of the seed's first window input, and its numbers."""
    maker = harness.InputMaker(spec, cell, seed,
                               seed if datasets == "seed" else None)
    row = {}
    try:
        t0 = time.perf_counter()
        inp = maker.window(1)[0]
        row["make_s"] = time.perf_counter() - t0
        rec, store, prefix = runner.assemble(
            inp, os.path.join(maker.workdir, "a0"))
        row.update(wall_s=rec["wall_s"], bases=rec["bases"],
                   peak_bytes=rec["peak_bytes"])
        pairs = harness.ec_pairs(store, inp)
        edits = check.ec_edits(pairs)
        row["edits"] = {int(i): int(edits[i]) for i in edits.nonzero()[0]}
        row.update(check.numbers(inp.haps, pairs, runner.outputs(prefix),
                                 bool(cell.config.get("phased"))))
    except Exception:                          # a run that gives no number
        row["error"] = traceback.format_exc()[-2000:]
    finally:
        shutil.rmtree(maker.workdir, ignore_errors=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program")
    ap.add_argument("--datasets", choices=("traffic", "seed"),
                    default="traffic")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from hifiasm_tpu_torch.native import set_threads

    spec = harness.Spec(ROOT)
    cell = spec.cell(args.workload)
    if args.device == "cuda":
        from hifiasm_tpu_torch.ops import cuda_build
        cuda_build.load("banded_tb")
        cuda_build.load("banded_fwd")
    lines = []
    for variant in args.variants.split(","):
        runner = harness.Runner(cell, args.device,
                                None if variant == "program" else variant)
        set_threads(runner.threads())
        for seed in seeds_of(args.seeds):
            row = {"cell": args.workload, "variant": variant, "seed": seed,
                   "datasets": args.datasets,
                   **one(spec, cell, runner, seed, args.datasets)}
            print(json.dumps(row), flush=True)
            lines.append(row)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    for variant in args.variants.split(","):
        rows = [r for r in lines if r["variant"] == variant]
        summ = {"variant": variant, "runs": len(rows),
                "errors": sum("error" in r for r in rows)}
        for name in NUMBERS:
            vals = [r[name] for r in rows if name in r]
            if vals:
                summ[name] = [min(vals), max(vals)]
        print("summary " + json.dumps(summ), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
