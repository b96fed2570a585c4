"""Run one cell of the benchmark of ``hifiasm_tpu_torch`` on the card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up (imports, the kernels' libraries, the inputs made from the seed,
one warm-up assembly) is timed from the start of this process.  The
last line of standard output is the result; the numbers compared with
their limits are the last lines of standard error.  A host without a
CUDA card, a checkout without the program, or a process that holds JAX
or the JAX package once the window has closed, ends with a non-zero
code and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "hifiasm_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    spec = importlib.util.find_spec("hifiasm_tpu_torch")
    if spec is None or not os.path.abspath(spec.origin).startswith(
            os.path.join(ROOT, "")):
        print("hifiasm_tpu_torch is not in this checkout "
              f"({ROOT}); nothing to measure", file=sys.stderr)
        return 2
    import torch

    from benchmark import harness

    cell = harness.Spec(ROOT).cell(args.workload)
    chips = int(cell.entry["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"the cell needs {chips} CUDA card(s); {found} found",
              file=sys.stderr)
        return 3
    out = harness.run(args.workload, args.seed % 2 ** 64, args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
