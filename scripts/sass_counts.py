#!/usr/bin/env python3
"""Count the instructions of one kernel in a `cuobjdump -sass` dump, by
basic block and by pipe: the source of the operation counts behind the
bounds of K1 and K2 in chip_smoke.py.

    python -m hifiasm_tpu_torch.ops.cuda_build DIR       # on the card
    python3 scripts/sass_counts.py DIR/banded_fwd.sass 'kernelILi31'
    python3 scripts/sass_counts.py DIR/banded_fwd.sass 'kernelILi31' \\
        --from 0x2b40 --to 0x3a00

The first form lists every basic block of the first function whose
mangled name holds the pattern: its address range, its instruction count
per class, and its shared- and global-memory operations.  The second sums
the blocks in an address range (start inclusive, end exclusive), such as
an unrolled loop body, for dividing by the rows it covers.  Classes: alu
(the integer ALU pipe: logic, shifts, adds, compares, selects, bit
scans), fma (IMAD and the other multiply-add forms), mem (loads and
stores), ctrl (branches, barriers, convergence), uni (the uniform
datapath, U*), other.
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import Counter

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)")
_TARGET = re.compile(r"\b(?:BRA|BSSY\s+B\d+,|CALL\.\w+)\s.*?(0x[0-9a-f]+)")

_CTRL = ("BRA", "BSSY", "BSYNC", "BAR", "EXIT", "RET", "CALL", "WARPSYNC",
         "NOP", "YIELD", "BMOV", "BPT", "JMP", "BREAK")
_MEM = ("LDS", "STS", "LDG", "STG", "LD", "ST", "ATOM", "ATOMS", "RED",
        "LDC", "LDL", "STL", "LDGSTS", "LDSM", "SHFL")
_FMA = ("IMAD", "IMUL", "FFMA", "FADD", "FMUL", "HFMA2", "IDP", "DFMA")


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("U") and base not in ("UFLO",):
        return "uni"
    if base in _CTRL:
        return "ctrl"
    if base in _MEM:
        return "mem"
    if base in _FMA:
        return "fma"
    if base in ("S2R", "S2UR", "CS2R", "R2UR", "UFLO", "VOTE", "MATCH"):
        return "other"
    return "alu"


def function(path: str, pattern: str):
    """[(address, opcode, text)] of the first function matching."""
    out, inside = [], False
    with open(path) as f:
        for ln in f:
            if "Function :" in ln:
                if inside:
                    break
                inside = pattern in ln
                continue
            if inside:
                m = _INS.search(ln)
                if m:
                    out.append((int(m.group(1), 16), m.group(3), ln))
    if not out:
        raise SystemExit(f"no function matching {pattern!r} in {path}")
    return out


def blocks(ins):
    """Split at branch targets and after control transfers."""
    starts = {ins[0][0]}
    for i, (a, op, text) in enumerate(ins):
        m = _TARGET.search(text)
        if m:
            starts.add(int(m.group(1), 16))
        if op.split(".")[0] in ("BRA", "EXIT", "BAR", "RET") and \
                i + 1 < len(ins):
            starts.add(ins[i + 1][0])
    cur, out = [], []
    for a, op, text in ins:
        if a in starts and cur:
            out.append(cur)
            cur = []
        cur.append((a, op, text))
    out.append(cur)
    return out


def summary(block) -> dict:
    c = Counter(classify(op) for _, op, _ in block)
    mem = Counter(op.split(".")[0] for _, op, _ in block
                  if classify(op) == "mem")
    return {"from": hex(block[0][0]), "to": hex(block[-1][0] + 16),
            **{k: c.get(k, 0) for k in ("alu", "fma", "mem", "ctrl", "uni",
                                         "other")},
            "memops": dict(mem)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sass")
    ap.add_argument("pattern")
    ap.add_argument("--from", dest="lo", type=lambda v: int(v, 16))
    ap.add_argument("--to", dest="hi", type=lambda v: int(v, 16))
    args = ap.parse_args()
    ins = function(args.sass, args.pattern)
    if args.lo is None:
        for b in blocks(ins):
            print(summary(b))
        return 0
    sel = [t for t in ins if args.lo <= t[0] < args.hi]
    print(summary(sel))
    return 0


if __name__ == "__main__":
    sys.exit(main())
