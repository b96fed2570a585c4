#!/usr/bin/env python3
"""Size the UL mapping's K2 batches on the CPU before a run on the card.

    python3 scripts/ul_rehearsal.py [GENOME_LEN] [UL_DEPTH]

Makes the genome of chip_smoke.py phase 8 (``make_genome``, repeat_frac
0.04, seed 17) at GENOME_LEN (default 500,000), cuts it into ten unitigs
joined in a chain, draws ONT-like UL reads to UL_DEPTH (default 8) with
chip_smoke.py ``ont_ul_reads``, and maps them with
``hifiasm_tpu_torch.ul.ul_align(..., hpc=True, device="cpu")``, K2's
plain version scoring every screen and junction row.  Prints the reads
made, the mapping's wall seconds on this host, ``ul.STATS`` (rows and
calls of each check) and the shape and e of the largest batch of each.
Host seconds here predict nothing about the card; the row and call
counts size the batches.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    import hifiasm_tpu_torch.ul as U
    from hifiasm_tpu_torch.graph.unitig import Unitig, UnitigGraph

    glen = int(argv[0]) if argv else 500_000
    depth = float(argv[1]) if len(argv) > 1 else 8.0
    rng = np.random.default_rng(17)
    g = C._synth().make_genome(rng, glen, repeat_frac=0.04)
    uls = C.ont_ul_reads(rng, g, depth)
    cuts = np.linspace(0, glen, 11).astype(np.int64)
    utgs = [g[a:b] for a, b in zip(cuts, cuts[1:])]
    src = [i << 1 for i in range(9)] + [((i + 1) << 1) | 1 for i in range(9)]
    dst = [(i + 1) << 1 for i in range(9)] + [(i << 1) | 1 for i in range(9)]
    ug = UnitigGraph(
        utgs=[Unitig(np.zeros(0, np.uint32), np.zeros(0, np.int64), len(u),
                     False, 0, 0) for u in utgs],
        a_src=np.array(src, np.uint32), a_dst=np.array(dst, np.uint32),
        a_ol=np.zeros(len(src), np.int64))
    t0 = time.time()
    with C.ULCapture() as cap:
        U.ul_align(utgs, uls, ug=ug, hpc=True, device="cpu")
    print(json.dumps({
        "genome": glen, "ul_reads": len(uls),
        "ul_bases": int(sum(len(u) for u in uls)),
        "host_s": time.time() - t0, "stats": U.STATS,
        "largest": {k: None if b is None else
                    {"B": len(b[0]), "XL": int(b[0].shape[1]), "e": b[4]}
                    for k, b in cap.batch.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
