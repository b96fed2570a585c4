"""Self-scaffolding via inter-haplotype homology (``--dual-scaf``).

Re-expresses ``gen_self_scaf`` (Overlaps.cpp:23209-23281): when two hap1
contigs A and B are homologous to the SAME hap2 contig C at successive
positions, C's continuity scaffolds the gap between A and B (and vice
versa).  Homology comes from the trans overlap records: a trans read link
(read r in A) <-> (read t in C) pins A to C at t's layout offset in C.

Emitted scaffolds honor the reference's gap cap (max 3 Mb,
CommandLines.cpp:358).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from hifiasm_tpu_torch.graph.unitig import UnitigGraph
from hifiasm_tpu_torch.overlap.paf import PafStore
from hifiasm_tpu_torch.phasing.horder import Scaffold
from hifiasm_tpu_torch.utils.logging import log

MAX_SELF_SCAF_GAP = 3_000_000


def read_layout_offsets(ug: UnitigGraph, n_reads: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """read -> (unitig id, layout offset), or (-1, -1)."""
    uid = np.full(n_reads, -1, np.int64)
    off = np.full(n_reads, -1, np.int64)
    for u_i, u in enumerate(ug.utgs):
        o = 0
        for k, v in enumerate(u.vs):
            rid = int(v) >> 1
            uid[rid] = u_i
            off[rid] = o
            o += int(u.node_len[k])
    return uid, off


def self_scaffold(ug: UnitigGraph, rev_paf: PafStore, n_reads: int,
                  hap1_ids: List[int], hap2_ids: List[int],
                  min_links: int = 2,
                  gap_max: int = MAX_SELF_SCAF_GAP) -> List[Scaffold]:
    """Order hap1 contigs along their homologous hap2 partners."""
    uid, off = read_layout_offsets(ug, n_reads)
    hap1 = set(hap1_ids)
    hap2 = set(hap2_ids)
    # anchor positions of each hap1 contig on each hap2 contig
    pos: Dict[Tuple[int, int], List[int]] = {}
    for rid in range(n_reads):
        ua = uid[rid]
        if ua < 0 or ua not in hap1:
            continue
        rec = rev_paf[rid]
        for t in rec.tn:
            ub = uid[int(t)]
            if ub >= 0 and ub in hap2 and ub != ua:
                pos.setdefault((int(ua), int(ub)), []).append(
                    int(off[int(t)]))
    # for each hap2 contig: order its hap1 partners by median anchor pos
    order_on: Dict[int, List[Tuple[float, int]]] = {}
    for (a, b), ps in pos.items():
        if len(ps) < min_links:
            continue
        order_on.setdefault(b, []).append((float(np.median(ps)), a))
    scaffolds: List[Scaffold] = []
    used = set()
    for b, partners in order_on.items():
        partners.sort()
        chain = [a for _, a in partners if a not in used]
        if len(chain) < 2:
            continue
        # gap check via anchor spacing on the hap2 partner
        ok_chain = [chain[0]]
        meds = {a: m for m, a in partners}
        for a in chain[1:]:
            if abs(meds[a] - meds[ok_chain[-1]]) <= gap_max:
                ok_chain.append(a)
        if len(ok_chain) >= 2:
            for a in ok_chain:
                used.add(a)
            scaffolds.append(Scaffold([(a, 0) for a in ok_chain]))
    for a in hap1_ids:
        if a not in used:
            scaffolds.append(Scaffold([(a, 0)]))
    n_joined = sum(1 for s in scaffolds if len(s.members) > 1)
    log("self_scaffold", f"{len(hap1_ids)} hap contigs -> "
        f"{len(scaffolds)} scaffolds ({n_joined} joined)")
    return scaffolds
