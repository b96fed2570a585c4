"""Bubble-chain identification + classification over the unitig graph.

Re-expresses ``identify_bubbles`` (hic.cpp:2354) and the bubble-chain
machinery of ``bubble_type`` (hic.h:33-54): superbubbles are detected
and classified (simple / full / broken / cross / tangle), consecutive
bubbles sharing endpoint unitigs form CHAINS, and the classification
feeds haplotype path selection — the two branches of a simple or cross
bubble are a het pair (same locus, different haplotype), the strongest
prior the reference's Hi-C phasing builds on (its chain_w weights).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from hifiasm_tpu_torch.graph.clean import _ug_adjacency, _ug_bubble
from hifiasm_tpu_torch.utils.logging import log


@dataclass
class Bubble:
    src: int                  # oriented source vertex (uid << 1 | end)
    sink: int                 # oriented sink vertex
    interior: List[int]       # interior unitig ids (sorted)
    cls: str                  # simple | full | broken | cross | tangle


@dataclass
class BubbleChains:
    bubbles: List[Bubble] = field(default_factory=list)
    bub_of: Dict[int, int] = field(default_factory=dict)  # uid -> bubble
    chains: List[List[int]] = field(default_factory=list)  # bubble ids

    def het_pairs(self) -> List[Tuple[int, int]]:
        """Unitig pairs that are two branches of one simple/cross
        bubble: same-locus different-haplotype evidence for phasing."""
        out = []
        for b in self.bubbles:
            if b.cls in ("simple", "cross") and len(b.interior) == 2:
                out.append((b.interior[0], b.interior[1]))
        return out


def _bounded_region(adj, v0: int, max_nodes: int):
    """Unitig set reachable from v0 before every walk dead-ends or the
    node bound trips; returns (uids, dead_ends, exits) or None when the
    walk cycles back into the source.  ``exits`` are frontier vertices
    OUTSIDE the bounded region (the walk continues past the bound into
    far vertices) — their presence distinguishes a tangle between chain
    ends (hic.h tangle_bub) from a broken bubble whose walks all
    dead-end inside the region."""
    seen = {v0}
    frontier = [v0]
    uids = set()
    dead = []
    exits = []
    while frontier:
        nxt = []
        for v in frontier:
            outs = adj.get(v, [])
            if not outs:
                dead.append(v)
                continue
            for w in outs:
                if (w >> 1) == (v0 >> 1):
                    return None            # cycles back into the source
                if w not in seen:
                    seen.add(w)
                    if len(uids) >= max_nodes:
                        exits.append(w)    # region stays open past the bound
                        continue
                    uids.add(w >> 1)
                    nxt.append(w)          # walk continues from w's arcs
        frontier = nxt
    return sorted(uids), dead, sorted(set(exits))


def identify_bubbles(ug, max_nodes: int = 24) -> BubbleChains:
    """Detect + classify bubbles and thread them into chains
    (~identify_bubbles, hic.cpp:2354; counters s_bub/f_bub/b_bub/
    tangle_bub/cross_bub of hic.h:33-54)."""
    adj = _ug_adjacency(ug)
    bc = BubbleChains()
    n_vtx = 2 * len(ug.utgs)
    seen_pairs = set()
    for v0 in range(n_vtx):
        got = _ug_bubble(adj, v0, max_nodes=max_nodes * 2)
        if got is not None:
            sink, interior = got
            uids = sorted({u >> 1 for u in interior})
            key = (min(v0, sink ^ 1), max(v0, sink ^ 1))
            if key in seen_pairs:
                continue
            seen_pairs.add(key)
            if len(uids) == 2 and len(interior) == 2:
                cls = "simple"
            elif _is_cross(adj, v0, sink, interior):
                cls = "cross"
            else:
                cls = "full"
            bid = len(bc.bubbles)
            bc.bubbles.append(Bubble(v0, sink, uids, cls))
            for u in uids:
                bc.bub_of.setdefault(u, bid)
            continue
        # no Kahn sink: a branching end opens a BROKEN bubble or tangle
        if len(adj.get(v0, [])) < 2:
            continue
        reg = _bounded_region(adj, v0, max_nodes)
        if reg is None:
            continue
        uids, dead, exits = reg
        if not uids:
            continue
        key = ("b", v0)
        if key in seen_pairs:
            continue
        seen_pairs.add(key)
        # every walk dead-ends inside the region: broken bubble
        # (b_bub/b_end_bub); walks continuing into far vertices past the
        # bound: tangle between chain ends (tangle_bub, hic.h:33-54)
        cls = "tangle" if exits else "broken"
        bid = len(bc.bubbles)
        bc.bubbles.append(Bubble(v0, -1, uids, cls))
        for u in uids:
            bc.bub_of.setdefault(u, bid)

    # thread chains: bubbles whose sink unitig is the next bubble's
    # source unitig (the b_ug walk of the reference)
    by_src: Dict[int, int] = {}
    for i, b in enumerate(bc.bubbles):
        if b.sink >= 0:
            by_src.setdefault(b.src >> 1, i)
    used = set()
    for i, b in enumerate(bc.bubbles):
        if i in used or b.sink < 0:
            continue
        chain = [i]
        used.add(i)
        cur = b
        while cur.sink >= 0:
            nxt = by_src.get(cur.sink >> 1)
            if nxt is None or nxt in used:
                break
            chain.append(nxt)
            used.add(nxt)
            cur = bc.bubbles[nxt]
        bc.chains.append(chain)
    n_cls: Dict[str, int] = {}
    for b in bc.bubbles:
        n_cls[b.cls] = n_cls.get(b.cls, 0) + 1
    log("identify_bubbles",
        f"{len(bc.bubbles)} bubbles ({n_cls}), {len(bc.chains)} chains")
    return bc


def _is_cross(adj, src: int, sink: int, interior) -> bool:
    """The cross/X motif (~cross_bub, hic.cpp:9477): two interior
    unitigs each entered from BOTH of two sources and exiting to BOTH of
    two sinks — haplotype branches crossing a shared junction."""
    uids = sorted({u >> 1 for u in interior})
    if len(uids) != 2:
        return False
    a, b = uids
    ins_a = {v for v in adj if any((w >> 1) == a for w in adj[v])}
    ins_b = {v for v in adj if any((w >> 1) == b for w in adj[v])}
    return len(ins_a & ins_b) >= 2


def bubble_phase_edges(bc: BubbleChains, weight: float = 8.0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Het-pair phasing edges from bubble branches: a positive
    (different-haplotype) weight between the two branches of every
    simple/cross bubble — the topology prior the reference's Hi-C path
    selection builds from its bubble chains (chain_w, hic.h:38)."""
    pairs = bc.het_pairs()
    ex = np.array([a for a, _ in pairs], np.int64)
    ey = np.array([b for _, b in pairs], np.int64)
    ew = np.full(len(pairs), float(weight), np.float64)
    return ex, ey, ew
