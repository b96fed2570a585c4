"""Hi-C scaffolding: contig ordering and orientation (~horder.cpp).

Re-expresses ``ha_aware_order`` / ``init_horder_t`` (horder.cpp:4540,
:3926) as a weighted ORDER-GRAPH over contig ends (the ``osg_t`` of
horder.h:28):

- every PE hit votes for the contig END it lies nearer, with a weight
  normalized by the LOCAL contact density at its two positions
  (~``build_interval_idx``/``update_h_w``, horder.cpp:2763 — hits in
  repeat-enriched regions count less);
- each arc carries (w = normalized weight, occ = raw hit count, and
  nw = w / bestAlt where bestAlt is the strongest COMPETING arc at
  either end — the uniqueness margin of ``update_scg``; an arc whose
  weight merely ties its alternatives gets nw <= 1);
- layout (~``layout_scg`` horder.cpp:3738) accepts arcs in descending
  nw order only while nw > ``nw_thres`` (default 1.001) and
  occ > ``occ_thres`` — an end with two comparable suitors joins
  neither, which is what kills repeat/tangle-driven misjoins that raw
  greedy weight matching commits to.

``iterative_scaffold`` adds the reference's full loop (``scaffold_ug``
horder.cpp:3871 with round = 3): each round re-joins the current
scaffolds as super-contigs, then ``renew_scaffold`` (horder.cpp:3790)
repeatedly lifts the PE hits into scaffold coordinates and breaks
junctions whose spanning Hi-C support is far below the local average
span coverage (``break_scaffold``/``detect_lowNs`` horder.cpp:2275,
:2163 — cutoff band 5..15, local window 2.5 Mb) until a fixed point.
Broken junctions go on the AVOID list (``horder_t.avoid``,
horder.cpp:3628) so no later round re-commits them, and their ends
become available again for the next round's matching.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from hifiasm_tpu_torch.utils.logging import log


@dataclass
class Scaffold:
    members: List[Tuple[int, int]]     # (contig id, orientation 0 fwd)


def end_weights(n_ctg: int, ctg_lens: np.ndarray,
                pe_hits: List[Tuple[int, int, int, int]]
                ) -> Dict[Tuple[int, int], float]:
    """(end_a, end_b) -> weight; end = ctg << 1 | (0 head, 1 tail).

    A hit (u1, p1, u2, p2) votes for the ends nearest to p1/p2, weighted
    by proximity (near-end contacts are the informative ones)."""
    w: Dict[Tuple[int, int], float] = {}
    for u1, p1, u2, p2 in pe_hits:
        if u1 == u2 or u1 < 0 or u2 < 0:
            continue
        l1, l2 = int(ctg_lens[u1]), int(ctg_lens[u2])
        e1 = u1 << 1 | (0 if p1 < l1 - p1 else 1)
        e2 = u2 << 1 | (0 if p2 < l2 - p2 else 1)
        d1 = min(p1, l1 - p1) / max(l1, 1)
        d2 = min(p2, l2 - p2) / max(l2, 1)
        wt = (1.0 - d1) * (1.0 - d2)
        key = (min(e1, e2), max(e1, e2))
        w[key] = w.get(key, 0.0) + wt
    return w


DENS_BIN = 10_000          # contact-density bin (bp)


def contact_density(n_ctg: int, ctg_lens: np.ndarray,
                    hits: np.ndarray) -> Dict[int, np.ndarray]:
    """Per-contig binned INTRA-contig contact counts — the local density
    model of ``build_interval_idx`` (horder.cpp:2763 path): repeats
    attract excess Hi-C contacts, so inter-contig hits landing in dense
    bins are down-weighted."""
    dens: Dict[int, np.ndarray] = {}
    for c in range(n_ctg):
        dens[c] = np.zeros(max(int(ctg_lens[c]) // DENS_BIN + 1, 1),
                           np.int64)
    if len(hits) == 0:
        return dens
    intra = hits[hits[:, 0] == hits[:, 2]]
    for u, p1, _, p2 in intra:
        d = dens[int(u)]
        d[min(int(p1) // DENS_BIN, len(d) - 1)] += 1
        d[min(int(p2) // DENS_BIN, len(d) - 1)] += 1
    return dens


def order_graph_arcs(n_ctg: int, ctg_lens: np.ndarray, hits: np.ndarray,
                     dens: Dict[int, np.ndarray] | None = None,
                     ) -> Dict[Tuple[int, int], list]:
    """(end_a, end_b) -> [w, occ]: the osg arcs (~``update_scg``,
    horder.cpp:2763).  w sums density-normalized per-hit weights
    (``we += max_div / e.w``); occ counts raw hits (the ``p->occ``
    support filter of layout_scg)."""
    arcs: Dict[Tuple[int, int], list] = {}
    if len(hits) == 0:
        return arcs
    if dens is None:
        dens = contact_density(n_ctg, ctg_lens, hits)
    md = max((int(d.max()) for d in dens.values() if len(d)), default=0)
    max_div = float(max(md, 1))
    for u1, p1, u2, p2 in hits:
        u1, p1, u2, p2 = int(u1), int(p1), int(u2), int(p2)
        if u1 == u2 or u1 < 0 or u2 < 0:
            continue
        l1, l2 = int(ctg_lens[u1]), int(ctg_lens[u2])
        e1 = u1 << 1 | (0 if p1 < l1 - p1 else 1)
        e2 = u2 << 1 | (0 if p2 < l2 - p2 else 1)
        d1 = dens[u1][min(p1 // DENS_BIN, len(dens[u1]) - 1)]
        d2 = dens[u2][min(p2 // DENS_BIN, len(dens[u2]) - 1)]
        # proximity factor keeps the end-vote semantics; the density
        # divisor is the update_h_w normalization
        near = ((1.0 - min(p1, l1 - p1) / max(l1, 1)) *
                (1.0 - min(p2, l2 - p2) / max(l2, 1)))
        wt = near * max_div / float(d1 + d2 + 1)
        key = (min(e1, e2), max(e1, e2))
        a = arcs.get(key)
        if a is None:
            arcs[key] = [wt, 1]
        else:
            a[0] += wt
            a[1] += 1
    return arcs


def layout_order_graph(n_ctg: int, arcs: Dict[Tuple[int, int], list],
                       nw_thres: float = 1.001, occ_thres: int = 3,
                       min_weight: float = 0.0,
                       avoid: set | None = None,
                       end_map=None) -> List[Scaffold]:
    """~``layout_scg`` (horder.cpp:3738): compute each arc's normalized
    weight nw = w / bestAlt (bestAlt = strongest competing arc at either
    end; second-best when this arc IS the best — update_scg
    horder.cpp:2880), then match ends greedily in descending nw order,
    accepting only nw > nw_thres AND occ > occ_thres.  ``avoid`` holds
    end pairs (in ORIGINAL contig-end space via ``end_map``) that broke
    in an earlier round and must never re-join (horder_t.avoid)."""
    mw: Dict[int, float] = {}
    for (ea, eb), (w, _) in arcs.items():
        mw[ea] = max(mw.get(ea, 0.0), w)
        mw[eb] = max(mw.get(eb, 0.0), w)

    def _second(key: Tuple[int, int]) -> float:
        """Strongest arc at either of key's ends EXCLUDING key itself
        (~get_max_weight, horder.cpp): a near-tie competitor pushes
        nw -> 1 and the ambiguous end joins neither suitor."""
        ea, eb = key
        best = 0.0
        for (xa, xb), (aw, _) in arcs.items():
            if (xa, xb) == key:
                continue
            if xa in (ea, eb) or xb in (ea, eb):
                best = max(best, aw)
        return best

    scored = []
    for (ea, eb), (w, occ) in arcs.items():
        if occ <= occ_thres or w < min_weight:
            continue
        best_alt = max(mw.get(ea, 0.0), mw.get(eb, 0.0))
        if w >= best_alt * 0.95:          # this arc is the best: use the
            best_alt = _second((ea, eb))  # runner-up
        if best_alt == 0.0:
            best_alt = 1.0
        nw = w / best_alt
        scored.append((nw, w, ea, eb))
    scored.sort(key=lambda t: (-t[0], -t[1], t[2], t[3]))

    used_end = set()
    join: Dict[int, int] = {}
    for nw, w, ea, eb in scored:
        if nw <= nw_thres:
            break
        if ea in used_end or eb in used_end or (ea >> 1) == (eb >> 1):
            continue
        if avoid is not None and end_map is not None:
            oa, ob = end_map(ea), end_map(eb)
            if oa is not None and ob is not None and \
                    (min(oa, ob), max(oa, ob)) in avoid:
                continue
        if _same_chain(join, ea, eb):
            continue
        join[ea] = eb
        join[eb] = ea
        used_end.add(ea)
        used_end.add(eb)
    return _chains_from_join(n_ctg, join)


def _chains_from_join(n_ctg: int, join: Dict[int, int]) -> List[Scaffold]:
    """Walk the end-matching into scaffold chains (shared by greedy and
    order-graph layouts)."""
    seen = np.zeros(n_ctg, bool)
    scaffolds = []
    for c in range(n_ctg):
        if seen[c]:
            continue
        ctg, end_in = c, 0
        guard = 0
        while (ctg << 1 | end_in) in join and guard <= n_ctg:
            nxt = join[ctg << 1 | end_in]
            ctg, end_in = nxt >> 1, (nxt & 1) ^ 1
            guard += 1
        members = []
        cur, enter = ctg, end_in
        while True:
            seen[cur] = True
            members.append((cur, enter))
            out_end = cur << 1 | (enter ^ 1)
            if out_end not in join:
                break
            nxt = join[out_end]
            cur, enter = nxt >> 1, nxt & 1
            if seen[cur]:
                break
        scaffolds.append(Scaffold(members))
    return scaffolds


def greedy_scaffold(n_ctg: int, weights: Dict[Tuple[int, int], float],
                    min_weight: float = 2.0) -> List[Scaffold]:
    """Greedy maximum matching over contig ends -> scaffold chains."""
    used_end = set()
    join: Dict[int, int] = {}
    for (ea, eb), wt in sorted(weights.items(), key=lambda kv: -kv[1]):
        if wt < min_weight:
            break
        if ea in used_end or eb in used_end or (ea >> 1) == (eb >> 1):
            continue
        # cycle check: same scaffold already
        if _same_chain(join, ea, eb):
            continue
        join[ea] = eb
        join[eb] = ea
        used_end.add(ea)
        used_end.add(eb)
    scaffolds = _chains_from_join(n_ctg, join)
    log("greedy_scaffold",
        f"{n_ctg} contigs -> {len(scaffolds)} scaffolds")
    return scaffolds


def _same_chain(join: Dict[int, int], ea: int, eb: int) -> bool:
    """Would joining ea-eb close a cycle within an existing chain?"""
    # walk from ea's contig's other end along the chain looking for eb's ctg
    target = eb >> 1
    cur = (ea >> 1) << 1 | ((ea & 1) ^ 1)
    guard = 0
    while cur in join and guard < 100000:
        nxt = join[cur]
        if nxt >> 1 == target:
            return True
        cur = (nxt >> 1) << 1 | ((nxt & 1) ^ 1)
        guard += 1
    return False


def _lift_tables(scaffolds: List[Scaffold], ctg_lens: np.ndarray,
                 gap_len: int):
    """Per-contig (scaffold id, offset, orient, scaffold len) tables for
    lifting contig-space hit positions into scaffold space."""
    n_ctg = len(ctg_lens)
    scaf_of = np.full(n_ctg, -1, np.int64)
    off_of = np.zeros(n_ctg, np.int64)
    ori_of = np.zeros(n_ctg, np.int64)
    scaf_lens = np.zeros(len(scaffolds), np.int64)
    junctions: List[List[int]] = []       # per scaffold: junction positions
    for si, sc in enumerate(scaffolds):
        pos = 0
        juncs = []
        for i, (cid, enter) in enumerate(sc.members):
            scaf_of[cid] = si
            off_of[cid] = pos
            ori_of[cid] = enter
            pos += int(ctg_lens[cid])
            if i + 1 < len(sc.members):
                juncs.append(pos + gap_len // 2)
                pos += gap_len
        scaf_lens[si] = pos
        junctions.append(juncs)
    return scaf_of, off_of, ori_of, scaf_lens, junctions


def _lift_hits(hits: np.ndarray, ctg_lens: np.ndarray, scaf_of, off_of,
               ori_of):
    """hits [n,4] (u1,p1,u2,p2) contig-space -> (sid1, sp1, sid2, sp2)."""
    if len(hits) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    u1, p1, u2, p2 = (hits[:, 0].astype(np.int64),
                      hits[:, 1].astype(np.int64),
                      hits[:, 2].astype(np.int64),
                      hits[:, 3].astype(np.int64))
    sp1 = np.where(ori_of[u1] == 0, p1, ctg_lens[u1] - 1 - p1) + off_of[u1]
    sp2 = np.where(ori_of[u2] == 0, p2, ctg_lens[u2] - 1 - p2) + off_of[u2]
    return scaf_of[u1], sp1, scaf_of[u2], sp2


def break_weak_junctions(scaffolds: List[Scaffold], ctg_lens: np.ndarray,
                         hits: np.ndarray, gap_len: int = 100,
                         local_bound: int = 2_500_000,
                         cutoff: int = 5,
                         cut_pairs: list | None = None
                         ) -> Tuple[List[Scaffold], int]:
    """One ``break_scaffold`` pass (horder.cpp:2275): lift hits into
    scaffold coordinates; at every junction, compare the number of hits
    spanning the joint against the local average span-coverage depth in
    a ±``local_bound`` window (``detect_lowNs`` horder.cpp:2163).  A
    junction with spanning support <= cov_avg/``cutoff`` is cut.

    Returns (new scaffolds, number of junctions broken)."""
    scaf_of, off_of, ori_of, scaf_lens, junctions = _lift_tables(
        scaffolds, ctg_lens, gap_len)
    sid1, sp1, sid2, sp2 = _lift_hits(hits, ctg_lens, scaf_of, off_of,
                                      ori_of)
    intra = sid1 == sid2
    sid, lo = sid1[intra], np.minimum(sp1[intra], sp2[intra])
    hi = np.maximum(sp1[intra], sp2[intra]) + 1

    cut: List[Tuple[int, int]] = []       # (scaffold, member junction idx)
    for si, juncs in enumerate(junctions):
        if not juncs:
            continue
        m = sid == si
        s_lo, s_hi = lo[m], hi[m]
        for ji, jpos in enumerate(juncs):
            ws = max(jpos - local_bound, 0)
            we = min(jpos + local_bound, int(scaf_lens[si]))
            inw = (s_lo >= ws) & (s_hi <= we)
            if not inw.any():
                cut.append((si, ji))
                continue
            spans = s_hi[inw] - s_lo[inw]
            # local average depth = total span bases / covered interval
            ev = np.concatenate([np.stack([s_lo[inw],
                                           np.ones_like(s_lo[inw])], 1),
                                 np.stack([s_hi[inw],
                                           -np.ones_like(s_hi[inw])], 1)])
            ev = ev[np.lexsort((-ev[:, 1], ev[:, 0]))]
            depth = np.cumsum(ev[:, 1])
            seg = np.diff(ev[:, 0], append=ev[-1, 0])
            covered = int(seg[depth > 0].sum())
            cov_avg = float(spans.sum()) / max(covered, 1)
            spanning = int(((s_lo[inw] <= jpos - gap_len // 2) &
                            (s_hi[inw] >= jpos + gap_len // 2)).sum())
            if spanning <= cov_avg / cutoff:
                cut.append((si, ji))

    if not cut:
        return scaffolds, 0
    cutset = set(cut)
    out: List[Scaffold] = []
    for si, sc in enumerate(scaffolds):
        run: List[Tuple[int, int]] = []
        for i, mem in enumerate(sc.members):
            run.append(mem)
            if (si, i) in cutset:
                if cut_pairs is not None and i + 1 < len(sc.members):
                    # original-contig end pair of the broken junction
                    # (the horder_t.avoid record, horder.cpp:3628)
                    c1, o1 = mem
                    c2, o2 = sc.members[i + 1]
                    e1 = c1 << 1 | (o1 ^ 1)
                    e2 = c2 << 1 | o2
                    cut_pairs.append((min(e1, e2), max(e1, e2)))
                out.append(Scaffold(run))
                run = []
        if run:
            out.append(Scaffold(run))
    return out, len(cut)


def iterative_scaffold(n_ctg: int, ctg_lens: np.ndarray,
                       pe_hits: List[Tuple[int, int, int, int]],
                       rounds: int = 3, min_weight: float = 2.0,
                       gap_len: int = 100, local_bound: int = 2_500_000,
                       cutoff: int = 5,
                       prior: Dict[Tuple[int, int], float] | None = None,
                       nw_thres: float = 1.001, occ_thres: int = 2,
                       ) -> List[Scaffold]:
    """The full join/break loop of ``scaffold_ug`` (horder.cpp:3871,
    round = 3) over contig-space PE hits, with the weighted ORDER-GRAPH
    layout of ``update_scg``/``layout_scg``: arcs carry
    density-normalized weights and a best-vs-runner-up margin (nw), and
    broken junctions land on the avoid list so no later round
    re-commits them.

    ``prior`` adds end-pair weight bonuses in contig-end space — the
    hap-aware hook (~``ha_aware_order`` horder.cpp:4540, where the other
    haplotype's accepted layout informs this one through the trans
    index)."""
    ctg_lens = np.asarray(ctg_lens, np.int64)
    hits = (np.asarray(pe_hits, np.int64).reshape(-1, 4)
            if len(pe_hits) else np.zeros((0, 4), np.int64))
    valid = ((hits[:, 0] >= 0) & (hits[:, 2] >= 0) &
             (hits[:, 0] != hits[:, 2]) if len(hits) else
             np.zeros(0, bool))
    hits_inter = hits  # contig-space hits (inter + intra both kept)
    avoid: set = set()                 # broken ORIGINAL-ctg-end pairs
    scaffolds = [Scaffold([(c, 0)]) for c in range(n_ctg)]
    for _ in range(max(rounds, 1)):
        # ---- join: treat current scaffolds as super-contigs ----
        scaf_of, off_of, ori_of, scaf_lens, _ = _lift_tables(
            scaffolds, ctg_lens, gap_len)
        sid1, sp1, sid2, sp2 = _lift_hits(
            hits_inter[valid] if len(hits_inter) else hits_inter,
            ctg_lens, scaf_of, off_of, ori_of)
        sup_hits = np.stack([sid1, sp1, sid2, sp2], axis=1) \
            if len(sid1) else np.zeros((0, 4), np.int64)
        arcs = order_graph_arcs(len(scaffolds), scaf_lens, sup_hits)
        if prior:
            # lift contig-end priors to super-contig ends
            for (ea, eb), bonus in sorted(prior.items()):
                sa = _lift_end(ea, scaffolds, scaf_of, ori_of)
                sb = _lift_end(eb, scaffolds, scaf_of, ori_of)
                if sa is None or sb is None or (sa >> 1) == (sb >> 1):
                    continue
                key = (min(sa, sb), max(sa, sb))
                a = arcs.get(key)
                if a is None:
                    arcs[key] = [float(bonus), occ_thres + 1]
                else:
                    a[0] += bonus

        def _orig_end(sup_end: int):
            """Exposed original-contig end of a super-contig end."""
            mem = scaffolds[sup_end >> 1].members
            if sup_end & 1:
                c, o = mem[-1]
                return c << 1 | (o ^ 1)
            c, o = mem[0]
            return c << 1 | o

        sup_scafs = layout_order_graph(
            len(scaffolds), arcs, nw_thres=nw_thres,
            occ_thres=occ_thres, min_weight=min_weight, avoid=avoid,
            end_map=_orig_end)
        new: List[Scaffold] = []
        for ss in sup_scafs:
            members: List[Tuple[int, int]] = []
            for sup_id, enter in ss.members:
                mem = scaffolds[sup_id].members
                if enter == 0:
                    members.extend(mem)
                else:
                    members.extend((c, o ^ 1) for c, o in reversed(mem))
            new.append(Scaffold(members))
        scaffolds = new
        # ---- renew: break weak junctions to a fixed point ----
        while True:
            cut_pairs: list = []
            scaffolds, n_cut = break_weak_junctions(
                scaffolds, ctg_lens, hits_inter, gap_len=gap_len,
                local_bound=local_bound, cutoff=cutoff,
                cut_pairs=cut_pairs)
            if n_cut == 0:
                break
            avoid.update(cut_pairs)
            log("iterative_scaffold", f"broke {n_cut} weak junctions")
    log("iterative_scaffold",
        f"{n_ctg} contigs -> {len(scaffolds)} scaffolds "
        f"({rounds} rounds, {len(avoid)} avoided)")
    return scaffolds


def _lift_end(end: int, scaffolds: List[Scaffold], scaf_of, ori_of):
    """Contig end -> super-contig end, if the contig sits at a scaffold
    boundary with that end exposed (else the prior cannot apply)."""
    cid, side = end >> 1, end & 1
    si = int(scaf_of[cid])
    if si < 0:
        return None
    mem = scaffolds[si].members
    eff = side ^ int(ori_of[cid])         # side in scaffold orientation
    if mem[0][0] == cid and eff == 0:
        return si << 1
    if mem[-1][0] == cid and eff == 1:
        return si << 1 | 1
    return None


def scaffold_priors(accepted: List[Scaffold],
                    homolog: Dict[int, int],
                    bonus: float = 4.0) -> Dict[Tuple[int, int], float]:
    """Hap-aware transfer (~``ha_aware_order`` horder.cpp:4540): each
    adjacency accepted in one haplotype's layout votes for the
    homologous contig pair in the other haplotype (via the trans/purge
    pairing ``homolog``: this-hap ctg id -> other-hap ctg id)."""
    prior: Dict[Tuple[int, int], float] = {}
    for sc in accepted:
        for (c1, o1), (c2, o2) in zip(sc.members, sc.members[1:]):
            h1, h2 = homolog.get(c1), homolog.get(c2)
            if h1 is None or h2 is None or h1 == h2:
                continue
            e1 = h1 << 1 | (o1 ^ 1)       # outgoing end of c1's homolog
            e2 = h2 << 1 | o2             # incoming end of c2's homolog
            key = (min(e1, e2), max(e1, e2))
            prior[key] = prior.get(key, 0.0) + bonus
    return prior


def scaffold_seqs(scaffolds: List[Scaffold], ctg_seqs: List[np.ndarray],
                  gap_len: int = 100) -> List[np.ndarray]:
    """Concatenate member sequences with N gaps (scaffold FASTA)."""
    from hifiasm_tpu_torch.io.readstore import revcomp_codes

    out = []
    gap = np.full(gap_len, 4, np.uint8)
    for sc in scaffolds:
        parts = []
        for i, (cid, enter) in enumerate(sc.members):
            seq = ctg_seqs[cid]
            parts.append(seq if enter == 0 else revcomp_codes(seq))
            if i + 1 < len(sc.members):
                parts.append(gap)
        out.append(np.concatenate(parts) if parts else
                   np.zeros(0, np.uint8))
    return out
