"""Haplotype-partitioned output (the ``output_bp_graph`` /
``output_trio_graph_joint`` analog, Overlaps.cpp:17627, 23244).

Unitigs linked by inter-hap (trans) evidence are phased with the max-cut
spin solver (rcut.cpp mc_solve); spin +1 -> hap1, -1 -> hap2; unitigs with
no inter-hap partner are homozygous and join BOTH haplotypes (the "joint"
in output_trio_graph_joint).  With trio binning, read trio flags override
the solver per unitig (``set_trio_flag_by_cov``-style majority).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from hifiasm_tpu_torch.graph.purge import sym_link_edges, unitig_trans_links
from hifiasm_tpu_torch.graph.unitig import UnitigGraph
from hifiasm_tpu_torch.overlap.paf import PafStore
from hifiasm_tpu_torch.phasing.mc_solve import mc_solve
from hifiasm_tpu_torch.trio import AMBIGU, FATHER, MOTHER
from hifiasm_tpu_torch.utils.logging import log


def phase_unitigs(ug: UnitigGraph, rev_paf: PafStore, n_reads: int,
                  trio_flags: Optional[np.ndarray] = None,
                  n_perturb: int = 10000, f_perturb: float = 0.1,
                  seed: int = 11, min_link: int = 2,
                  hic_links: Optional[dict] = None,
                  trio_occ_thres: int = 60, trio_dual: bool = False
                  ) -> Tuple[List[int], List[int]]:
    """Returns (hap1_ids, hap2_ids); hom unitigs appear in both.

    ``trio_occ_thres`` (--t-occ): a unitig carrying more than this many
    unexpected opposite-haplotype reads is forcedly removed from both
    haplotypes regardless of topology (CommandLines.cpp:321).
    ``trio_dual`` (--trio-dual): strongly trans-linked (homologous)
    unitig pairs must land on opposite haplotypes; the member with the
    weaker parental majority is flipped when they agree."""
    n = len(ug.utgs)
    if n == 0:
        return [], []

    # trio path: majority vote of read flags per unitig
    use_trio = trio_flags is not None and \
        bool(((trio_flags == FATHER) | (trio_flags == MOTHER)).any())
    if use_trio:
        lab = np.zeros(n, np.int8)        # +1 pat, -1 mat, 0 hom/ambiguous
        margin = np.zeros(n, np.int64)
        forced = np.zeros(n, bool)
        for uid, u in enumerate(ug.utgs):
            fl = trio_flags[(u.vs >> 1).astype(np.int64)]
            n_p = int((fl == FATHER).sum())
            n_m = int((fl == MOTHER).sum())
            if min(n_p, n_m) > trio_occ_thres:
                forced[uid] = True        # --t-occ: mixed-hap unitig
                continue
            lab[uid] = np.sign(n_p - n_m)
            margin[uid] = abs(n_p - n_m)
        n_flip = 0
        if trio_dual:
            links = unitig_trans_links(ug, rev_paf, n_reads)
            edges = sym_link_edges(links)
            best = {}
            for (a, b), w in edges.items():
                if w > best.get(a, (0, -1))[0]:
                    best[a] = (w, b)
                if w > best.get(b, (0, -1))[0]:
                    best[b] = (w, a)
            for a in range(n):
                if lab[a] == 0 or forced[a] or a not in best:
                    continue
                w_ab, b = best[a]
                if w_ab < 2 * min_link or lab[b] != lab[a] or forced[b]:
                    continue
                # homologous pair on the same haplotype: flip the weaker
                w = a if margin[a] <= margin[b] else b
                lab[w] = -lab[w]
                n_flip += 1
        hap1 = [i for i in range(n) if not forced[i] and lab[i] >= 0]
        hap2 = [i for i in range(n) if not forced[i] and lab[i] <= 0]
        n_forced = int(forced.sum())
        log("phase_unitigs", f"trio: {len(hap1)} hap1 / {len(hap2)} hap2"
            + (f" ({n_forced} removed by --t-occ)" if n_forced else "")
            + (f" ({n_flip} flipped by --trio-dual)" if n_flip else ""))
        return hap1, hap2

    links = unitig_trans_links(ug, rev_paf, n_reads)
    # bubble-branch het pairs (~the bubble-chain priors of hic.h:33-54):
    # two branches of a simple/cross bubble are the same locus on
    # different haplotypes even when trans overlaps are too thin to say
    # so — inject them as strong trans evidence for the solver
    from hifiasm_tpu_torch.graph.bubble import identify_bubbles
    bc = identify_bubbles(ug)
    for a, b in bc.het_pairs():
        row = links.setdefault(a, {})
        row[b] = row.get(b, 0) + 2 * min_link
        row2 = links.setdefault(b, {})
        row2[a] = row2.get(a, 0) + 2 * min_link
    if hic_links is not None:
        # the n_weight renew->solve->label loop (hic.cpp:17082-17116)
        from hifiasm_tpu_torch.phasing.hic import (
            combine_phase_weights, hic_phase_loop,
        )
        ex, ey, _ = combine_phase_weights(links, hic_links,
                                          min_evidence=min_link)
        if len(ex) == 0:
            ids = list(range(n))
            return ids, list(ids)
        s = hic_phase_loop(n, links, hic_links, min_evidence=min_link,
                           n_perturb=n_perturb, f_perturb=f_perturb,
                           seed=seed)
        linked = np.zeros(n, bool)
        linked[np.asarray(ex, np.int64)] = True
        linked[np.asarray(ey, np.int64)] = True
        hap1 = [i for i in range(n) if not linked[i] or s[i] > 0]
        hap2 = [i for i in range(n) if not linked[i] or s[i] < 0]
        log("phase_unitigs", f"{len(hap1)} hap1 / {len(hap2)} hap2 "
            f"unitigs (hic loop, {int(linked.sum())} het-linked)")
        return hap1, hap2
    ex, ey, ew = [], [], []
    for (a, b), w in sorted(sym_link_edges(links).items()):
        if w >= min_link:
            ex.append(a)
            ey.append(b)
            ew.append(float(w))          # >0: different haplotypes
    if not ex:
        ids = list(range(n))
        return ids, list(ids)
    s = mc_solve(n, np.array(ex), np.array(ey), np.array(ew),
                 n_perturb=n_perturb, f_perturb=f_perturb, seed=seed)
    linked = np.zeros(n, bool)
    linked[np.array(ex)] = True
    linked[np.array(ey)] = True
    hap1 = [i for i in range(n) if not linked[i] or s[i] > 0]
    hap2 = [i for i in range(n) if not linked[i] or s[i] < 0]
    log("phase_unitigs", f"{len(hap1)} hap1 / {len(hap2)} hap2 unitigs "
        f"({int(linked.sum())} het-linked)")
    return hap1, hap2


def phase_unitigs_k(ug: UnitigGraph, rev_paf: PafStore, n_reads: int,
                    k_hap: int, n_perturb: int = 1000,
                    f_perturb: float = 0.1, seed: int = 11,
                    min_link: int = 2,
                    hic_links: Optional[dict] = None,
                    utg_seqs=None) -> List[List[int]]:
    """Polyploid phasing: k-label max-cut over the trans-link graph
    (~output_poly_trio + mc_solve_general, Overlaps.cpp:14682 /
    rcut.cpp:4586). Unlinked (hom) unitigs appear in every haplotype.

    With ``hic_links``, Hi-C contact weights fold into the edge weights
    (the polyploid Hi-C mode, ~hic_short_align_mmhap hic.cpp:17657:
    PE contacts drive the k-label partition).  With ``utg_seqs``,
    read-level trans links are SUPPLEMENTED by unitig minimizer-
    similarity overlaps gated by the graph-proximity filter — the
    ``pt_pdist``/``get_utg_ovlp`` channel the reference's polyploid
    labeling runs on (Overlaps.cpp:32566, tovlp.cpp:1922)."""
    from hifiasm_tpu_torch.phasing.mc_solve import mc_solve_k

    n = len(ug.utgs)
    if n == 0:
        return [[] for _ in range(k_hap)]
    links = unitig_trans_links(ug, rev_paf, n_reads)
    if utg_seqs is not None and 1 < n <= 256:   # O(n^2) sim pre-filter
        from hifiasm_tpu_torch.graph.tovlp import (
            drop_graph_close_pairs, unitig_similarity,
        )
        cand = {}
        for a in range(n):
            for b in range(a + 1, n):
                sim = unitig_similarity(utg_seqs[a], utg_seqs[b])
                if sim >= 0.35:          # ~purge_simi_thres ballpark
                    cand[(a, b)] = sim
        for (a, b), sim in sorted(
                drop_graph_close_pairs(ug, cand).items()):
            w = int(round(sim * 10))     # similarity-scaled trans weight
            links.setdefault(a, {})
            links[a][b] = links[a].get(b, 0) + w
    if hic_links:
        # trans overlaps push apart (w > 0), Hi-C cis contacts pull
        # together (w < 0) — the same signed weighting as the diploid
        # loop (combine_phase_weights ~hic.cpp:17082)
        from hifiasm_tpu_torch.phasing.hic import combine_phase_weights
        exa, eya, ewa = combine_phase_weights(links, hic_links,
                                              min_evidence=min_link)
        ex, ey, ew = list(exa), list(eya), list(ewa)
    else:
        ex, ey, ew = [], [], []
        for (a, b), w in sorted(sym_link_edges(links).items()):
            if w >= min_link:
                ex.append(a)
                ey.append(b)
                ew.append(float(w))
    if not ex:
        return [list(range(n)) for _ in range(k_hap)]
    lab = mc_solve_k(n, np.array(ex), np.array(ey), np.array(ew), k_hap,
                     n_perturb=n_perturb, f_perturb=f_perturb, seed=seed)
    linked = np.zeros(n, bool)
    linked[np.array(ex)] = True
    linked[np.array(ey)] = True
    out = [[i for i in range(n) if not linked[i] or lab[i] == h]
           for h in range(k_hap)]
    log("phase_unitigs_k",
        " / ".join(f"{len(g)} hap{h + 1}" for h, g in enumerate(out)))
    return out
