"""Unitig-vs-unitig trans-overlap similarity (~tovlp.cpp).

``pt_cal_sim`` (tovlp.cpp:1743) recomputes inter-haplotype homology
directly between unitig sequences with a minimizer similarity — used to
confirm/weight purge and phasing candidates beyond the read-level trans
links.  Here: shared-canonical-k-mer Jaccard-style containment of the
smaller unitig in the larger one.
"""

from __future__ import annotations

from typing import List

import numpy as np

from hifiasm_tpu_torch.phasing.hic import _seq_kmers
from hifiasm_tpu_torch.utils.logging import log

TOVLP_K = 21


def unitig_similarity(a: np.ndarray, b: np.ndarray, k: int = TOVLP_K,
                      sample: int = 1) -> float:
    """Fraction of the SMALLER unitig's k-mers present in the other."""
    ka = np.unique(_seq_kmers(a, k))
    kb = np.unique(_seq_kmers(b, k))
    if len(ka) == 0 or len(kb) == 0:
        return 0.0
    if len(ka) > len(kb):
        ka, kb = kb, ka
    idx = np.minimum(np.searchsorted(kb, ka), len(kb) - 1)
    return float((kb[idx] == ka).mean())


HAP_ALIGN_K = 19
HAP_ALIGN_W = 10
HAP_WINDOW = 375                  # ~WINDOW (Hash_Table.h:9)
HAP_ERR_RATE = 0.06               # inter-hap divergence + HiFi residual


def hap_align_pair(a: np.ndarray, b: np.ndarray,
                   max_windows: int = 24):
    """Coordinate-level alignment of candidate haplotig ``a`` onto its
    partner ``b`` (~hap_alignment_advance_worker, Purge_Dups.cpp:5610):
    minimizer anchors -> chain DP -> window-sampled banded verification.

    Returns (aligned_frac_of_a, identity, (a_s, a_e, b_s, b_e, rev)) of
    the best chain, or (0.0, 0.0, None) when nothing chains.
    """
    from hifiasm_tpu_torch.index.pos_table import build_position_table
    from hifiasm_tpu_torch.ops.banded_batch import banded_batch_np
    from hifiasm_tpu_torch.ops.chain import ChainParams
    from hifiasm_tpu_torch.ops.sketch import sketch_read
    from hifiasm_tpu_torch.overlap.anchors import chain_many, collect_anchors

    pt, _, _, _ = build_position_table([b], HAP_ALIGN_K, HAP_ALIGN_W,
                                       ft=None, keep_min=1)
    tlens = np.array([len(b)], np.int64)
    mz = sketch_read(a, HAP_ALIGN_K, HAP_ALIGN_W, None)
    an = collect_anchors(mz, pt, 1, tlens, hom_cov=20)
    if len(an) == 0:
        return 0.0, 0.0, None
    cp = ChainParams.for_k(HAP_ALIGN_K, is_accurate=False, bw_rate=0.1)
    ovs = chain_many([(1, an, len(a))], tlens, cp, max_n_chain=50)
    ov = ovs[0]
    if len(ov) == 0:
        return 0.0, 0.0, None
    return _hap_eval_chains(a, b, ov, max_windows)


def _hap_eval_chains(a: np.ndarray, b: np.ndarray, ov,
                     max_windows: int = 24):
    """Coverage + identity evaluation of an already-chained candidate
    (shared by the per-pair and the batched confirmation paths)."""
    from hifiasm_tpu_torch.ops.banded_batch import banded_batch_np
    # union of chained a-intervals = aligned extent of a. Region extents
    # are projected to full-overlap ranges, so only credible chains
    # (enough hits/score) may contribute to coverage.
    cred = np.flatnonzero((ov.n_hits >= 4) &
                          (ov.score >= max(40, 0.02 * ov.score.max())))
    if len(cred) == 0:
        return 0.0, 0.0, None
    order = cred[np.argsort(ov.x_s[cred], kind="stable")]
    covered, last = 0, -1
    for o in order:
        s, e = int(ov.x_s[o]), int(ov.x_e[o])
        covered += max(0, e - max(s, last))
        last = max(last, e)
    frac = covered / max(len(a), 1)
    best = int(np.argmax(ov.score))
    span = (int(ov.x_s[best]), int(ov.x_e[best]),
            int(ov.y_s[best]), int(ov.y_e[best]), int(ov.rev[best]))

    # identity: banded alignment of windows sampled along the best chain
    from hifiasm_tpu_torch.io.readstore import revcomp_codes
    tgt = revcomp_codes(b) if span[4] else b
    hs = ov.hit_self[ov.hit_start[best]:ov.hit_start[best] + ov.n_hits[best]]
    ht = ov.hit_t[ov.hit_start[best]:ov.hit_start[best] + ov.n_hits[best]]
    n = len(hs)
    if n == 0:
        return frac, 0.0, span
    sel = np.unique(np.linspace(0, n - 1, min(max_windows, n))
                    .astype(np.int64))
    e_budget = max(4, int(HAP_WINDOW * HAP_ERR_RATE))
    xs, ys, xlens, ylens = [], [], [], []
    for h in sel:
        q0, t0 = int(hs[h]), int(ht[h])
        xw = a[q0:q0 + HAP_WINDOW]
        if len(xw) < 50:
            continue
        y0 = t0 - e_budget
        seg = np.full(len(xw) + 2 * e_budget, 4, np.uint8)
        s_lo, s_hi = max(0, y0), min(len(tgt), y0 + len(seg))
        if s_hi <= s_lo:
            continue
        seg[s_lo - y0:s_hi - y0] = tgt[s_lo:s_hi]
        xs.append(xw)
        ys.append(seg)
        xlens.append(len(xw))
        ylens.append(s_hi - y0)
    if not xs:
        return frac, 0.0, span
    XL = max(map(len, xs))
    YL = XL + 2 * e_budget
    xb = np.full((len(xs), XL), 4, np.uint8)
    yb = np.full((len(xs), YL), 4, np.uint8)
    for i, (xw, yw) in enumerate(zip(xs, ys)):
        xb[i, :len(xw)] = xw
        yb[i, :len(yw)] = yw
    out = banded_batch_np(xb, np.array(xlens), yb, np.array(ylens),
                          e_budget, traceback=False)
    ok = out.err >= 0
    if not ok.any():
        return frac, 0.0, span
    ident = 1.0 - float(out.err[ok].sum()) / max(
        int(np.array(xlens)[ok].sum()), 1)
    return frac, ident, span


def hap_align_pairs_batch(utg_seqs: List[np.ndarray], live_pairs,
                          max_windows: int = 24):
    """Batched ``hap_align_pair`` over ONE shared partner table.

    The per-pair form rebuilt a position table over the KEPT unitig for
    every candidate (~130 s/pair on multi-Mb unitigs at 455 Mb-diploid
    scale; 238 pairs = hours).  All partners index once; each purged
    unitig sketches once, anchors against the shared table, and chains
    only the anchors naming its own partner — the same chain/verify
    semantics per pair.  Returns {(a, b): (frac, ident, span)}."""
    from hifiasm_tpu_torch.index.pos_table import build_position_table
    from hifiasm_tpu_torch.ops.chain import ChainParams
    from hifiasm_tpu_torch.ops.sketch import sketch_read
    from hifiasm_tpu_torch.overlap.anchors import Anchors, chain_many, \
        collect_anchors

    partners = sorted({int(b) for _, b, _ in live_pairs})
    pidx = {b: i for i, b in enumerate(partners)}
    pt, _, _, _ = build_position_table(
        [utg_seqs[b] for b in partners], HAP_ALIGN_K, HAP_ALIGN_W,
        ft=None, keep_min=1)
    tlens = np.array([len(utg_seqs[b]) for b in partners], np.int64)
    n_t = len(partners)
    an_cache: dict = {}
    cp = ChainParams.for_k(HAP_ALIGN_K, is_accurate=False, bw_rate=0.1)
    out = {}
    for a, b, _frac in live_pairs:
        a, b = int(a), int(b)
        an = an_cache.get(a)
        if an is None:
            mz = sketch_read(utg_seqs[a], HAP_ALIGN_K, HAP_ALIGN_W,
                             None)
            an = an_cache[a] = collect_anchors(
                mz, pt, n_t, tlens, hom_cov=20)
        m = np.flatnonzero(an.tid == pidx[b])
        if len(m) == 0:
            out[(a, b)] = (0.0, 0.0, None)
            continue
        sub = Anchors(an.tid[m], an.rev[m], an.self_off[m],
                      an.t_off[m], an.span[m], an.weight[m])
        ovs = chain_many([(n_t, sub, len(utg_seqs[a]))], tlens, cp,
                         max_n_chain=50)
        ov = ovs[0]
        if len(ov) == 0:
            out[(a, b)] = (0.0, 0.0, None)
            continue
        out[(a, b)] = _hap_eval_chains(utg_seqs[a], utg_seqs[b], ov,
                                       max_windows)
    return out


def confirm_purge_pairs(utg_seqs: List[np.ndarray], pairs,
                        simi_rate: float, k: int = TOVLP_K,
                        min_identity: float = 0.85, ug=None):
    """Filter (purged, kept, frac) purge pairs by coordinate-level
    re-alignment (~hap_alignment_advance_worker, Purge_Dups.cpp:5610):
    the purged unitig must chain onto its partner over >= simi_rate of
    its length at haplotype-level identity. The k-mer similarity acts as
    a cheap pre-filter before the alignment.  With ``ug`` given, pairs
    that are graph-reachable within the query's length fail confirmation
    up front (~clean_mz_ovlp's pdist gate) — assembly-adjacent unitigs
    are one haplotype's continuation, not homologs."""
    live = pairs
    if ug is not None and pairs:
        keep = drop_graph_close_pairs(
            ug, {(a, b): frac for a, b, frac in pairs})
        live = [(a, b, frac) for a, b, frac in pairs if (a, b) in keep]
        if len(live) < len(pairs):
            log("confirm_purge_pairs",
                f"{len(pairs) - len(live)} pairs rejected as "
                f"graph-adjacent")
    pre = []
    for a, b, frac in live:
        sim = unitig_similarity(utg_seqs[a], utg_seqs[b], k)
        if sim < simi_rate * 0.25:     # clearly unrelated: skip alignment
            continue
        pre.append((a, b, frac))
    aligned = hap_align_pairs_batch(utg_seqs, pre) if pre else {}
    out = []
    for a, b, frac in pre:
        afrac, ident, span = aligned[(int(a), int(b))]
        if afrac >= simi_rate and ident >= min_identity:
            out.append((a, b, afrac, ident, span))
    log("confirm_purge_pairs",
        f"{len(out)}/{len(pairs)} purge pairs alignment-confirmed")
    return out


def drop_graph_close_pairs(ug, cand: dict) -> dict:
    """Drop trans-overlap candidates whose partner is graph-REACHABLE
    from the query unitig within the query's own length
    (~clean_mz_ovlp + set_utg_by_dis, tovlp.cpp:1793 / hic.cpp:3694):
    a pair connected by assembly arcs is one haplotype's continuation
    (an adjacent repeat), not a homolog pair.  The walk is directed on
    oriented unitig ends, so parallel bubble branches (true homologs)
    stay unreachable and are kept."""
    from hifiasm_tpu_torch.ul import _reach_starts, _utg_adj

    if not cand:
        return cand
    adj = _utg_adj(ug)
    lens = np.array([u.len for u in ug.utgs], np.int64)
    reach_cache: dict = {}

    def reached(a: int) -> set:
        got = reach_cache.get(a)
        if got is not None:
            return got
        cap = int(lens[a])
        got = set()
        for end in (a << 1, a << 1 | 1):
            for v, (ds, _) in _reach_starts(adj, lens, end, cap).items():
                got.add(v >> 1)
        got.discard(a)
        reach_cache[a] = got
        return got

    out = {}
    n_drop = 0
    for key in sorted(cand):
        a, b = key
        if b in reached(a) or a in reached(b):
            n_drop += 1
            continue
        out[key] = cand[key]
    if n_drop:
        log("drop_graph_close_pairs",
            f"dropped {n_drop} graph-adjacent trans pairs")
    return out
