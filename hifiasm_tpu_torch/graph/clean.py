"""String-graph cleaning passes.

Re-expresses the cleaning loop of ``clean_graph``/``ul_clean_gfa``
(Overlaps.cpp:39332, gfa_ut.cpp:3027-3127) for the HiFi path: per round
(default 4) with an overlap drop-ratio schedule 0.2 -> 0.8: cut short tips
(<= max_ext reads, ~asg_arc_cut_tips gfa_ut.cpp:3057), drop relatively-weak
overlaps at branch vertices (~asg_arc_cut_length), and pop small bubbles
(~asg_bub_pop1_primary_trio, Overlaps.h:1064 — the trio/coverage-aware path
selection arrives with the purge/trio subsystems; here the kept path is the
highest-coverage one).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from hifiasm_tpu_torch.graph.sg import StringGraph
from hifiasm_tpu_torch.utils.logging import log


def asg_cut_tips(g: StringGraph, max_ext: int,
                 protect: Optional[np.ndarray] = None) -> int:
    """Delete dead-end chains of <= max_ext reads. Returns #reads removed.

    ``protect``: boolean per-read mask (telomeric reads) that keeps the
    whole tip alive (~the uopt->te threading of gfa_ut.cpp:3059)."""
    n_removed = 0
    # vectorized tip-start detection: live vertices with no predecessors
    # (in-degree of v = live out-degree of v^1)
    u = g.arc_u().astype(np.int64)
    out_live = np.bincount(u[g.del_ == 0], minlength=2 * g.n_seq)
    live_v = np.repeat(g.seq_del == 0, 2)
    starts = np.flatnonzero(live_v &
                            (out_live[np.arange(2 * g.n_seq) ^ 1] == 0))
    for v0 in starts:
        v0 = int(v0)
        if g.seq_del[v0 >> 1]:
            continue              # removed earlier in this pass
        if len(g.arcs_of(v0 ^ 1)) != 0:
            continue
        # walk forward from the tip
        chain = [v0]
        v = v0
        ok_tip = False
        while len(chain) <= max_ext:
            ai = g.arcs_of(v)
            if len(ai) == 0:
                # isolated chain end; only cut if it merges nowhere (real tip
                # shorter than max_ext): treat as tip only when the chain
                # started mid-graph, keep isolated contigs alive
                ok_tip = False
                break
            if len(ai) > 1:
                ok_tip = True
                break
            w = int(g.v[ai[0]])
            if len(g.arcs_of(w ^ 1)) > 1:
                ok_tip = True  # merges into a through-path
                break
            chain.append(w)
            v = w
        if ok_tip and len(chain) <= max_ext:
            if protect is not None and any(protect[c >> 1] for c in chain):
                continue          # telomeric tip: never trim
            for c in chain:
                if not g.seq_del[c >> 1]:
                    g.seq_del[c >> 1] = 1
                    n_removed += 1
    if n_removed:
        g.cleanup()
    log("asg_cut_tips", f"removed {n_removed} tip reads")
    return n_removed


def asg_arc_del_short(g: StringGraph, drop_ratio: float) -> int:
    """Drop arcs whose overlap is much weaker than the best at the vertex
    (~asg_arc_del_short / asg_arc_cut_length). Keeps >= 1 arc per vertex.
    Vectorized: per-vertex max overlap via segment reduction."""
    n = 0
    if g.n_arcs:
        u = g.arc_u().astype(np.int64)
        w = g.v.astype(np.int64)
        live = g.del_ == 0
        out_live = np.bincount(u[live], minlength=2 * g.n_seq)
        best = np.zeros(2 * g.n_seq, np.int64)
        np.maximum.at(best, u[live], g.ol[live])
        thres = (best * drop_ratio).astype(np.int64)
        cand = live & (out_live[u] >= 2) & (g.ol < thres[u]) & \
            (out_live[w ^ 1] >= 2)
        n = int(cand.sum())
        if n:
            g.del_[cand] = 1
            g.symm_del()
            g.cleanup()
    log("asg_arc_del_short", f"dropped {n} weak arcs "
        f"(ratio {drop_ratio:.2f})")
    return n


def asg_pop_bubble(g: StringGraph, max_dist: int,
                   read_cov: Optional[np.ndarray] = None,
                   avoid: Optional[np.ndarray] = None) -> int:
    """Pop simple bubbles/superbubbles within max_dist (miniasm-style
    asg_bub_pop1). Keeps the highest-coverage path; deletes the rest.

    ``avoid``: per-read bool mask the kept path must stay clear of when an
    alternative exists — the trio-aware path selection of
    ``asg_bub_pop1_primary_trio`` (Overlaps.h:1064), where the popped side
    is the one carrying the wrong-haplotype reads."""
    n_pop = 0
    alen = g.arc_len()
    u = g.arc_u().astype(np.int64)
    out_live = np.bincount(u[g.del_ == 0], minlength=2 * g.n_seq)
    starts = np.flatnonzero(np.repeat(g.seq_del == 0, 2) & (out_live >= 2))
    for v0 in starts:
        v0 = int(v0)
        if g.seq_del[v0 >> 1]:
            continue              # popped earlier in this pass
        if len(g.arcs_of(v0)) < 2:
            continue
        result = _bub_finder(g, v0, max_dist, alen, read_cov, avoid)
        if result is None:
            continue
        inside, path = result
        keep_rids = {w >> 1 for w in path} | {v0 >> 1}
        changed = False
        for w in inside:
            rid = w >> 1
            if rid not in keep_rids and not g.seq_del[rid]:
                g.seq_del[rid] = 1
                changed = True
        if changed:
            n_pop += 1
            g.cleanup()
            alen = g.arc_len()     # cleanup() compacted the arc arrays
    log("asg_pop_bubble", f"popped {n_pop} bubbles")
    return n_pop


def _bub_finder(g: StringGraph, v0: int, max_dist: int, alen, read_cov,
                avoid: Optional[np.ndarray] = None):
    """Kahn-style superbubble detection from v0 (the asg_bub_pop1 scheme);
    returns (inside_vertices, best_path_vertices incl. sink) or None.
    ``avoid``-flagged reads carry a large negative score so the kept path
    takes the other side when one exists (trio-aware popping)."""
    dist = {v0: 0}
    score = {v0: 0}
    parent = {}
    remaining = {}
    stack = [v0]
    inside = []
    n_pending = 0
    sink = None
    while stack:
        v = stack.pop()
        ai = g.arcs_of(v)
        if len(ai) == 0:
            return None  # tip inside the candidate bubble
        for a in ai:
            w = int(g.v[a])
            if (w >> 1) == (v0 >> 1):
                return None  # loops back through the source read
            d = dist[v] + int(alen[a])
            if d > max_dist:
                return None
            cov_w = int(read_cov[w >> 1]) if read_cov is not None else \
                int(g.ol[a])
            if avoid is not None and avoid[w >> 1]:
                cov_w -= 1 << 30       # wrong-hap read: never the kept path
            sc = score[v] + cov_w
            if w not in dist:
                dist[w] = d
                score[w] = sc
                parent[w] = v
                remaining[w] = len(g.arcs_of(w ^ 1))
                inside.append(w)
                n_pending += 1
                if len(inside) > 512:
                    return None
            else:
                if d > dist[w]:
                    dist[w] = d
                if sc > score[w]:
                    score[w] = sc
                    parent[w] = v
            remaining[w] -= 1
            if remaining[w] == 0:
                stack.append(w)
                n_pending -= 1
        if len(stack) == 1 and n_pending == 0:
            sink = stack[0]
            break
    if sink is None or sink == v0 or len(inside) < 2:
        return None
    path = []
    w = sink
    while w != v0:
        path.append(w)
        w = parent[w]
    return inside, path


def asg_arc_cut_inexact(g: StringGraph) -> int:
    """Drop inexact arcs at branch vertices that compete with an exact
    alternative (~asg_arc_cut_inexact, gfa_ut.cpp:3057-3127): an arc whose
    overlap alignment had errors (el == 0) loses to a coexisting exact
    (el == 1) arc unless it is the stronger overlap."""
    if g.n_arcs == 0:
        log("asg_arc_cut_inexact", "dropped 0 inexact arcs")
        return 0
    u = g.arc_u().astype(np.int64)
    w = g.v.astype(np.int64)
    live = g.del_ == 0
    out_live = np.bincount(u[live], minlength=2 * g.n_seq)
    best_ex = np.full(2 * g.n_seq, -1, np.int64)
    sel = live & (g.el == 1)
    np.maximum.at(best_ex, u[sel], g.ol[sel])
    cand = live & (g.el == 0) & (g.ol < best_ex[u]) & \
        (out_live[u] >= 2) & (out_live[w ^ 1] >= 2)
    n = int(cand.sum())
    if n:
        g.del_[cand] = 1
        g.symm_del()
        g.cleanup()
    log("asg_arc_cut_inexact", f"dropped {n} inexact arcs")
    return n


def snapshot_arcs(g: StringGraph):
    """Copy the arc table before cleaning (for post_rescue)."""
    return {f: getattr(g, f).copy()
            for f in ("ul", "v", "ol", "strong", "el", "no_l_indel")}


def post_rescue(g: StringGraph, snap) -> int:
    """Re-add the strongest pre-cleaning arc at dead ends the cleaning
    rounds created (~post_rescue, gfa_ut.cpp:3186): a live read end with
    no successors gets its best original arc back when the target read is
    still alive — over-aggressive drops must not break contigs."""
    su = (snap["ul"] >> np.uint64(32)).astype(np.int64)
    skey = (su.astype(np.uint64) << np.uint64(32)) | \
        snap["v"].astype(np.uint64)
    sorder = np.argsort(skey)
    skey_s = skey[sorder]
    su_s = su[sorder]
    u_now = g.arc_u().astype(np.int64)
    have = set(zip(u_now.tolist(), g.v.astype(np.int64).tolist()))
    out_live = np.bincount(u_now[g.del_ == 0], minlength=2 * g.n_seq)
    dead_ends = np.flatnonzero(np.repeat(g.seq_del == 0, 2) &
                               (out_live == 0))
    add_idx = []
    for v in dead_ends:
        v = int(v)
        lo = int(np.searchsorted(su_s, v))
        hi = int(np.searchsorted(su_s, v + 1))
        cand = sorder[lo:hi]
        cand = [c for c in cand
                if not g.seq_del[int(snap["v"][c]) >> 1]
                and (v, int(snap["v"][c])) not in have]
        if not cand:
            continue
        best = max(cand, key=lambda c: int(snap["ol"][c]))
        # complement arc from the snapshot
        w = int(snap["v"][best])
        ckey = np.uint64(((w ^ 1) << 32) | (v ^ 1))
        p = int(np.searchsorted(skey_s, ckey))
        if p >= len(skey_s) or skey_s[p] != ckey:
            continue
        add_idx.extend([int(best), int(sorder[p])])
        have.add((v, w))
        have.add((w ^ 1, v ^ 1))
    if not add_idx:
        log("post_rescue", "rescued 0 arcs")
        return 0
    idx = np.array(sorted(set(add_idx)), np.int64)
    g.set_arcs(np.concatenate([g.ul, snap["ul"][idx]]),
               np.concatenate([g.v, snap["v"][idx]]),
               np.concatenate([g.ol, snap["ol"][idx]]),
               np.concatenate([g.strong, snap["strong"][idx]]),
               np.concatenate([g.el, snap["el"][idx]]),
               np.concatenate([g.no_l_indel, snap["no_l_indel"][idx]]))
    log("post_rescue", f"rescued {len(idx)} arcs at dead ends")
    return len(idx)


# ---------------------------------------------------------------------------
# round-2 parity pack: bubble protection, arc-level chimeric cuts, bubble-
# link cuts, large-indel cuts, semi-circles, dead-end tip extension
# (~gfa_ut.cpp ul_clean_gfa pipeline, :3027-3256)
# ---------------------------------------------------------------------------


def bubble_protect(g: StringGraph, max_dist: int,
                   read_cov: Optional[np.ndarray] = None) -> np.ndarray:
    """Vertices inside simple bubbles -> protected from the cut passes
    (~asg_arc_identify_simple_bubbles_multi filling seq_vis,
    Overlaps.cpp:4690).  Returns a bool mask over 2*n_seq vertices."""
    vis = np.zeros(2 * g.n_seq, bool)
    if g.n_arcs == 0:
        return vis
    alen = g.arc_len()
    u = g.arc_u().astype(np.int64)
    out_live = np.bincount(u[g.del_ == 0], minlength=2 * g.n_seq)
    starts = np.flatnonzero(np.repeat(g.seq_del == 0, 2) & (out_live >= 2))
    for v0 in starts:
        v0 = int(v0)
        res = _bub_finder(g, v0, max_dist, alen, read_cov)
        if res is None:
            continue
        inside, _ = res
        vis[v0] = vis[v0 ^ 1] = True
        for w in inside:
            vis[w] = vis[w ^ 1] = True
    return vis


def _branch_vertices(g: StringGraph, vis: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """Live vertices with >= 2 live out-arcs (vectorized prefilter)."""
    if g.n_arcs == 0:
        return np.zeros(0, np.int64)
    u = g.arc_u().astype(np.int64)
    out_live = np.bincount(u[g.del_ == 0], minlength=2 * g.n_seq)
    m = (out_live >= 2) & np.repeat(g.seq_del == 0, 2)
    if vis is not None:
        m &= ~vis
    return np.flatnonzero(m)


def _find_arc(g: StringGraph, s: int, d: int) -> int:
    for ai in range(int(g.idx_s[s]), int(g.idx_s[s] + g.idx_n[s])):
        if int(g.v[ai]) == d:
            return ai
    return -1


def _del_arc_pair(g: StringGraph, ai: int) -> None:
    """Delete one arc and its complement (asg_arc_del both directions)."""
    g.del_[ai] = 1
    u = int(g.ul[ai] >> np.uint64(32))
    comp = _find_arc(g, int(g.v[ai]) ^ 1, u ^ 1)
    if comp >= 0:
        g.del_[comp] = 1


# follow_limit_path return codes (Overlaps.h:47-54)
_LONG_TIPS, _TWO_INPUT, _TWO_OUTPUT = 0, 1, 2
_MUL_INPUT, _MUL_OUTPUT, _END_TIPS, _LOOP = 3, 4, 5, 7


def _follow_limit_path(g: StringGraph, s: int, lim: int):
    """Walk the unique-successor path from s (~follow_limit_path,
    gfa_ut.cpp:493); returns (code, end_vertex, n_reads_walked)."""
    v = s
    occ = 0
    while True:
        occ += 1
        e = v                      # reported end = vertex BEFORE the step
        ai = g.arcs_of(v)
        if len(ai) == 0:
            return _END_TIPS, e, occ
        if len(ai) == 2:
            return _TWO_OUTPUT, e, occ
        if len(ai) > 2:
            return _MUL_OUTPUT, e, occ
        if occ > lim:
            return _LONG_TIPS, e, occ
        w = int(g.v[ai[0]])
        kw = len(g.arcs_of(w ^ 1))
        v = w
        if kw == 2:
            return _TWO_INPUT, e, occ
        if kw > 2:
            return _MUL_INPUT, e, occ
        if v == s:
            return _LOOP, e, occ


def if_sup_chimeric(rec, rlen: int, cov_s: int = 0) -> bool:
    """True when the read's own EXACT overlaps do not continuously span it
    (~if_sup_chimeric, gfa_ut.cpp:419): flush left-end and right-end
    overlap coverage never connect across the middle."""
    live = (rec.del_ == 0) & (rec.el != 0)
    if not live.any():
        return True
    qs = np.maximum(rec.qs[live] - cov_s, 0)
    qe = np.minimum(rec.qe[live] - cov_s, rlen)
    left = qs == 0
    right = qe == rlen
    l1 = int(qe[left].max()) if left.any() else 0
    r0 = int(qs[right].min()) if right.any() else rlen
    if l1 > r0:
        return False
    if not left.any() or not right.any():
        return True
    # sweep all exact intervals: does the component containing 0 reach the
    # component containing rlen?
    ev = np.concatenate([qs * 2, qe * 2 + 1])
    ev.sort(kind="stable")
    dp = 0
    st = 0
    l1 = 0
    r0 = rlen
    for x in ev:
        if x & 1:
            dp -= 1
            if dp == 0:
                if st == 0:
                    l1 = int(x >> 1)
                if (x >> 1) == rlen:
                    r0 = st
        else:
            if dp == 0:
                st = int(x >> 1)
            dp += 1
    return not l1 > r0


def asg_arc_cut_chimeric(g: StringGraph, paf, cov,
                         vis: Optional[np.ndarray] = None,
                         protect: Optional[np.ndarray] = None) -> int:
    """Read-level chimeric cut at arc granularity
    (~asg_arc_cut_chimeric, gfa_ut.cpp:917): a 1-in/1-out read whose only
    forward arc is inexact, whose flanking junctions both have
    alternatives, whose neighbor carries a competing exact arc, and whose
    own exact overlaps do not span the read, is a chimera -> deleted."""
    n_cut = 0
    if g.n_arcs == 0:
        log("asg_arc_cut_chimeric", "deleted 0 chimeric reads")
        return 0
    # vectorized prefilter: 1-in/1-out vertices whose single forward arc
    # is inexact and whose flanking junctions both have alternatives
    u_arr = g.arc_u().astype(np.int64)
    live = g.del_ == 0
    out_live = np.bincount(u_arr[live], minlength=2 * g.n_seq)
    la = np.flatnonzero(live)
    u_live = u_arr[la]
    order = np.argsort(u_live, kind="stable")
    uniq, first = np.unique(u_live[order], return_index=True)
    only_arc = np.full(2 * g.n_seq, -1, np.int64)
    only_arc[uniq] = la[order[first]]            # first live arc per vtx
    vs = np.arange(2 * g.n_seq)
    m = (out_live == 1) & (out_live[vs ^ 1] == 1) & \
        np.repeat(g.seq_del == 0, 2)
    if vis is not None:
        m &= ~vis
    if protect is not None:
        m &= ~np.repeat(protect.astype(bool), 2)
    cv = np.flatnonzero(m)
    af = only_arc[cv]
    ab = only_arc[cv ^ 1]
    ok = (af >= 0) & (ab >= 0)
    ok &= g.el[np.maximum(af, 0)] == 0
    wf = g.v[np.maximum(af, 0)].astype(np.int64) ^ 1
    wb = g.v[np.maximum(ab, 0)].astype(np.int64) ^ 1
    ok &= (out_live[wf] >= 2) & (out_live[wb] >= 2)
    cand = sorted((int(g.ol[a]), int(v), int(a))
                  for v, a in zip(cv[ok], af[ok]))
    for ol, v, ai in cand:
        rid = v >> 1
        if g.seq_del[rid] or g.del_[ai]:
            continue
        w = int(g.v[ai]) ^ 1
        if g.seq_del[w >> 1]:
            continue
        a_f = g.arcs_of(v)
        a_b = g.arcs_of(v ^ 1)
        if len(a_f) != 1 or len(a_b) != 1:
            continue
        if len(g.arcs_of(int(g.v[a_f[0]]) ^ 1)) < 2 or \
                len(g.arcs_of(int(g.v[a_b[0]]) ^ 1)) < 2:
            continue
        # neighbor must keep a competing exact arc
        has_exact = any(
            g.el[aw] and int(g.v[aw]) != (v ^ 1)
            for aw in g.arcs_of(w))
        if not has_exact:
            continue
        rlen = int(cov.e[rid] - cov.s[rid])
        if not if_sup_chimeric(paf[rid], rlen, int(cov.s[rid])):
            continue
        g.seq_del[rid] = 1
        n_cut += 1
    if n_cut:
        g.cleanup()
    log("asg_arc_cut_chimeric", f"deleted {n_cut} chimeric reads")
    return n_cut


def asg_arc_cut_complex_bub_links(g: StringGraph, len_rat: float = 0.6,
                                  vis: Optional[np.ndarray] = None) -> int:
    """Cut cross-links between bubble chains
    (~asg_arc_cut_complex_bub_links, gfa_ut.cpp:2453): when EVERY live
    arc of a branch vertex is weak relative to the alternatives at its
    destination, all of them are redundant links -> cut them all."""
    n_cut = 0
    cand = sorted((int(g.ol[g.arcs_of(v)].sum()), int(v))
                  for v in _branch_vertices(g, vis))
    for _, v in cand:
        ai = g.arcs_of(v)
        if len(ai) < 2:
            continue
        all_weak = True
        for a in ai:
            w = int(g.v[a]) ^ 1
            others = [int(g.ol[t]) for t in g.arcs_of(w)
                      if int(g.v[t]) != (v ^ 1)]
            if len(others) < 1 or len(g.arcs_of(w)) < 2:
                all_weak = False
                break
            if int(g.ol[a]) > min(others) * len_rat:
                all_weak = False
                break
        if not all_weak:
            continue
        for a in ai:
            _del_arc_pair(g, int(a))
        n_cut += 1
    if n_cut:
        g.cleanup()
    log("asg_arc_cut_complex_bub_links", f"cut links at {n_cut} vertices")
    return n_cut


def asg_arc_cut_bub_links(g: StringGraph, check_dist: int,
                          len_rat: float = 0.6,
                          read_cov: Optional[np.ndarray] = None,
                          vis: Optional[np.ndarray] = None) -> int:
    """False bubble-link cut (~asg_arc_cut_bub_links, gfa_ut.cpp:2355):
    like the complex variant, but only cuts when the surrounding bubble
    verifiably closes BOTH with only this vertex's links deleted and with
    only the alternatives deleted (if_false_bub_links, :2314)."""
    n_cut = 0
    alen = g.arc_len()
    cand = sorted((int(g.ol[g.arcs_of(v)].sum()), int(v))
                  for v in _branch_vertices(g, vis))
    for _, v in cand:
        ai = g.arcs_of(v)
        if len(ai) < 2:
            continue
        other_arcs = []
        all_weak = True
        for a in ai:
            w = int(g.v[a]) ^ 1
            aw = g.arcs_of(w)
            others = [t for t in aw if int(g.v[t]) != (v ^ 1)]
            if len(others) < 1 or len(aw) < 2:
                all_weak = False
                break
            if int(g.ol[a]) > min(int(g.ol[t]) for t in others) * len_rat:
                all_weak = False
                break
            other_arcs.extend(int(t) for t in others)
        if not all_weak:
            continue
        # (a) delete the alternatives: does a bubble from v still close?
        saved = g.del_.copy()
        for t in other_arcs:
            _del_arc_pair(g, t)
        res_a = _bub_finder(g, v, check_dist, alen, read_cov) \
            if len(g.arcs_of(v)) >= 2 else None
        g.del_ = saved.copy()
        if res_a is None:
            continue
        _, path_a = res_a
        sink = path_a[0] if path_a else -1
        # (b) delete v's own links: bubble from the sink side still closes?
        for a in ai:
            _del_arc_pair(g, int(a))
        res_b = _bub_finder(g, sink ^ 1, check_dist, alen, read_cov) \
            if sink >= 0 and len(g.arcs_of(sink ^ 1)) >= 2 else None
        if res_b is None:
            g.del_ = saved
            continue
        # both hold: the links are false -- keep v's links deleted
        n_cut += 1
    if n_cut:
        g.cleanup()
    log("asg_arc_cut_bub_links", f"cut false links at {n_cut} vertices")
    return n_cut


def asg_cut_large_indel(g: StringGraph, max_ext: int, min_diff: int = 50,
                        vis: Optional[np.ndarray] = None) -> int:
    """Cut arcs whose overlap alignment contained a large indel
    (~asg_cut_large_indel, gfa_ut.cpp:2636): a no_l_indel==0 arc loses
    when it is not within min_diff of the best overlap at both ends (or
    the degree-1 end is a short extension)."""
    n_cut = 0
    if g.n_arcs == 0:
        log("asg_cut_large_indel", "cut 0 large-indel arcs")
        return 0
    u_arr = g.arc_u().astype(np.int64)
    live = g.del_ == 0
    out_live = np.bincount(u_arr[live], minlength=2 * g.n_seq)
    m = live & (g.no_l_indel == 0) & (out_live[u_arr] >= 2) & \
        (g.seq_del[u_arr >> 1] == 0)
    if vis is not None:
        m &= ~vis[u_arr]
    cand = sorted((int(g.ol[ai]), int(ai)) for ai in np.flatnonzero(m))
    for ol, ai in cand:
        if g.del_[ai]:
            continue
        u = int(g.ul[ai] >> np.uint64(32))
        w = int(g.v[ai]) ^ 1
        if g.seq_del[u >> 1] or g.seq_del[w >> 1]:
            continue
        au = g.arcs_of(u)
        aw = g.arcs_of(w)
        if len(au) <= 1 and len(aw) <= 1:
            continue
        if len(au) >= 2:
            if ol + min_diff > int(g.ol[au].max()):
                continue
        if len(aw) >= 2:
            wi = _find_arc(g, w, u ^ 1)
            if wi < 0 or int(g.ol[wi]) + min_diff > int(g.ol[aw].max()):
                continue
        to_del = False
        if len(au) > 1 and len(aw) > 1:
            to_del = True
        elif len(aw) == 1:
            _, _, occ = _follow_limit_path(g, w ^ 1, max_ext)
            to_del = occ < max_ext
        elif len(au) == 1:
            _, _, occ = _follow_limit_path(g, u ^ 1, max_ext)
            to_del = occ < max_ext
        if to_del:
            _del_arc_pair(g, ai)
            n_cut += 1
    if n_cut:
        g.cleanup()
    log("asg_cut_large_indel", f"cut {n_cut} large-indel arcs")
    return n_cut


def asg_cut_semi_circ(g: StringGraph, lim_len: int = 100) -> int:
    """Cut semi-circular back-arcs (~asg_cut_semi_circ, gfa_ut.cpp:2533):
    a vertex with >=2 in-arcs and exactly one out-arc whose short forward
    path loops back into its own in-side gets that back-arc removed."""
    n_cut = 0
    if g.n_arcs == 0:
        log("asg_cut_semi_circ", "cut 0 semi-circular arcs")
        return 0
    u_arr = g.arc_u().astype(np.int64)
    out_live = np.bincount(u_arr[g.del_ == 0], minlength=2 * g.n_seq)
    vs_all = np.arange(2 * g.n_seq)
    m = (out_live == 1) & (out_live[vs_all ^ 1] >= 2) & \
        np.repeat(g.seq_del == 0, 2)
    for v in np.flatnonzero(m):
        v = int(v)
        ai = g.arcs_of(v)
        if len(ai) != 1 or len(g.arcs_of(v ^ 1)) <= 1:
            continue
        code, e, occ = _follow_limit_path(g, v, lim_len)
        if occ > lim_len or code in (_LONG_TIPS, _LOOP, _END_TIPS):
            continue
        for aw in g.arcs_of(v ^ 1):
            if int(g.v[aw]) == (e ^ 1):
                _del_arc_pair(g, int(aw))
                n_cut += 1
    if n_cut:
        g.cleanup()
    log("asg_cut_semi_circ", f"cut {n_cut} semi-circular arcs")
    return n_cut


def asg_iterative_semi_circ(g: StringGraph, lim_len: int = 100) -> int:
    """Iterate semi-circle cutting until stable
    (~asg_iterative_semi_circ, gfa_ut.cpp:2623)."""
    tot = 0
    while True:
        s = asg_cut_semi_circ(g, lim_len)
        tot += s
        if s == 0:
            break
    return tot


def ug_ext_gfa(g: StringGraph, paf, cov, r_to_u: np.ndarray,
               max_len: int, tip_reads: int, max_hang: int,
               int_frac: float, min_ovlp: int = 2000) -> int:
    """Extend dead ends back into deleted reads
    (~ug_ext_gfa + gen_ext_tip, gfa_ut.cpp:3216-3256): a live vertex with
    no successors re-acquires its longest (>= min_ovlp) overlap when the
    target read was deleted by cleaning, is not contained in a live read,
    and the extension is the mutual best; repeats up to tip_reads reads
    or max_len bases.  Returns the number of reads revived."""
    from hifiasm_tpu_torch.graph.sg import hit2arc

    n_rev = 0
    ff = np.zeros(g.n_seq, bool)
    lens = (cov.e - cov.s).astype(np.int64)

    def best_arc_from(v):
        rid = v >> 1
        rec = paf[rid]
        live = rec.del_ == 0
        if not live.any():
            return None
        idx = np.flatnonzero(live)
        tn = rec.tn[idx].astype(np.int64)
        code, udir, vdir, l, ol = hit2arc(
            np.maximum(rec.qs[idx] - cov.s[rid], 0),
            np.minimum(rec.qe[idx] - cov.s[rid], lens[rid]),
            tn, np.maximum(rec.ts[idx] - cov.s[tn], 0),
            np.minimum(rec.te[idx] - cov.s[tn], lens[tn]),
            rec.rev[idx], lens[rid], lens[tn], max_hang, int_frac,
            min_ovlp)
        ok = (code >= 0) & (((rid << 1) | udir) == v) & (ol >= min_ovlp)
        if not ok.any():
            return None
        j = np.flatnonzero(ok)[np.argmax(ol[ok])]
        w = int((tn[j] << 1) | vdir[j])
        return w, int(l[j]), int(ol[j])

    u_now = g.arc_u().astype(np.int64)
    live_arcs = g.del_ == 0
    out_live = np.bincount(u_now[live_arcs], minlength=2 * g.n_seq) \
        if g.n_arcs else np.zeros(2 * g.n_seq, np.int64)
    dead_ends = np.flatnonzero(np.repeat(g.seq_del == 0, 2) &
                               (out_live == 0))
    add = []
    for v0 in dead_ends:
        v = int(v0)
        plen = int(lens[v >> 1])
        steps = 0
        while steps < tip_reads or plen < max_len:
            steps += 1
            got = best_arc_from(v)
            if got is None:
                break
            w, l, ol = got
            tid = w >> 1
            # target must be a cleaning-deleted read, not contained in a
            # live read, and unused by another extension
            if not g.seq_del[tid] or ff[tid]:
                break
            cont = int(r_to_u[tid])
            if cont >= 0 and (not g.seq_del[cont] or ff[cont]):
                break
            back = best_arc_from(w ^ 1)
            if back is None or (back[0] ^ 1) != v:
                break              # not the mutual best
            ff[tid] = True
            add.append((v, w, l, ol))
            plen += int(lens[tid]) - ol
            v = w
    if not add:
        log("ug_ext_gfa", "extended 0 dead ends")
        return 0
    for v, w, l, ol in add:
        g.seq_del[w >> 1] = 0
        n_rev += 1
    new_ul, new_v, new_ol = [], [], []
    for v, w, l, ol in add:
        lw = int(lens[w >> 1]) - ol
        new_ul.append((np.uint64(v) << np.uint64(32)) | np.uint64(l))
        new_v.append(w)
        new_ol.append(ol)
        new_ul.append((np.uint64(w ^ 1) << np.uint64(32)) | np.uint64(
            max(lw, 0)))
        new_v.append(v ^ 1)
        new_ol.append(ol)
    z = np.zeros(len(new_v), np.uint8)
    g.set_arcs(np.concatenate([g.ul, np.array(new_ul, np.uint64)]),
               np.concatenate([g.v, np.array(new_v, np.uint32)]),
               np.concatenate([g.ol, np.array(new_ol, np.int64)]),
               np.concatenate([g.strong, z]),
               np.concatenate([g.el, np.ones(len(new_v), np.uint8)]),
               np.concatenate([g.no_l_indel, np.ones(len(new_v),
                                                     np.uint8)]),
               np.concatenate([g.del_, z]))
    g.cleanup()
    log("ug_ext_gfa", f"revived {n_rev} reads at dead ends")
    return n_rev


# ---- nested-bubble flattening on the UNITIG graph (~hic_clean,
#      Overlaps.cpp:14304): tiny bubbles nested inside larger bubbles are
#      noise branches that derail Hi-C / trio phasing — pop them first.

def _ug_adjacency(ug):
    adj: dict = {}
    for s, d in zip(ug.a_src, ug.a_dst):
        adj.setdefault(int(s), []).append(int(d))
    for v in adj:
        adj[v].sort()
    return adj


def _ug_bubble(adj, v0: int, max_nodes: int = 50):
    """Superbubble from oriented unitig end ``v0`` (the asg_bub_pop1
    scheme on the unitig graph): lazy global in-degrees, Kahn walk;
    returns (sink, interior vertex set) or None."""
    if len(adj.get(v0, [])) < 2:
        return None
    S = [v0]
    p: dict = {}
    pending = 0
    visited = []
    while S:
        S.sort()
        v = S.pop(0)
        visited.append(v)
        if len(visited) > max_nodes:
            return None
        if v != v0 and not adj.get(v, []):
            return None                   # tip inside the bubble
        for w in adj.get(v, []):
            if w == (v0 ^ 1) or (w >> 1) == (v0 >> 1):
                return None               # cycles back into the source
            if w not in p:
                # global in-degree = out-degree of the mirror end
                p[w] = len(adj.get(w ^ 1, []))
                pending += 1
            p[w] -= 1
            if p[w] == 0:
                S.append(w)
                pending -= 1
            elif p[w] < 0:
                return None
        if len(S) == 1 and pending == 0:
            sink = S[0]
            interior = set(visited[1:])
            if (sink ^ 1) in interior or sink in interior:
                return None
            return sink, interior
    return None


def hic_clean_ug(ug, bub_rate: float = 0.1, max_occ: int = 3,
                 max_utg: int = 2) -> int:
    """Flatten tiny nested bubbles before Hi-C / trio phasing
    (~hic_clean, Overlaps.cpp:14304): inside each superbubble, a NESTED
    bubble opening from an interior unitig whose interior carries
    < bub_rate x the outer bubble's reads, <= max_occ reads and
    <= max_utg unitigs is popped — the heaviest branch path stays, the
    rest move out of the graph.  Mutates ``ug`` (renumbers unitigs);
    returns #unitigs dropped."""
    import numpy as np

    adj = _ug_adjacency(ug)
    occ = [len(u.vs) for u in ug.utgs]
    drop: set = set()
    n_vtx = 2 * len(ug.utgs)
    for v0 in range(n_vtx):
        got = _ug_bubble(adj, v0)
        if got is None:
            continue
        _, interior = got
        v_occ = sum(occ[u >> 1] for u in interior)
        if v_occ == 0:
            continue
        for u in sorted(interior):
            for end in (u, u ^ 1):
                nest = _ug_bubble(adj, end)
                if nest is None:
                    continue
                _, n_int = nest
                uids = {x >> 1 for x in n_int}
                u_occ = sum(occ[i] for i in uids)
                if u_occ >= v_occ * bub_rate or u_occ > max_occ or \
                        len(uids) > max_utg:
                    continue
                # pop: keep the heaviest branch unitig, drop the rest
                keep = max(uids, key=lambda i: (occ[i], -i))
                for i in uids:
                    if i != keep:
                        drop.add(i)
    if not drop:
        return 0
    keep_mask = np.ones(len(ug.utgs), bool)
    keep_mask[list(drop)] = False
    remap = np.cumsum(keep_mask) - 1
    ug.utgs = [u for i, u in enumerate(ug.utgs) if keep_mask[i]]
    src = ug.a_src.astype(np.int64)
    dst = ug.a_dst.astype(np.int64)
    ka = keep_mask[src >> 1] & keep_mask[dst >> 1]
    src, dst = src[ka], dst[ka]
    ug.a_src = ((remap[src >> 1] << 1) | (src & 1)).astype(np.uint32)
    ug.a_dst = ((remap[dst >> 1] << 1) | (dst & 1)).astype(np.uint32)
    ug.a_ol = ug.a_ol[ka]
    from hifiasm_tpu_torch.utils.logging import log
    log("hic_clean", f"flattened {len(drop)} nested-bubble unitigs")
    return len(drop)


def _ug_compact(ug, dead: np.ndarray) -> None:
    """Remove ``dead`` unitigs from ``ug`` in place (renumbers)."""
    keep_mask = ~dead
    remap = np.cumsum(keep_mask) - 1
    ug.utgs = [u for i, u in enumerate(ug.utgs) if keep_mask[i]]
    if len(ug.a_src):
        src = ug.a_src.astype(np.int64)
        dst = ug.a_dst.astype(np.int64)
        ka = keep_mask[src >> 1] & keep_mask[dst >> 1]
        src, dst = src[ka], dst[ka]
        ug.a_src = ((remap[src >> 1] << 1) | (src & 1)).astype(np.uint32)
        ug.a_dst = ((remap[dst >> 1] << 1) | (dst & 1)).astype(np.uint32)
        ug.a_ol = ug.a_ol[ka]


def ug_drop_self_loops(ug, alive: np.ndarray) -> int:
    """Drop self-loop arcs at repeat unitigs that also have other
    connections (~asg_arc_del_simple_circle_untig, Overlaps.cpp:27331:
    a short circle collapsing a unitig onto itself is a repeat artifact,
    not a real circular contig)."""
    if not len(ug.a_src):
        return 0
    src = ug.a_src.astype(np.int64)
    dst = ug.a_dst.astype(np.int64)
    self_loop = (src >> 1) == (dst >> 1)
    if not self_loop.any():
        return 0
    # only drop when the unitig has at least one non-self arc (else it
    # may be a genuine circular element, e.g. organelle)
    has_other = np.zeros(len(ug.utgs), bool)
    for s, d in zip(src[~self_loop], dst[~self_loop]):
        if alive[s >> 1] and alive[d >> 1]:
            has_other[s >> 1] = True
            has_other[d >> 1] = True
    drop = self_loop & has_other[src >> 1]
    if not drop.any():
        return 0
    keep = ~drop
    ug.a_src = ug.a_src[keep]
    ug.a_dst = ug.a_dst[keep]
    ug.a_ol = ug.a_ol[keep]
    return int(drop.sum())


def _ug_adj_alive(ug, alive: np.ndarray) -> dict:
    adj: dict = {}
    for s, d in zip(ug.a_src, ug.a_dst):
        s, d = int(s), int(d)
        if alive[s >> 1] and alive[d >> 1]:
            adj.setdefault(s, []).append(d)
    for v in adj:
        adj[v].sort()
    return adj


def ug_cut_equal_tips(ug, alive: np.ndarray, links: dict) -> int:
    """At a branching unitig end with >=2 TIP branches that are
    haplotype-linked to each other (trans read links), keep the longest
    tip and move the rest to alternate
    (~asg_arc_cut_trio_long_equal_tips_assembly, Overlaps.cpp:29207:
    two dead-end branches of one junction covering the same region are
    haplotype twins; the reference ALTER-labels the weaker one so the
    primary walk threads through the stronger)."""
    adj = _ug_adj_alive(ug, alive)
    lens = np.array([u.len for u in ug.utgs], np.int64)
    moved = 0
    for v0 in sorted(adj):
        outs = adj.get(v0, [])
        if len(outs) < 2:
            continue
        tips = []
        for d in outs:
            du = d >> 1
            if du == (v0 >> 1) or not alive[du]:
                continue
            # the branch is a tip if the walk cannot continue past it
            if not adj.get(d, []):
                tips.append(du)
        tips = sorted(set(tips))
        if len(tips) < 2:
            continue
        keep = max(tips, key=lambda i: (int(lens[i]), -i))
        for t in tips:
            if t == keep:
                continue
            row = links.get(t, {})
            cnt = row.get(keep, 0) + links.get(keep, {}).get(t, 0)
            n_reads_t = len(ug.utgs[t].vs)
            # require most of the weaker tip's reads to be trans-linked
            # to the kept branch (same-region evidence)
            if cnt * 2 < n_reads_t:
                continue
            alive[t] = False
            moved += 1
    return moved


def ug_pop_bubble_keep_best(ug, alive: np.ndarray, utg_cov) -> int:
    """Pop unitig-level superbubbles, keeping the heaviest source->sink
    path; off-path interior unitigs move to alternate
    (~asg_pop_bubble_primary_trio, Overlaps.cpp:26816 with DROP
    labelling).  Weight = unitig length * (1 + coverage)."""
    adj = _ug_adj_alive(ug, alive)
    lens = np.array([u.len for u in ug.utgs], np.int64)
    cov = np.asarray(utg_cov, np.int64) if utg_cov is not None else \
        np.ones(len(ug.utgs), np.int64)
    moved = 0
    for v0 in sorted(adj):
        if not alive[v0 >> 1]:
            continue
        got = _ug_bubble(adj, v0)
        if got is None:
            continue
        sink, interior = got
        if any(not alive[u >> 1] for u in interior):
            continue
        # heaviest path v0 -> sink: relax in KAHN topological order —
        # BFS discovery order misses edges from deeper vertices back to
        # earlier-discovered ones, so the kept path could be non-heaviest
        nodes = {v0, sink} | set(interior)
        preds: dict = {w: [] for w in nodes}
        indeg = {w: 0 for w in nodes}
        for v in sorted(nodes):
            if v == sink:
                continue
            for w in adj.get(v, []):
                if w in nodes and w != v0:
                    indeg[w] += 1
                    preds[w].append(v)
        order = [v0]
        qpos = 0
        while qpos < len(order):
            v = order[qpos]
            qpos += 1
            if v == sink:
                continue
            for w in adj.get(v, []):
                if w in nodes and w != v0:
                    indeg[w] -= 1
                    if indeg[w] == 0:
                        order.append(w)
        best: dict = {v0: (0, None)}
        for v in order:
            if v == v0:
                continue
            cands = []
            for p in sorted(set(preds[v])):
                if p in best:
                    wgt = best[p][0] + int(lens[v >> 1]) * \
                        (1 + int(cov[v >> 1]))
                    cands.append((wgt, p))
            if cands:
                best[v] = max(cands)
        if sink not in best:
            continue
        path = set()
        v = sink
        while v is not None and v != v0:
            path.add(v >> 1)
            v = best[v][1]
        for u in sorted({x >> 1 for x in interior}):
            if u not in path and alive[u]:
                alive[u] = False
                moved += 1
        if moved:
            adj = _ug_adj_alive(ug, alive)
    return moved


def clean_primary_ug(ug, utg_cov, links: dict, max_rounds: int = 4):
    """Contig-level cleanup of the primary unitig graph before p_ctg
    threading (~clean_primary_untig_graph, Overlaps.cpp:20005): drop
    repeat self-loops, pop primary bubbles, move het-linked equal tips
    to alternate, to fixpoint.  Mutates ``ug`` (renumbers at the end);
    returns the ORIGINAL local ids moved to alternate."""
    n = len(ug.utgs)
    alive = np.ones(n, bool)
    for _ in range(max_rounds):
        ch = ug_drop_self_loops(ug, alive)
        ch += ug_pop_bubble_keep_best(ug, alive, utg_cov)
        ch += ug_cut_equal_tips(ug, alive, links)
        if not ch:
            break
    moved = np.flatnonzero(~alive).tolist()
    if moved:
        _ug_compact(ug, ~alive)
        log("clean_primary_ug",
            f"moved {len(moved)} unitigs to alternate at contig level")
    return moved


def _path_reads(g: StringGraph, s: int, lim: int) -> list:
    """Read ids along the unique-successor path from s (<= lim)."""
    out = [s >> 1]
    v = s
    while len(out) < lim:
        ai = g.arcs_of(v)
        if len(ai) != 1:
            break
        v = int(g.v[ai[0]])
        if len(g.arcs_of(v ^ 1)) != 1 or (v >> 1) == (s >> 1):
            break
        out.append(v >> 1)
    return out


def _check_diploid(g: StringGraph, rev_paf, v1: int, v2: int,
                   min_edge_length: int, max_walk: int = 64) -> int:
    """~check_if_diploid (Overlaps.cpp:6108): walk the single paths
    from v1/v2; -1 = cannot tell (a path too short, or the shorter one
    has NO trans overlaps), 1 = diploid pair (>30% of the shorter
    path's trans overlaps land in the other path), 0 = not a pair."""
    paths = [_path_reads(g, v, max_walk) for v in (v1, v2)]
    l1, l2 = len(paths[0]), len(paths[1])
    if l1 <= min_edge_length or l2 <= min_edge_length:
        return -1
    b_min, b_max = (paths[0], paths[1]) if l1 <= l2 else \
        (paths[1], paths[0])
    smax = set(b_max)
    min_count = max_count = 0
    for qn in b_min:
        for t in rev_paf[qn].tn:
            tn = int(t)
            if g.seq_del[tn]:
                continue
            min_count += 1
            if tn in smax:
                max_count += 1
    if min_count == 0:
        return -1
    if max_count == 0:
        return 0
    return 1 if max_count / min_count > 0.3 else 0


def asg_arc_del_orthology(g: StringGraph, rev_paf, drop_ratio: float = 0.4,
                          max_ext: int = 4,
                          vis: Optional[np.ndarray] = None) -> int:
    """Weak-arc cut that PRESERVES haplotype forks
    (~asg_arc_del_orthology_multiple_way, Overlaps.cpp:27072): at a
    branching vertex, an arc much weaker than the strongest sibling
    (ol < drop_ratio x max) is deleted only when its branch is NOT the
    haplotype twin of the strongest branch (no trans overlaps between
    the two path neighborhoods) — a plain ratio cut there would destroy
    het bubbles the phasing stages need.  ``vis`` masks bubble interiors
    (the reference's asg_arc_identify_simple_bubbles_multi gate)."""
    n_cut = 0
    # vectorized candidate prefilter: only vertices that are live,
    # outside bubble interiors, and BRANCHING (>= 2 live out-arcs) can
    # cut anything — the python loop then touches O(#branching) vertices
    # instead of all 2 * n_seq (the 10^7-scale wall at human depth;
    # the reference's per-vertex C loop is gfa_ut.cpp:3027)
    u_all = g.arc_u().astype(np.int64)
    out_live = np.bincount(u_all[g.del_ == 0], minlength=2 * g.n_seq)
    cand_m = np.repeat(g.seq_del == 0, 2) & (out_live >= 2)
    if vis is not None:
        cand_m &= ~vis.astype(bool)
    for v in np.flatnonzero(cand_m):
        v = int(v)
        ai = g.arcs_of(v)
        if len(ai) < 2:
            continue
        ols = g.ol[ai]
        imax = int(np.argmax(ols))
        v_max = int(g.v[ai[imax]])
        max_ol = int(ols[imax])
        for j in range(len(ai)):
            if j == imax:
                continue
            if int(ols[j]) >= drop_ratio * max_ol:
                continue
            # cut ONLY on positive evidence of NON-orthology: -1
            # (too short / no trans data) keeps the arc, like the
            # reference's == 0 gate
            if _check_diploid(g, rev_paf, v_max, int(g.v[ai[j]]),
                              max_ext) != 0:
                continue
            _del_arc_pair(g, int(ai[j]))
            n_cut += 1
    if n_cut:
        log("asg_arc_del_orthology",
            f"removed {n_cut} non-orthologous weak arcs")
    return n_cut
