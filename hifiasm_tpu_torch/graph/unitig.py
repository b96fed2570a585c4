"""Unitig generation and sequence assembly.

Re-expresses ``ma_ug_gen`` (Overlaps.h:1078) and ``ma_ug_seq``
(Overlaps.h:1104): maximal non-branching paths of the string graph become
unitigs; each read on the path contributes its node-length prefix (in path
orientation), the final read its full (coverage-cut) sequence.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from hifiasm_tpu_torch.graph.sg import CoverageCut, StringGraph
from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.utils.logging import log


@dataclass
class Unitig:
    vs: np.ndarray            # path vertices (rid << 1 | dir)
    node_len: np.ndarray      # per-vertex contributed length
    len: int
    circ: bool
    start: int                # first vertex, or UINT32_MAX-style -1 if circle
    end: int                  # complement of last vertex


@dataclass
class UnitigGraph:
    utgs: List[Unitig] = field(default_factory=list)
    # arcs between unitig ends: (uid << 1 | end) -> (uid << 1 | end)
    a_src: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    a_dst: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    a_ol: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def __len__(self):
        return len(self.utgs)


def _out_deg(g: StringGraph, vtx: int) -> int:
    return len(g.arcs_of(vtx))


def ma_ug_gen(g: StringGraph) -> UnitigGraph:
    ug = UnitigGraph()
    n_vtx = 2 * g.n_seq
    visited = np.zeros(n_vtx, bool)
    alen = g.arc_len()

    # vectorized start detection (same ascending visit order as a full
    # scan): v0 is interior iff its single predecessor also has a single
    # successor; everything else that is live starts a unitig
    live_v = np.repeat(g.seq_del == 0, 2)
    u_arr = g.arc_u().astype(np.int64)
    out_live = np.bincount(u_arr[g.del_ == 0], minlength=n_vtx)
    vtx = np.arange(n_vtx)
    # first-live-arc per vertex (one unique() pass) -> O(1) per-step
    # successor lookups in the chain walks below (the per-step
    # g.arcs_of() form cost a searchsorted per vertex, the wall of
    # ma_ug_gen at >1M-read scale)
    live_idx = np.flatnonzero(g.del_ == 0)
    uniq_u, first = np.unique(u_arr[live_idx], return_index=True)
    first_arc = np.full(n_vtx, -1, np.int64)
    first_arc[uniq_u] = live_idx[first]
    single = out_live == 1
    nxt_w = np.full(n_vtx, -1, np.int64)
    nxt_l = np.zeros(n_vtx, np.int64)
    sv = np.flatnonzero(single)
    nxt_w[sv] = g.v[first_arc[sv]].astype(np.int64)
    nxt_l[sv] = alen[first_arc[sv]]

    def single_next(v):
        w = nxt_w[v]
        if w < 0:
            return None, 0
        return int(w), int(nxt_l[v])

    starts_mask = live_v.copy()
    one_in = live_v & (out_live[vtx ^ 1] == 1)
    if one_in.any():
        cand = np.flatnonzero(one_in)
        # single live predecessor of v = complement of the only live arc
        # out of v^1
        pred = (g.v[first_arc[cand ^ 1]].astype(np.int64)) ^ 1
        starts_mask[cand[out_live[pred] == 1]] = False
    # ---- vectorized chain extraction (the r5 scale fix: the per-vertex
    # python walk was 10^7 python steps per ma_ug_gen call at human
    # depth; the reference walks in C, Overlaps.h:1078) ----
    # Chain edges v -> w exist where v has one live out-arc (nxt_w) AND
    # w has one live in-arc; on a del-SYMMETRIC graph (the production
    # invariant: _del_arc_pair/symm_del) the edge set is injective on
    # targets, so chains are vertex-disjoint paths.  Binary lifting on
    # the predecessor pointers assigns every chain vertex its
    # (root, rank) in O(n log n) numpy; pure cycles never converge to a
    # root and fall through to the scalar circle loop.
    par = np.full(n_vtx, -1, np.int64)
    e_src = np.flatnonzero(
        (nxt_w >= 0) & (out_live[np.clip(nxt_w, 0, None) ^ 1] == 1))
    e_dst = nxt_w[e_src]
    if len(np.unique(e_dst)) != len(e_dst):
        # asymmetric deletions broke target-injectivity (a vertex whose
        # complement-derived in-degree reads 1 but with two live in-
        # arcs): the scalar walk's first-visitor semantics cannot be
        # expressed as disjoint chains — take the exact scalar path
        return _ma_ug_gen_scalar(g, ug, visited, live_v, out_live,
                                 single_next, starts_mask)
    par[e_dst] = e_src
    jump = par.copy()                 # current ancestor (-1 at roots)
    rank = (par >= 0).astype(np.int64)   # distance to that ancestor
    active = np.flatnonzero(par >= 0)
    for _ in range(max(int(n_vtx).bit_length(), 1) + 1):
        if not len(active):
            break
        jj = jump[active]
        up = jump[jj]
        sel = up >= 0
        if not sel.any():
            break
        idx = active[sel]
        rank[idx] += rank[jj[sel]]
        jump[idx] = up[sel]
        active = idx
    chain_root = np.where(jump >= 0, jump, np.arange(n_vtx))
    # a vertex belongs to an emitted chain iff its root is a start (no
    # per-vertex liveness filter: the scalar walk appends interior
    # vertices regardless of seq_del — only the START is gated)
    mvtx = np.flatnonzero(starts_mask[chain_root])
    mv = mvtx[np.lexsort((rank[mvtx], chain_root[mvtx]))]
    uniq_r, first_i = np.unique(chain_root[mv], return_index=True)
    bounds = np.append(first_i, len(mv))
    lasts = mv[bounds[1:] - 1]
    # whole-batch per-chain data (no per-chain numpy calls in the loop:
    # at ~10^6 short chains the small-array overhead was 2x slower than
    # the scalar walk it replaced)
    node_len_all = nxt_l[mv]
    node_len_all[bounds[1:] - 1] = g.seq_len[(lasts >> 1)]
    len_all = np.add.reduceat(node_len_all, bounds[:-1]) \
        if len(mv) else np.zeros(0, np.int64)
    mv32 = mv.astype(np.uint32)
    # complement pairing, vectorized: chain c's complement chain is the
    # one rooted at (last vertex ^ 1); emit the member of each pair with
    # the SMALLER root — exactly the ascending-start visit order of the
    # scalar loop.  Chains overlapping their own complement (palindromic
    # walks, where the scalar rules truncate) re-walk scalar-side.
    comp_root = chain_root[lasts ^ 1]
    pal_v = chain_root[mv] == chain_root[mv ^ 1]
    pal_roots = np.unique(chain_root[mv[pal_v]]) if pal_v.any() else \
        np.zeros(0, np.int64)
    pal_set = set(pal_roots.tolist())
    emit_m = (uniq_r <= comp_root) | ~starts_mask[comp_root]
    emit_i = np.flatnonzero(emit_m)
    if not pal_set:
        # fast path (the overwhelmingly common case): no palindromic
        # chains -> no truncation interplay, so the per-chain visited
        # reads/writes batch into two whole-array scatters
        for ci in emit_i:
            b0, b1 = bounds[ci], bounds[ci + 1]
            # disjoint slices: views are safe, no per-chain copies
            ug.utgs.append(Unitig(
                vs=mv32[b0:b1], node_len=node_len_all[b0:b1],
                len=int(len_all[ci]), circ=False,
                start=int(mv[b0]), end=int(mv[b1 - 1]) ^ 1))
        em = mv[np.repeat(emit_m, np.diff(bounds))]
        visited[em] = True
        visited[em ^ 1] = True
        emit_i = np.zeros(0, np.int64)
    for ci in emit_i:
        v0 = int(uniq_r[ci])
        if visited[v0]:
            continue
        b0, b1 = bounds[ci], bounds[ci + 1]
        if v0 in pal_set:
            path = [v0]
            seen_local = {v0}
            lens = []
            v = v0
            while True:
                w, l = single_next(v)
                if w is None or out_live[w ^ 1] != 1:
                    break
                if w in seen_local or (w ^ 1) in seen_local:
                    break
                path.append(int(w))
                seen_local.add(int(w))
                lens.append(l)
                v = int(w)
            vs = np.array(path, np.uint32)
            node_len = np.array(
                lens + [int(g.seq_len[path[-1] >> 1])], np.int64)
            vs64 = np.array(path, np.int64)
            visited[vs64] = True
            visited[vs64 ^ 1] = True
            ug.utgs.append(Unitig(
                vs=vs, node_len=node_len, len=int(node_len.sum()),
                circ=False, start=path[0], end=path[-1] ^ 1))
            continue
        vs = mv32[b0:b1].copy()
        visited[mv[b0:b1]] = True
        visited[mv[b0:b1] ^ 1] = True
        ug.utgs.append(Unitig(
            vs=vs, node_len=node_len_all[b0:b1].copy(),
            len=int(len_all[ci]), circ=False,
            start=int(mv[b0]), end=int(mv[b1 - 1]) ^ 1))

    # circles fully interior to chains (no start vertex) remain unvisited
    for v0 in np.flatnonzero(~visited & live_v):
        v0 = int(v0)
        if visited[v0] or g.seq_del[v0 >> 1]:
            continue
        path = [v0]
        seen_local = {v0}
        lens = []
        v = v0
        circ = False
        while True:
            w, l = single_next(v)
            if w is None:
                break
            if w == v0:
                circ = True
                lens.append(l)
                break
            if w in seen_local or (w ^ 1) in seen_local:
                break                       # rho walk, not a clean circle
            path.append(w)
            seen_local.add(w)
            lens.append(l)
            v = w
        if not circ:
            lens.append(int(g.seq_len[path[-1] >> 1]))
        for p in path:
            visited[p] = True
            visited[p ^ 1] = True
        node_len = np.array(lens, np.int64)
        ug.utgs.append(Unitig(
            np.array(path, np.uint32), node_len, int(node_len.sum()),
            circ, path[0] if not circ else -1,
            (path[-1] ^ 1) if not circ else -1))

    _link_unitig_arcs(g, ug)
    log("ma_ug_gen", f"{len(ug)} unitigs")
    return ug


def _ma_ug_gen_scalar(g: StringGraph, ug: UnitigGraph,
                      visited: np.ndarray, live_v: np.ndarray,
                      out_live: np.ndarray, single_next,
                      starts_mask: np.ndarray) -> UnitigGraph:
    """The r4 per-vertex walk, kept as the exact-semantics fallback for
    graphs with asymmetric arc deletions (where the vectorized chain
    decomposition's injectivity precondition fails)."""
    for v0 in np.flatnonzero(starts_mask):
        v0 = int(v0)
        if visited[v0] or g.seq_del[v0 >> 1]:
            continue
        path = [v0]
        seen_local = {v0}
        lens = []
        v = v0
        circ = False
        while True:
            w, l = single_next(v)
            if w is None:
                break
            if out_live[w ^ 1] != 1:
                break
            if w == v0:
                circ = True
                lens.append(l)
                break
            if w in seen_local or (w ^ 1) in seen_local:
                break
            path.append(w)
            seen_local.add(w)
            lens.append(l)
            v = w
        if not circ:
            lens.append(int(g.seq_len[path[-1] >> 1]))
        for p in path:
            visited[p] = True
            visited[p ^ 1] = True
        node_len = np.array(lens, np.int64)
        ug.utgs.append(Unitig(
            vs=np.array(path, np.uint32), node_len=node_len,
            len=int(node_len.sum()), circ=circ,
            start=path[0] if not circ else -1,
            end=(path[-1] ^ 1) if not circ else -1))
    for v0 in np.flatnonzero(~visited & live_v):
        v0 = int(v0)
        if visited[v0] or g.seq_del[v0 >> 1]:
            continue
        path = [v0]
        seen_local = {v0}
        lens = []
        v = v0
        circ = False
        while True:
            w, l = single_next(v)
            if w is None:
                break
            if w == v0:
                circ = True
                lens.append(l)
                break
            if w in seen_local or (w ^ 1) in seen_local:
                break
            path.append(w)
            seen_local.add(w)
            lens.append(l)
            v = w
        if not circ:
            lens.append(int(g.seq_len[path[-1] >> 1]))
        for p in path:
            visited[p] = True
            visited[p ^ 1] = True
        node_len = np.array(lens, np.int64)
        ug.utgs.append(Unitig(
            np.array(path, np.uint32), node_len, int(node_len.sum()),
            circ, path[0] if not circ else -1,
            (path[-1] ^ 1) if not circ else -1))
    _link_unitig_arcs(g, ug)
    log("ma_ug_gen", f"{len(ug)} unitigs (scalar fallback)")
    return ug


def _link_unitig_arcs(g: StringGraph, ug: UnitigGraph) -> None:
    """Arcs between unitig ends from remaining string-graph arcs.

    Fully vectorized (the per-unitig ``arcs_of`` form was 2/3 of the
    whole ma_ug_gen wall at 2M reads); record order reproduces the
    scalar nested loop exactly via a (uid, end, arc_idx, sub) lexsort,
    so downstream outputs stay byte-identical."""
    n_vtx = 2 * g.n_seq
    firsts, lasts, uids = [], [], []
    for uid, u in enumerate(ug.utgs):
        if u.circ:
            continue
        firsts.append(int(u.vs[0]))
        lasts.append(int(u.vs[-1]))
        uids.append(uid)
    if not uids or g.n_arcs == 0:
        ug.a_src = np.zeros(0, np.uint32)
        ug.a_dst = np.zeros(0, np.uint32)
        ug.a_ol = np.zeros(0, np.int64)
        return
    firsts = np.array(firsts, np.int64)
    lasts = np.array(lasts, np.int64)
    uids = np.array(uids, np.int64)
    head_uid = np.full(n_vtx, -1, np.int64)
    tail_uid = np.full(n_vtx, -1, np.int64)
    head_uid[firsts] = uids
    tail_uid[lasts] = uids
    live = np.flatnonzero(g.del_ == 0)
    s_all = g.arc_u()[live].astype(np.int64)
    w_all = g.v[live].astype(np.int64)
    # out-arc sets: end 0 = arcs out of last(u), end 1 = arcs out of
    # first(u)^1 (entering the unitig reversed)
    src_u = []
    for which, su in ((0, tail_uid[s_all]),
                      (1, head_uid[s_all ^ 1])):
        sel = np.flatnonzero(su >= 0)
        if not len(sel):
            continue
        # each arc yields: head-entry of target w, then tail-entry of
        # w^1 (the scalar append order, sub = 0 then 1)
        for sub, du, dend in ((0, head_uid[w_all[sel]], 0),
                              (1, tail_uid[w_all[sel] ^ 1], 1)):
            ok = np.flatnonzero(du >= 0)
            if not len(ok):
                continue
            k = sel[ok]
            src_u.append((su[k] * 2 + which, which, live[k], sub,
                          du[ok] * 2 + dend, g.ol[live[k]]))
    if not src_u:
        ug.a_src = np.zeros(0, np.uint32)
        ug.a_dst = np.zeros(0, np.uint32)
        ug.a_ol = np.zeros(0, np.int64)
        return
    srcv = np.concatenate([r[0] for r in src_u])
    whichv = np.concatenate([np.full(len(r[0]), r[1], np.int64)
                             for r in src_u])
    arcv = np.concatenate([r[2] for r in src_u])
    subv = np.concatenate([np.full(len(r[0]), r[3], np.int64)
                           for r in src_u])
    dstv = np.concatenate([r[4] for r in src_u])
    olv = np.concatenate([r[5] for r in src_u])
    order = np.lexsort((subv, arcv, whichv, srcv >> 1))
    ug.a_src = srcv[order].astype(np.uint32)
    ug.a_dst = dstv[order].astype(np.uint32)
    ug.a_ol = olv[order].astype(np.int64)


def unitig_seq(u: Unitig, store: ReadStore, cov: CoverageCut) -> np.ndarray:
    """Concatenate read contributions along the path (~ma_ug_seq).

    Vectorized: one fancy-index gather from the store-wide flat code
    bank per unitig (node_len[i] leading bases of each path read in
    path orientation), instead of a per-read decode/revcomp loop."""
    if len(u.vs) == 0:
        return np.zeros(0, np.uint8)
    flat = store.flat_codes()
    rids = (u.vs >> np.uint32(1)).astype(np.int64)
    dirs = (u.vs & np.uint32(1)).astype(np.int64)
    s = cov.s[rids].astype(np.int64)
    e = cov.e[rids].astype(np.int64)
    nl = np.minimum(np.asarray(u.node_len, np.int64), e - s)
    nl = np.maximum(nl, 0)
    tot = int(nl.sum())
    if tot == 0:
        return np.zeros(0, np.uint8)
    starts = np.cumsum(nl) - nl
    j = np.arange(tot, dtype=np.int64) - np.repeat(starts, nl)
    off = store.offsets[rids]
    base = np.repeat(np.where(dirs == 0, off + s, off + e - 1), nl)
    sign = np.repeat(1 - 2 * dirs, nl)
    out = flat[base + sign * j]          # fancy index -> fresh array
    if dirs.any():
        comp = np.repeat(dirs == 1, nl) & (out < 4)   # N stays N
        out[comp] = 3 - out[comp]
    return out


def refine_junction_lens(ug: UnitigGraph, store: ReadStore,
                         cov: CoverageCut, max_shift: int = 4,
                         probe: int = 32) -> int:
    """Base-exact junction refinement of ``node_len`` (~the exactness
    ``ma_ug_seq`` inherits from the reference's final overlap records).

    node_len derives from arc overlap lengths whose coordinates passed
    through the EC edit-trace remap (approximate to +-1-2 bases after
    length-changing corrections); a wrong length duplicates or drops
    bases at every affected junction — measured: 67 of 73 contig-vs-
    truth errors sat within 10 bp of a read junction at 500 kb.  For
    each consecutive path pair, search the next read's leading PROBE
    bases around the current cut at +-max_shift in the current read
    (both in path orientation, coverage-trimmed) and snap node_len to
    the exact continuation.  Shift 0 is tested first, so already-exact
    junctions never move; no exact match leaves the junction as-is.
    Returns the number of junctions adjusted."""
    cache: dict = {}

    def oriented(v: int) -> np.ndarray:
        r = cache.get(v)
        if r is None:
            rid, d = v >> 1, v & 1
            c = store.get_codes(rid)[int(cov.s[rid]):int(cov.e[rid])]
            if d:
                from hifiasm_tpu_torch.io.readstore import revcomp_codes
                c = revcomp_codes(c)
            r = cache[v] = c
        return r

    n_fix = 0
    for u in ug.utgs:
        n = len(u.vs)
        if n < 2:
            continue
        nl_arr = np.asarray(u.node_len, np.int64).copy()
        changed = False
        for i in range(n - 1):
            a = oriented(int(u.vs[i]))
            b = oriented(int(u.vs[i + 1]))
            nl = int(nl_arr[i])
            if len(b) < probe or nl < max_shift or \
                    nl + max_shift + probe > len(a):
                continue
            head = b[:probe]
            for d in (0, -1, 1, -2, 2, -3, 3, -4, 4):
                if np.array_equal(a[nl + d:nl + d + probe], head):
                    if d:
                        nl_arr[i] = nl + d
                        changed = True
                        n_fix += 1
                    break
        if changed:
            u.node_len = nl_arr
            u.len = int(nl_arr.sum())
    if n_fix:
        log("refine_junction_lens", f"snapped {n_fix} read junctions")
    return n_fix


def unitig_coverage(u: Unitig, paf_counts: np.ndarray) -> int:
    """Mean read coverage proxy: overlaps per read on the path (rd:i tag)."""
    if len(u.vs) == 0:
        return 0
    rids = (u.vs >> 1).astype(np.int64)
    return int(np.round(paf_counts[rids].mean())) if len(rids) else 0


def ug_cut_tips(ug: UnitigGraph, max_reads: int = 3) -> int:
    """Remove tip unitigs of <= max_reads reads attached at exactly one
    end (~the --ctg-n contig-tip removal, CommandLines.cpp:296). Mutates
    ``ug`` in place (unitigs renumbered); returns #removed."""
    n = len(ug.utgs)
    if n == 0 or len(ug.a_src) == 0:
        return 0
    deg = np.bincount(ug.a_src.astype(np.int64), minlength=2 * n)
    drop = np.zeros(n, bool)
    for uid, u in enumerate(ug.utgs):
        if len(u.vs) > max_reads:
            continue
        d_f = int(deg[uid << 1])
        d_r = int(deg[uid << 1 | 1])
        if (d_f == 0) != (d_r == 0):
            drop[uid] = True
    if not drop.any():
        return 0
    remap = np.cumsum(~drop) - 1
    ug.utgs = [u for uid, u in enumerate(ug.utgs) if not drop[uid]]
    keep_arc = ~drop[ug.a_src >> 1] & ~drop[ug.a_dst >> 1]
    src = ug.a_src[keep_arc].astype(np.int64)
    dst = ug.a_dst[keep_arc].astype(np.int64)
    ug.a_src = ((remap[src >> 1] << 1) | (src & 1)).astype(np.uint32)
    ug.a_dst = ((remap[dst >> 1] << 1) | (dst & 1)).astype(np.uint32)
    ug.a_ol = ug.a_ol[keep_arc]
    return int(drop.sum())


def split_unitig(ug: UnitigGraph, uid: int, break_off: int) -> bool:
    """Break unitig ``uid`` at the read boundary nearest ``break_off``
    (~the misjoin breaks of update_switch_unitig, hic.cpp:17051). The
    left part keeps ``uid`` and the left-end arcs; the right part is
    appended and takes the right-end arcs. Returns False when the break
    would leave an empty side."""
    u = ug.utgs[uid]
    cum = np.cumsum(u.node_len)
    j = int(np.searchsorted(cum, break_off))
    if j <= 0 or j >= len(u.vs):
        return False
    left_len = int(cum[j - 1])
    new_id = len(ug.utgs)
    left = Unitig(vs=u.vs[:j].copy(), node_len=u.node_len[:j].copy(),
                  len=left_len, circ=False, start=int(u.vs[0]),
                  end=int(u.vs[j - 1]) ^ 1)
    right = Unitig(vs=u.vs[j:].copy(), node_len=u.node_len[j:].copy(),
                   len=int(u.len) - left_len, circ=False,
                   start=int(u.vs[j]), end=u.end)
    ug.utgs[uid] = left
    ug.utgs.append(right)
    # right end of the original (vertex uid<<1) now belongs to the right
    # part; left end (uid<<1|1) stays with the left part
    src = ug.a_src.astype(np.int64)
    dst = ug.a_dst.astype(np.int64)
    src[src == (uid << 1)] = new_id << 1
    dst[dst == (uid << 1 | 1)] = new_id << 1 | 1
    ug.a_src = src.astype(np.uint32)
    ug.a_dst = dst.astype(np.uint32)
    return True


def unitig_depth_profile(u: Unitig, cov: CoverageCut) -> np.ndarray:
    """Read-depth along the unitig from its layout (same construction as
    the lowQ BED profile)."""
    depth = np.zeros(u.len + 1, np.int32)
    off = 0
    for k, v in enumerate(u.vs):
        rid = int(v) >> 1
        rl = int(cov.e[rid] - cov.s[rid])
        end = min(off + rl, u.len)
        depth[off] += 1
        depth[end] -= 1
        off += int(u.node_len[k])
    return np.cumsum(depth[:-1])


def break_by_coverage(ug: UnitigGraph, cov: CoverageCut,
                      b_low: int = 0, b_high: int = -1,
                      min_run: int = 2000) -> int:
    """Break unitigs at abnormal-coverage positions (--b-cov/--h-cov,
    CommandLines.cpp:316-318): a >= min_run stretch with depth < b_low
    (or > b_high) in the unitig interior marks a likely misassembly;
    split at its center. Returns #breaks applied."""
    if b_low <= 0 and b_high < 0:
        return 0
    n_broken = 0
    for uid in range(len(ug.utgs)):       # appended halves re-examined
        while True:
            u = ug.utgs[uid]
            if len(u.vs) < 2 or u.len < 3 * min_run:
                break
            prof = unitig_depth_profile(u, cov)
            bad = np.zeros(u.len, bool)
            if b_low > 0:
                bad |= prof < b_low
            if b_high >= 0:
                bad |= prof > b_high
            bad[:min_run] = False          # unitig ends taper naturally
            bad[-min_run:] = False
            if not bad.any():
                break
            edges = np.flatnonzero(np.diff(bad.astype(np.int8)))
            runs = [(int(s) + 1, int(e) + 1)
                    for s, e in zip(edges[:-1], edges[1:])
                    if bad[s + 1] and e - s >= min_run]
            if not runs:
                break
            s, e = runs[0]
            if not split_unitig(ug, uid, (s + e) // 2):
                break
            n_broken += 1                 # loop re-examines the left part
    if n_broken:
        log("break_by_coverage", f"{n_broken} coverage breaks")
    return n_broken


def flip_unitig(u: Unitig, cov: CoverageCut) -> Unitig:
    """Reverse-complement a unitig's read path.

    Forward read i starts at S_i = sum(node_len[:i]) and ends at
    S_i + extent_i; in reversed coordinates (length L) it spans
    [L - end_i, L - S_i], so the reversed node lengths are the
    differences of the forward END positions (last = extent of the
    original first read). Verified by unitig_seq(flip(u)) ==
    revcomp(unitig_seq(u))."""
    n = len(u.vs)
    ext = np.array([int(cov.e[int(v) >> 1] - cov.s[int(v) >> 1])
                    for v in u.vs], np.int64)
    starts = np.concatenate([[0], np.cumsum(u.node_len[:-1])])
    ends = starts + ext
    vs = (u.vs[::-1] ^ 1).astype(np.uint32)
    node_len = np.empty(n, np.int64)
    if n > 1:
        node_len[:n - 1] = (ends[::-1][:-1] - ends[::-1][1:])
    node_len[n - 1] = ext[0]
    return Unitig(vs=vs, node_len=node_len, len=int(node_len.sum()),
                  circ=u.circ, start=int(vs[0]),
                  end=int(vs[-1]) ^ 1)


def ug_post_join(ug: UnitigGraph, cov: CoverageCut) -> int:
    """Post-join (-u, CommandLines.cpp:126): merge unitig pairs left
    mutually unique by the contig-level cleanups (tip removal etc.);
    ma_ug_gen only merges chains that were unambiguous in the READ
    graph. The junction read keeps extent - overlap as its node length.
    Returns the number of joins applied."""
    n_join = 0
    while True:
        n = len(ug.utgs)
        if n == 0 or len(ug.a_src) == 0:
            break
        deg = np.bincount(ug.a_src.astype(np.int64), minlength=2 * n)
        src = ug.a_src.astype(np.int64)
        dst = ug.a_dst.astype(np.int64)
        pick = -1
        for k in range(len(src)):
            s, d, ol = int(src[k]), int(dst[k]), int(ug.a_ol[k])
            if ol <= 0:
                continue                   # bridged arc: no real overlap
            if (s >> 1) == (d >> 1):
                continue
            if deg[s] != 1 or deg[d ^ 1] != 1:
                continue                   # not mutually unique
            if ug.utgs[s >> 1].circ or ug.utgs[d >> 1].circ:
                continue
            # the junction read must cover the whole arc overlap: if ol
            # exceeds the last read's coverage-cut extent, trimming only
            # that read would duplicate ol - extent bases in the merged
            # contig -- skip the join
            ja = ug.utgs[s >> 1]
            jread = int(ja.vs[-1] if (s & 1) == 0 else ja.vs[0]) >> 1
            if ol > int(cov.e[jread] - cov.s[jread]):
                continue
            pick = k
            break
        if pick < 0:
            break
        s, d, ol = int(src[pick]), int(dst[pick]), int(ug.a_ol[pick])
        ua, da = s >> 1, s & 1
        ub, db = d >> 1, d & 1
        a = ug.utgs[ua] if da == 0 else flip_unitig(ug.utgs[ua], cov)
        b = ug.utgs[ub] if db == 0 else flip_unitig(ug.utgs[ub], cov)
        # junction: a's last read contributes extent - ol
        last = int(a.vs[-1])
        ext_last = int(cov.e[last >> 1] - cov.s[last >> 1])
        nl = a.node_len.copy()
        nl[-1] = max(ext_last - ol, 0)
        merged = Unitig(
            vs=np.concatenate([a.vs, b.vs]).astype(np.uint32),
            node_len=np.concatenate([nl, b.node_len]),
            len=int(nl.sum() + b.node_len.sum()), circ=False,
            start=int(a.vs[0]), end=int(b.vs[-1]) ^ 1)
        # merged takes ua's slot (orientation: a-forward); arcs at the
        # consumed ends disappear; outer ends remap
        keep = np.ones(len(src), bool)
        keep[pick] = False
        comp = (src == (d ^ 1)) & (dst == (s ^ 1))
        keep[comp] = False
        src2, dst2, ol2 = src[keep], dst[keep], ug.a_ol[keep]

        def remap(v):
            # leaving a's outer end = ua<<1|(da^1) -> merged reverse-leave
            out = np.where(v == (ua << 1 | (1 ^ da)), ua << 1 | 1, v)
            # leaving b's outer end = ub<<1|db -> merged forward-leave
            out = np.where(out == (ub << 1 | db), ua << 1, out)
            return out

        # entering arcs use the complement vertex of the end they enter
        src2 = remap(src2)
        dst2 = np.where(dst2 == (ua << 1 | (0 ^ da)), ua << 1, dst2)
        dst2 = np.where(dst2 == (ub << 1 | (1 ^ db)), ua << 1 | 1, dst2)
        ug.utgs[ua] = merged
        drop = np.zeros(n, bool)
        drop[ub] = True
        remap_id = np.cumsum(~drop) - 1
        ug.utgs = [u for i, u in enumerate(ug.utgs) if not drop[i]]
        keep2 = ~drop[src2 >> 1] & ~drop[dst2 >> 1]
        src2, dst2, ol2 = src2[keep2], dst2[keep2], ol2[keep2]
        ug.a_src = ((remap_id[src2 >> 1] << 1) | (src2 & 1)).astype(
            np.uint32)
        ug.a_dst = ((remap_id[dst2 >> 1] << 1) | (dst2 & 1)).astype(
            np.uint32)
        ug.a_ol = ol2
        n_join += 1
    if n_join:
        log("ug_post_join", f"joined {n_join} unitig pairs")
    return n_join
