"""Anchor collection and overlap-candidate generation.

~``minimizers_qgen0`` + ``lchain_qgen_mcopy_fast`` + ``ha_ov_type`` quotas
(anchor.cpp:987-1082, :86-91; Hash_Table.cpp:1840+). Per query read:
query minimizers against the position table, build anchors in the query
orientation frame, group by (target, strand), chain each group, and keep at
most max_n_chain overlaps per overlap type.

Coordinate convention (matches the reference): anchor coordinates are k-mer
END positions; for rev anchors the target coordinate is flipped to the query
frame: offset = tlen-1-(pos+1-span) (anchor.cpp:1033).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from hifiasm_tpu_torch.index.pos_table import PositionTable
from hifiasm_tpu_torch.ops.chain import ChainParams, chain_dp_group, _chain_len
from hifiasm_tpu_torch.ops.sketch import Minimizers

HA_KMER_GOOD_RATIO = 0.333


@dataclass
class Anchors:
    tid: np.ndarray        # uint32 target read
    rev: np.ndarray        # uint8
    self_off: np.ndarray   # int64 query k-mer end
    t_off: np.ndarray      # int64 target k-mer end (query frame if rev)
    span: np.ndarray       # int64
    weight: np.ndarray     # int64 occurrence-class weight

    def __len__(self):
        return len(self.tid)


@dataclass
class OverlapRegions:
    """Columnar overlap candidates (~overlap_region_alloc)."""

    x_id: int
    y_id: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    rev: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    x_s: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    x_e: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    y_s: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    y_e: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    score: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    n_hits: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # chain hits, CSR per overlap
    hit_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    hit_self: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    hit_t: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    hit_span: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # device-resident hits: handle into DeviceChunkChains chain rows
    # (overlap/chain_device.py); host hit arrays stay empty then
    hit_ref: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def __len__(self):
        return len(self.y_id)

    def take(self, idx: np.ndarray) -> "OverlapRegions":
        idx = np.asarray(idx, np.int64)
        out = OverlapRegions(self.x_id)
        out.y_id = self.y_id[idx]
        out.rev = self.rev[idx]
        out.x_s, out.x_e = self.x_s[idx], self.x_e[idx]
        out.y_s, out.y_e = self.y_s[idx], self.y_e[idx]
        out.score, out.n_hits = self.score[idx], self.n_hits[idx]
        if len(self.hit_ref):
            out.hit_ref = self.hit_ref[idx]
        if len(self.hit_self) == 0 and len(self.n_hits) and \
                self.n_hits.max(initial=0) > 0 and len(self.hit_ref):
            # device-resident hits: nothing to regather on host
            out.hit_start = np.zeros(len(idx), np.int64)
            return out
        # regather hits: one segmented gather (no per-overlap python loop)
        n = self.n_hits[idx].astype(np.int64)
        bounds = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(n, out=bounds[1:])
        tot = int(bounds[-1])
        seg = np.arange(tot) - np.repeat(bounds[:-1], n)
        src = np.repeat(self.hit_start[idx], n) + seg
        out.hit_start = bounds[:-1]
        out.hit_self = self.hit_self[src]
        out.hit_t = self.hit_t[src]
        out.hit_span = self.hit_span[src]
        return out


def collect_anchors_many(mzs, pt: PositionTable, rids, tlens: np.ndarray,
                         hom_cov: int, chunk_mz: int = 200_000):
    """Anchor collection for MANY reads: one postings expansion and one
    global lexsort per chunk instead of per-read numpy passes."""
    max_cnt = max(int(hom_cov * (2.0 - HA_KMER_GOOD_RATIO)), 2)
    min_cnt = max(int(hom_cov * HA_KMER_GOOD_RATIO), 2)
    out = [None] * len(rids)
    empty = lambda: Anchors(*(np.zeros(0, t) for t in (
        np.uint32, np.uint8, np.int64, np.int64, np.int64, np.int64)))
    try:
        from hifiasm_tpu_torch.native import collect_anchors_native, get_lib
        native_ok = get_lib() is not None
    except Exception:
        native_ok = False
    c0 = 0
    while c0 < len(rids):
        c1, nm = c0, 0
        while c1 < len(rids) and nm < chunk_mz:
            nm += len(mzs[rids[c1]])
            c1 += 1
        if native_ok:
            nat = collect_anchors_native(mzs, pt, rids[c0:c1], tlens,
                                         hom_cov)
            if nat is not None:
                for x, an in zip(range(c0, c1), nat):
                    out[x] = an
                c0 = c1
                continue
        # concat this chunk's minimizers with their query read ids
        h_l, q_l, qp_l, qr_l, qs_l = [], [], [], [], []
        for x in range(c0, c1):
            rid = rids[x]
            mz = mzs[rid]
            n = len(mz)
            h_l.append(mz.hash)
            q_l.append(np.full(n, rid, np.int64))
            qp_l.append(mz.pos.astype(np.int64))
            qr_l.append(mz.rev)
            qs_l.append(mz.span.astype(np.int64))
        allh = np.concatenate(h_l) if h_l else np.zeros(0, np.uint64)
        if len(allh) == 0 or pt.n_distinct == 0:
            for x in range(c0, c1):
                out[x] = empty()
            c0 = c1
            continue
        qread = np.concatenate(q_l)
        qpos_all = np.concatenate(qp_l)
        qrev_all = np.concatenate(qr_l)
        qspan_all = np.concatenate(qs_l)
        slot, found = pt.lookup_many(allh)
        qsel = np.flatnonzero(found)
        starts = pt.start[slot[qsel]]
        counts = pt.count[slot[qsel]]
        if int(counts.sum()) == 0:
            for x in range(c0, c1):
                out[x] = empty()
            c0 = c1
            continue
        qidx = np.repeat(qsel, counts)
        post = _expand_ranges(starts, counts)
        tid = pt.rid[post].astype(np.uint32)
        tpos = pt.pos[post].astype(np.int64)
        trev = pt.rev[post]
        tspan = pt.span[post].astype(np.int64)
        qread_a = qread[qidx]
        keep = tid.astype(np.int64) != qread_a
        qidx, tid, tpos, trev, tspan, qread_a = (
            qidx[keep], tid[keep], tpos[keep], trev[keep], tspan[keep],
            qread_a[keep])
        qrev = qrev_all[qidx]
        qpos = qpos_all[qidx]
        qspan = qspan_all[qidx]
        occ = np.repeat(counts, counts)[keep].astype(np.int64)
        by_rid = finish_anchor_chunk(qread_a, qpos, qrev, qspan, tid, tpos,
                                     trev, tspan, occ, tlens, min_cnt,
                                     max_cnt)
        for x in range(c0, c1):
            out[x] = by_rid.get(rids[x], None) or empty()
        c0 = c1
    return out


def finish_anchor_chunk(qread_a, qpos, qrev, qspan, tid, tpos, trev, tspan,
                        occ, tlens, min_cnt, max_cnt):
    """Posting columns -> per-read Anchors: occurrence-class weights
    (anchor.cpp:1063-1071), target forward-frame offset, and the
    (qread, tid, rev, qpos, t_off) lexsort.  Shared by the host gather
    (collect_anchors_many) and the mesh all_to_all gather
    (parallel/ec_shard.py) so both produce byte-identical anchors."""
    rev = (qrev != trev).astype(np.uint8)
    tl = tlens[tid].astype(np.int64)
    t_off = np.where(rev == 0, tpos, tl - 1 - (tpos + 1 - tspan))
    w = np.ones(len(occ), np.int64)
    w[occ <= min_cnt] = 2
    hi = occ >= max_cnt
    wh = 1 + ((occ[hi] + (max_cnt << 1) - 1) // (max_cnt << 1))
    w[hi] = np.floor(np.power(wh.astype(np.float64), 1.1)
                     ).astype(np.int64)
    w = np.minimum(w, 0xFFFFFF)
    order = np.lexsort((t_off, qpos, rev, tid, qread_a))
    qread_s = qread_a[order]
    bnd = np.flatnonzero(np.diff(qread_s)) + 1
    seg_s = np.concatenate([[0], bnd]) if len(qread_s) else []
    seg_e = np.concatenate([bnd, [len(qread_s)]]) if len(qread_s) else []
    by_rid = {}
    for s, e in zip(seg_s, seg_e):
        sl = order[s:e]
        by_rid[int(qread_s[s])] = Anchors(
            tid[sl], rev[sl], qpos[sl], t_off[sl], qspan[sl], w[sl])
    return by_rid


def collect_anchors(mz: Minimizers, pt: PositionTable, rid: int,
                    tlens: np.ndarray, hom_cov: int) -> Anchors:
    """Query each minimizer, expand postings into anchors, sort."""
    max_cnt = max(int(hom_cov * (2.0 - HA_KMER_GOOD_RATIO)), 2)
    min_cnt = max(int(hom_cov * HA_KMER_GOOD_RATIO), 2)

    slot, found = pt.lookup_many(mz.hash) if pt.n_distinct else (None, None)
    if slot is None or not found.any():
        z = np.zeros(0, np.int64)
        return Anchors(z.astype(np.uint32), z.astype(np.uint8), z, z, z, z)
    qsel = np.flatnonzero(found)
    starts = pt.start[slot[qsel]]
    counts = pt.count[slot[qsel]]
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return Anchors(z.astype(np.uint32), z.astype(np.uint8), z, z, z, z)
    # expand CSR ranges
    qidx = np.repeat(qsel, counts)
    post = _expand_ranges(starts, counts)

    tid = pt.rid[post].astype(np.uint32)
    tpos = pt.pos[post].astype(np.int64)
    trev = pt.rev[post]
    tspan_idx = pt.span[post].astype(np.int64)

    keep = tid != rid
    qidx, tid, tpos, trev, tspan_idx = (
        qidx[keep], tid[keep], tpos[keep], trev[keep], tspan_idx[keep])

    qrev = mz.rev[qidx]
    qpos = mz.pos[qidx].astype(np.int64)
    qspan = mz.span[qidx].astype(np.int64)
    occ = np.repeat(counts, counts)[keep].astype(np.int64)

    rev = (qrev != trev).astype(np.uint8)
    tl = tlens[tid].astype(np.int64)
    t_off = np.where(rev == 0, tpos, tl - 1 - (tpos + 1 - tspan_idx))

    # occurrence-class weight (anchor.cpp:1063-1071)
    w = np.ones(len(occ), dtype=np.int64)
    w[occ <= min_cnt] = 2
    hi = occ >= max_cnt
    wh = 1 + ((occ[hi] + (max_cnt << 1) - 1) // (max_cnt << 1))
    w[hi] = np.floor(np.power(wh.astype(np.float64), 1.1)).astype(np.int64)
    w = np.minimum(w, 0xFFFFFF)

    order = np.lexsort((t_off, qpos, rev, tid))
    return Anchors(tid[order], rev[order], qpos[order], t_off[order],
                   qspan[order], w[order])


def _expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """[s0,s0+1..s0+c0-1, s1...] as one flat index array."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    out = np.ones(total, dtype=np.int64)
    out[0] = starts[0]
    out[ends[:-1]] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(out)


def chain_anchors(an: Anchors, rid: int, rlen: int, tlens: np.ndarray,
                  params: ChainParams, max_n_chain: int = 100
                  ) -> OverlapRegions:
    """Chain per (tid, rev) group -> overlap regions with quota filter."""
    return chain_many([(rid, an, rlen)], tlens, params, max_n_chain)[0]


def chain_many(reads, tlens: np.ndarray, params: ChainParams,
               max_n_chain: int = 100,
               device_threshold: Optional[int] = None,
               flat: bool = False, device="cuda"):
    """Chain anchors of MANY reads at once.

    ``reads``: [(rid, Anchors, rlen)].  All (target, strand) groups across
    all reads are bucketed by size, padded, and scored by the vectorized
    DP in a few large launches; only the cheap per-group traceback /
    multi-copy extraction stays scalar.  With ``device_threshold``,
    buckets with >= device_threshold cells score on ``device``
    (ops/chain_dev.chain_scores_batch) and smaller buckets on the numpy
    mirror; the JAX package takes that route only on an accelerator
    backend, the port on the device it is given.
    """
    from hifiasm_tpu_torch.ops.chain import chain_scores_batch_np, extract_chains

    # the device chain scorer is opt-in (pass device_threshold): the host
    # native kernel wins below enormous batch sizes, and the scorer bakes
    # the HiFi k=51 penalty constants
    use_device = device_threshold is not None

    # native whole-batch DP + traceback on host when available: columns
    # are plain concatenations of the per-read anchor arrays (groups are
    # contiguous (tid, rev) runs within each read), group bounds come
    # from one key-change scan — no per-group copy loop
    if not use_device:
        try:
            from hifiasm_tpu_torch.native import chain_groups_native, get_lib
        except Exception:
            get_lib = lambda: None  # noqa: E731
        if get_lib() is not None:
            nz = [(ridx, an, rlen) for ridx, (rid, an, rlen)
                  in enumerate(reads) if len(an)]
            if not nz:
                out = [_assemble_regions(rid, an, rlen, tlens, [],
                                         max_n_chain)
                       for rid, an, rlen in reads]
                return _flat_from_regions(out) if flat else out
            so = np.concatenate([an.self_off for _, an, _ in nz]
                                ).astype(np.int64, copy=False)
            to = np.concatenate([an.t_off for _, an, _ in nz]
                                ).astype(np.int64, copy=False)
            sp = np.concatenate([an.span for _, an, _ in nz]
                                ).astype(np.int64, copy=False)
            w = np.concatenate([an.weight for _, an, _ in nz]
                               ).astype(np.int64, copy=False)
            tid_all = np.concatenate([an.tid for _, an, _ in nz]
                                     ).astype(np.int64, copy=False)
            rev_all = np.concatenate([an.rev for _, an, _ in nz])
            n_per = np.array([len(an) for _, an, _ in nz], np.int64)
            ridx_all = np.repeat(
                np.array([ridx for ridx, _, _ in nz], np.int64), n_per)
            rlen_of = np.zeros(len(reads), np.int64)
            for ridx, _, rlen in nz:
                rlen_of[ridx] = rlen
            key = (ridx_all << 33) | (tid_all << 1) | rev_all
            cut = np.flatnonzero(key[1:] != key[:-1]) + 1
            off = np.concatenate([[0], cut, [len(key)]]).astype(np.int64)
            gstart = off[:-1]
            read_g = ridx_all[gstart]
            tid_g = tid_all[gstart]
            rev_g = rev_all[gstart]
            xlg = rlen_of[read_g]
            ylg = tlens[tid_g].astype(np.int64)
            cnt, score, start, hits, hit_idx = chain_groups_native(
                off, so, to, sp, w, xlg, ylg, params)
            return _assemble_regions_all(
                reads, off, so, to, sp, xlg, ylg, tid_g, rev_g,
                read_g, cnt, score, start, hits, hit_idx, max_n_chain,
                flat=flat)

    # collect groups across reads (python / device routes)
    groups = []            # (read_idx, s, e, tid, yl)
    for ridx, (rid, an, rlen) in enumerate(reads):
        n = len(an)
        if n == 0:
            continue
        key = an.tid.astype(np.int64) << 1 | an.rev
        bounds = np.flatnonzero(np.diff(key)) + 1
        bounds = np.concatenate([[0], bounds, [n]])
        for gi in range(len(bounds) - 1):
            s, e = int(bounds[gi]), int(bounds[gi + 1])
            groups.append((ridx, s, e, int(an.tid[s]),
                           int(tlens[an.tid[s]])))

    chains_of = {}
    if not use_device:
        # python fallback: scalar reference-semantics oracle per group
        # (quick_check / max_skip pruning, same as the native kernel)
        from hifiasm_tpu_torch.ops.chain import chain_dp_group

        for g, (ridx, s, e, tid, yl) in enumerate(groups):
            _, an, rlen = reads[ridx]
            chains_of[g] = chain_dp_group(
                an.self_off[s:e].astype(np.int64),
                an.t_off[s:e].astype(np.int64),
                an.span[s:e].astype(np.int64),
                an.weight[s:e].astype(np.int64), rlen, yl, params)
        out = _finish_chain_many(reads, groups, chains_of, tlens,
                                 max_n_chain)
        return _flat_from_regions(out) if flat else out

    # device route: score in size buckets (unpruned batched scorer)
    sizes = np.array([e - s for _, s, e, _, _ in groups], np.int64)
    order = np.argsort(sizes, kind="stable")
    buckets = [32, 128, 512, 2048, 8192, 1 << 30]
    pos = 0
    for cap in buckets:
        end = pos
        while end < len(order) and sizes[order[end]] <= cap:
            end += 1
        sel = [int(g) for g in order[pos:end]]
        pos = end
        if not sel:
            continue
        N = int(sizes[sel].max())
        G = len(sel)
        cols = [np.zeros((G, N), np.int64) for _ in range(4)]
        narr = np.zeros(G, np.int64)
        xlarr = np.zeros(G, np.int64)
        ylarr = np.zeros(G, np.int64)
        for bi, g in enumerate(sel):
            ridx, s, e, tid, yl = groups[g]
            _, an, rlen = reads[ridx]
            m = e - s
            cols[0][bi, :m] = an.self_off[s:e]
            cols[1][bi, :m] = an.t_off[s:e]
            cols[2][bi, :m] = an.span[s:e]
            cols[3][bi, :m] = an.weight[s:e]
            narr[bi] = m
            xlarr[bi] = rlen
            ylarr[bi] = yl
        if G * N >= device_threshold and N <= 2048:
            import torch

            from hifiasm_tpu_torch.device import resolve_device
            from hifiasm_tpu_torch.ops.chain_dev import chain_scores_batch

            # pad G to a power of two, as the JAX package bounds its
            # compiled shapes
            Gp = 256
            while Gp < G:
                Gp *= 2
            pad = Gp - G
            dev = resolve_device(device)
            cols = [np.concatenate([c, np.zeros((pad, N), np.int64)])
                    for c in cols]
            narr_p = np.concatenate([narr, np.zeros(pad, np.int64)])
            xl_p = np.concatenate([xlarr, np.ones(pad, np.int64)])
            yl_p = np.concatenate([ylarr, np.ones(pad, np.int64)])
            fd, pd = chain_scores_batch(
                *(torch.as_tensor(a.astype(np.int32)).to(dev)
                  for a in (*cols, narr_p, xl_p, yl_p)),
                pg_q16=params.pg_q16, pskip_q16=params.pskip_q16,
                bw_q16=params.bw_q16, invbw_q4=params.invbw_q4)
            f = fd.cpu().numpy()[:G].astype(np.int64)
            pre = pd.cpu().numpy()[:G].astype(np.int64)
        else:
            f, pre = chain_scores_batch_np(cols[0], cols[1], cols[2],
                                           cols[3], narr, xlarr, ylarr,
                                           params)
        for bi, g in enumerate(sel):
            ridx, s, e, tid, yl = groups[g]
            _, an, rlen = reads[ridx]
            m = e - s
            chains_of[g] = extract_chains(
                f[bi, :m], pre[bi, :m], an.self_off[s:e].astype(np.int64),
                an.t_off[s:e].astype(np.int64), rlen, yl, params)

    out = _finish_chain_many(reads, groups, chains_of, tlens, max_n_chain)
    return _flat_from_regions(out) if flat else out


def _finish_chain_many(reads, groups, chains_of, tlens, max_n_chain):
    """Assemble per-read overlap regions from per-group chains."""
    out = []
    g_by_read = {}
    for g, (ridx, s, e, tid, yl) in enumerate(groups):
        g_by_read.setdefault(ridx, []).append(g)
    for ridx, (rid, an, rlen) in enumerate(reads):
        out.append(_assemble_regions(
            rid, an, rlen, tlens,
            [(groups[g], chains_of[g]) for g in g_by_read.get(ridx, [])],
            max_n_chain))
    return out


def _assemble_regions(rid: int, an: Anchors, rlen: int, tlens: np.ndarray,
                      group_chains, max_n_chain: int) -> OverlapRegions:
    ov = OverlapRegions(rid)
    ys, revs, xss, xes, yss, yes, scores, nhits = [], [], [], [], [], [], [], []
    hit_self, hit_t, hit_span, hit_start = [], [], [], []
    off = 0
    for (ridx, s, e, tid, yl), chains in group_chains:
        for sc, idx in chains:
            gidx = idx + s
            xs, xe = int(an.self_off[gidx[0]]), int(an.self_off[gidx[-1]])
            ts, te = int(an.t_off[gidx[0]]), int(an.t_off[gidx[-1]])
            # extend to boundaries (push_ovlp_chain_qgen, Hash_Table.cpp:1752)
            if xs <= ts:
                ts -= xs
                xs = 0
            else:
                xs -= ts
                ts = 0
            xr, yr = rlen - xe - 1, yl - te - 1
            if xr <= yr:
                xe = rlen - 1
                te += xr
            else:
                te = yl - 1
                xe += yr
            ys.append(tid)
            revs.append(int(an.rev[s]))
            xss.append(xs)
            xes.append(xe)
            yss.append(ts)
            yes.append(te)
            scores.append(sc)
            nhits.append(len(gidx))
            hit_start.append(off)
            hit_self.append(an.self_off[gidx])
            hit_t.append(an.t_off[gidx])
            hit_span.append(an.span[gidx])
            off += len(gidx)

    ov.y_id = np.array(ys, dtype=np.uint32)
    ov.rev = np.array(revs, dtype=np.uint8)
    ov.x_s = np.array(xss, dtype=np.int64)
    ov.x_e = np.array(xes, dtype=np.int64)
    ov.y_s = np.array(yss, dtype=np.int64)
    ov.y_e = np.array(yes, dtype=np.int64)
    ov.score = np.array(scores, dtype=np.int64)
    ov.n_hits = np.array(nhits, dtype=np.int64)
    ov.hit_start = np.array(hit_start, dtype=np.int64)
    ov.hit_self = np.concatenate(hit_self) if hit_self else np.zeros(0, np.int64)
    ov.hit_t = np.concatenate(hit_t) if hit_t else np.zeros(0, np.int64)
    ov.hit_span = np.concatenate(hit_span) if hit_span else np.zeros(0, np.int64)

    return _finish_regions(ov, rlen, max_n_chain)


def _finish_regions(ov: OverlapRegions, rlen: int, max_n_chain: int
                    ) -> OverlapRegions:
    """Quota filter + dedup + final (x_s, y_id) order as ONE take()."""
    idx = _quota_keep_idx(ov.score, ov.x_s, ov.x_e, rlen, max_n_chain)
    if idx is not None:
        keep2 = _dedup_keep_mask(ov.y_id[idx], ov.rev[idx], ov.x_s[idx],
                                 ov.x_e[idx], ov.score[idx])
        idx = idx[keep2]
        order = np.lexsort((ov.y_id[idx], ov.x_s[idx]))
        return ov.take(idx[order])
    keep = _dedup_keep_mask(ov.y_id, ov.rev, ov.x_s, ov.x_e, ov.score)
    if keep.all():
        order = np.lexsort((ov.y_id, ov.x_s))
        return ov.take(order)
    idx = np.flatnonzero(keep)
    order = np.lexsort((ov.y_id[idx], ov.x_s[idx]))
    return ov.take(idx[order])


def _quota_keep_idx(score, x_s, x_e, rlen: int, max_n_chain: int):
    """Per-class quota keep-indices (None = keep everything)."""
    n = len(score)
    if n <= max_n_chain:
        return None
    w = ha_ov_type(x_s, x_e, rlen)
    order = np.argsort(-score, kind="stable")
    thresh = np.zeros(4, dtype=np.int64)
    seen = np.zeros(4, dtype=np.int64)
    for i in order:
        c = int(w[i])
        seen[c] += 1
        if seen[c] == max_n_chain:
            thresh[c] = score[i]
    if (thresh > 0).any():
        return np.flatnonzero(score >= thresh[w])
    return None


def _dedup_keep_mask(y_id, rev, x_s, x_e, score) -> np.ndarray:
    """Keep-mask of dedup_overlaps on plain columns."""
    n = len(y_id)
    keep = np.ones(n, bool)
    if n <= 1:
        return keep
    key = y_id.astype(np.int64) << 1 | rev
    order = np.lexsort((-score, key))
    for i in range(n):
        a = order[i]
        if not keep[a]:
            continue
        for j in range(i + 1, n):
            b = order[j]
            if key[b] != key[a]:
                break
            if not keep[b]:
                continue
            inter = min(x_e[a], x_e[b]) - max(x_s[a], x_s[b])
            min_len = min(x_e[a] - x_s[a], x_e[b] - x_s[b]) + 1
            if inter > 0.5 * min_len:
                keep[b] = False
    return keep


def _assemble_regions_all(reads, off, so, to, sp, xlg, ylg, tid_g, rev_g,
                          read_g, cnt, score, start, hits, hit_idx,
                          max_n_chain, flat=False):
    """Vectorized region assembly over ALL chains of a chain_many batch
    (same per-chain math as _assemble_regions; chains stay in (group,
    copy) order so results are identical).  With flat=True returns one
    dict of batch-level columns (r_ov_off + per-overlap/hit arrays)
    instead of per-read OverlapRegions."""
    G = len(cnt)
    mc = score.shape[1] if G else 0
    mask = np.arange(mc)[None, :] < cnt[:, None] if G \
        else np.zeros((0, 0), bool)
    g_of = np.repeat(np.arange(G), cnt)
    sc_f = score[mask]
    st_f = start[mask]
    nh_f = hits[mask]
    goff = off[g_of] if len(g_of) else np.zeros(0, np.int64)
    if len(g_of):
        first = hit_idx[st_f] + goff
        last = hit_idx[st_f + nh_f - 1] + goff
        xs = so[first]
        xe = so[last]
        ts = to[first]
        te = to[last]
        # extend to boundaries (push_ovlp_chain_qgen, Hash_Table.cpp:1752)
        shift = np.minimum(xs, ts)
        xs2, ts2 = xs - shift, ts - shift
        rlen_f = xlg[g_of]
        ext = np.minimum(rlen_f - xe - 1, ylg[g_of] - te - 1)
        xe2, te2 = xe + ext, te + ext
    else:
        xs2 = ts2 = xe2 = te2 = np.zeros(0, np.int64)
    # flat chain-hit gather (hit_idx slices are contiguous per chain)
    hs_glob = np.zeros(len(nh_f) + 1, np.int64)
    np.cumsum(nh_f, out=hs_glob[1:])
    tot_h = int(hs_glob[-1])
    seg = np.arange(tot_h) - np.repeat(hs_glob[:-1], nh_f)
    rep = np.repeat(st_f, nh_f) + seg
    hidx = hit_idx[rep] + np.repeat(goff, nh_f)
    hit_self_f = so[hidx]
    hit_t_f = to[hidx]
    hit_span_f = sp[hidx]
    # chains are grouped by read (groups are built in read order)
    read_of_chain = read_g[g_of] if len(g_of) else np.zeros(0, np.int64)
    cb = np.searchsorted(read_of_chain, np.arange(len(reads) + 1)
                         ).astype(np.int64)
    y_id_f = tid_g[g_of] if len(g_of) else np.zeros(0, np.int64)
    rev_f = rev_g[g_of] if len(g_of) else np.zeros(0, np.uint8)
    rlen_of = np.array([rlen for _, _, rlen in reads], np.int64)

    # batched native finishing (quota + dedup + (x_s, y_id) order) over
    # the flat columns; python per-read fallback when unavailable
    fin = None
    try:
        from hifiasm_tpu_torch.native import finish_regions_native
        fin = finish_regions_native(cb, sc_f, xs2, xe2, y_id_f, rev_f,
                                    rlen_of, max_n_chain)
    except Exception:
        fin = None
    if fin is not None:
        idx, new_off = fin
        nh_k = nh_f[idx]
        hb = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(nh_k, out=hb[1:])
        segk = np.arange(int(hb[-1])) - np.repeat(hb[:-1], nh_k)
        hsrc = np.repeat(hs_glob[idx], nh_k) + segk
        cols = dict(
            r_ov_off=new_off,
            y_id=y_id_f[idx], rev=rev_f[idx],
            x_s=xs2[idx], x_e=xe2[idx], y_s=ts2[idx], y_e=te2[idx],
            score=sc_f[idx], n_hits=nh_k, hit_off=hb[:-1],
            hit_self=hit_self_f[hsrc], hit_t=hit_t_f[hsrc],
            hit_span=hit_span_f[hsrc])
        if flat:
            return cols
        out = []
        for ridx, (rid, an, rlen) in enumerate(reads):
            c0, c1 = int(new_off[ridx]), int(new_off[ridx + 1])
            ov = OverlapRegions(rid)
            ov.y_id = cols["y_id"][c0:c1].astype(np.uint32)
            ov.rev = cols["rev"][c0:c1]
            ov.x_s = cols["x_s"][c0:c1]
            ov.x_e = cols["x_e"][c0:c1]
            ov.y_s = cols["y_s"][c0:c1]
            ov.y_e = cols["y_e"][c0:c1]
            ov.score = cols["score"][c0:c1]
            ov.n_hits = cols["n_hits"][c0:c1]
            h0 = int(hb[c0])
            ov.hit_start = hb[c0:c1] - h0
            ov.hit_self = cols["hit_self"][h0:int(hb[c1])]
            ov.hit_t = cols["hit_t"][h0:int(hb[c1])]
            ov.hit_span = cols["hit_span"][h0:int(hb[c1])]
            out.append(ov)
        return out

    out = []
    for ridx, (rid, an, rlen) in enumerate(reads):
        c0, c1 = int(cb[ridx]), int(cb[ridx + 1])
        ov = OverlapRegions(rid)
        gsl = g_of[c0:c1]
        ov.y_id = tid_g[gsl].astype(np.uint32)
        ov.rev = rev_g[gsl]
        ov.x_s = xs2[c0:c1]
        ov.x_e = xe2[c0:c1]
        ov.y_s = ts2[c0:c1]
        ov.y_e = te2[c0:c1]
        ov.score = sc_f[c0:c1]
        ov.n_hits = nh_f[c0:c1]
        h0, h1 = int(hs_glob[c0]), int(hs_glob[c1])
        ov.hit_start = hs_glob[c0:c1] - h0
        ov.hit_self = hit_self_f[h0:h1]
        ov.hit_t = hit_t_f[h0:h1]
        ov.hit_span = hit_span_f[h0:h1]
        out.append(_finish_regions(ov, rlen, max_n_chain))
    if flat:
        return _flat_from_regions(out)
    return out


def _flat_from_regions(regions) -> dict:
    """Batch-level flat columns from per-read OverlapRegions."""
    R = len(regions)
    r_ov_off = np.zeros(R + 1, np.int64)
    for j, ov in enumerate(regions):
        r_ov_off[j + 1] = r_ov_off[j] + len(ov)
    hlens = np.array([len(ov.hit_self) for ov in regions], np.int64)
    hbase = np.concatenate([[0], np.cumsum(hlens[:-1])]) if R else \
        np.zeros(0, np.int64)
    cat = np.concatenate
    return dict(
        r_ov_off=r_ov_off,
        y_id=cat([ov.y_id for ov in regions]).astype(np.int64),
        rev=cat([ov.rev for ov in regions]),
        x_s=cat([ov.x_s for ov in regions]),
        x_e=cat([ov.x_e for ov in regions]),
        y_s=cat([ov.y_s for ov in regions]),
        y_e=cat([ov.y_e for ov in regions]),
        score=cat([ov.score for ov in regions]),
        n_hits=cat([ov.n_hits for ov in regions]),
        hit_off=cat([ov.hit_start + hbase[j]
                     for j, ov in enumerate(regions)]),
        hit_self=cat([ov.hit_self for ov in regions]),
        hit_t=cat([ov.hit_t for ov in regions]),
        hit_span=cat([ov.hit_span for ov in regions]))


def regions_from_flat(cols: dict, j: int, rid: int) -> OverlapRegions:
    """Materialize read j's OverlapRegions view from flat batch columns."""
    c0, c1 = int(cols["r_ov_off"][j]), int(cols["r_ov_off"][j + 1])
    ov = OverlapRegions(rid)
    ov.y_id = cols["y_id"][c0:c1].astype(np.uint32)
    ov.rev = cols["rev"][c0:c1]
    ov.x_s = cols["x_s"][c0:c1]
    ov.x_e = cols["x_e"][c0:c1]
    ov.y_s = cols["y_s"][c0:c1]
    ov.y_e = cols["y_e"][c0:c1]
    ov.score = cols["score"][c0:c1]
    ov.n_hits = cols["n_hits"][c0:c1]
    if c1 > c0:
        h0 = int(cols["hit_off"][c0])
        n_last = int(cols["n_hits"][c1 - 1])
        h1 = int(cols["hit_off"][c1 - 1]) + n_last
        ov.hit_start = cols["hit_off"][c0:c1] - h0
        ov.hit_self = cols["hit_self"][h0:h1]
        ov.hit_t = cols["hit_t"][h0:h1]
        ov.hit_span = cols["hit_span"][h0:h1]
    return ov


def dedup_overlaps(ov: OverlapRegions) -> OverlapRegions:
    """Drop same-(target,strand) chains whose query ranges mostly overlap
    a higher-scoring chain (~dedup_chains, ecovlp.cpp:2984) — keeps
    secondary repeat copies, kills duplicate votes on the same span."""
    keep = _dedup_keep_mask(ov.y_id, ov.rev, ov.x_s, ov.x_e, ov.score)
    if keep.all():
        return ov
    return ov.take(np.flatnonzero(keep))


def ha_ov_type(x_s, x_e, rlen):
    """Overlap class: 0 prefix / 1 suffix / 2 contained / 3 containing
    (anchor.cpp:86-91)."""
    x_s = np.asarray(x_s)
    x_e = np.asarray(x_e)
    out = np.where((x_s == 0) & (x_e == rlen - 1), 2,
                   np.where((x_s > 0) & (x_e < rlen - 1), 3,
                            np.where(x_s == 0, 0, 1)))
    return out


def filter_overlaps_quota(ov: OverlapRegions, rlen: int, max_n_chain: int
                          ) -> OverlapRegions:
    """Keep <= max_n_chain overlaps per ha_ov_type class (by chain score)."""
    idx = _quota_keep_idx(ov.score, ov.x_s, ov.x_e, rlen, max_n_chain)
    if idx is None:
        return ov
    return ov.take(idx)
