"""Mesh-sharded anchor gather for the EC pipeline.

The port of hifiasm_tpu/parallel/ec_shard.py.  The reference reads
postings out of one shared hash table from every worker thread
(``ha_pt_get``, htab.cpp:518).  On a mesh the table is bucket-sharded and
queries go to their owner (parallel/index_shard.py).  This module turns
that primitive into the pipeline's anchor collection, byte-identical to
the host path (overlap/anchors.collect_anchors_many):

- posting lanes are size-classed: one routed call per K class, each
  carrying the full fixed-size query block; a query's answer is taken
  from the smallest class that fits its posting count;
- hashes whose count exceeds the largest class fall back to the host
  table (the high-occurrence tail that the quota weights already
  down-rank), counted in ``n_fallback``, so results stay exact.

Where the JAX package turns the gathered postings into anchors with
numpy (``finish_anchor_chunk``: a lexsort over every posting, most of
its time at 120 Mb), the port hands them, as a table of the chunk's
queried hashes, to the native anchor finish that the host path uses
(``collect_anchors_native``), and keeps the numpy finish for a host
without the native library.  Both give the host path's anchors.
"""

from __future__ import annotations

import numpy as np

from hifiasm_tpu_torch.index.pos_table import PositionTable
from hifiasm_tpu_torch.overlap.anchors import (
    HA_KMER_GOOD_RATIO, Anchors, _expand_ranges, finish_anchor_chunk,
)
from hifiasm_tpu_torch.parallel.index_shard import (
    ShardedPostings, hash_bits, make_sharded_cnt, make_sharded_postings,
)
from hifiasm_tpu_torch.parallel.mesh import Mesh


class MeshAnchorGather:
    """Sharded postings and count tables living on a mesh.  ``q_chunk``
    queries go in one routed call: the JAX package's 2^14 on the CPU, 2^18
    on cards, where each call costs a launch round trip per stage and
    shard."""

    def __init__(self, pt: PositionTable, mesh: Mesh, q_chunk: int = 0,
                 classes=(8, 64)):
        self.pt = pt
        self.mesh = mesh
        S = len(mesh)
        self.S = S
        if q_chunk <= 0:
            q_chunk = 1 << (18 if mesh.devices[0].type == "cuda" else 14)
        self.q_chunk = max(q_chunk // S, 1) * S
        per_dev = self.q_chunk // S
        self.sp = ShardedPostings.build(pt, S)
        # cap = per-shard query count: a lane can never overflow
        self.cnt_fn = make_sharded_cnt(mesh, self.sp.idx, per_dev)
        self.classes = tuple(sorted(classes))
        self.post_fns = {
            K: make_sharded_postings(mesh, self.sp, per_dev, K)
            for K in self.classes
        }
        self.n_fallback = 0

    def gather(self, hashes: np.ndarray):
        """hashes [N] uint64 -> (counts [N] int64, tid, tpos, trev, tspan
        flat posting columns concatenated in query order, CSR within each
        query): exactly what the host table expansion produces."""
        N = len(hashes)
        counts = np.zeros(N, np.int64)
        q_l, r_l, p_l = [], [], []
        kmax = self.classes[-1]
        for c0 in range(0, N, self.q_chunk):
            q = np.asarray(hashes[c0:c0 + self.q_chunk], np.uint64)
            n = len(q)
            qp = np.zeros(self.q_chunk, np.uint64)
            qp[:n] = q
            qd = hash_bits(qp)
            cnt = self.cnt_fn(qd).cpu().numpy()[:n].astype(np.int64)
            counts[c0:c0 + n] = cnt
            prev_k = 0
            for K in self.classes:
                member = np.flatnonzero((cnt > prev_k) & (cnt <= K))
                prev_k = K
                if not len(member):
                    continue
                _, rid, pos = (a.cpu().numpy() for a in self.post_fns[K](qd))
                take = np.arange(K)[None, :] < cnt[member, None]
                q_l.append(np.repeat(member + c0, cnt[member]))
                r_l.append(rid[member][take])
                p_l.append(pos[member][take])
            # host fallback: the high-occurrence tail beyond the largest
            # class
            big = np.flatnonzero(cnt > kmax)
            if len(big):
                self.n_fallback += len(big)
                slot, _ = self.pt.lookup_many(q[big])
                c = self.pt.count[slot].astype(np.int64)
                post = _expand_ranges(self.pt.start[slot], c)
                q_l.append(np.repeat(big + c0, c))
                r_l.append((self.pt.rid[post].astype(np.int64) << 1)
                           | self.pt.rev[post])
                p_l.append((self.pt.span[post].astype(np.int64) << 24)
                           | self.pt.pos[post].astype(np.int64))
        if q_l:
            qi = np.concatenate(q_l)
            order = np.argsort(qi, kind="stable")
            # uint32 lanes, as the JAX package packs them
            r = np.concatenate(r_l)[order].astype(np.int64) & 0xFFFFFFFF
            p = np.concatenate(p_l)[order].astype(np.int64) & 0xFFFFFFFF
        else:
            r = p = np.zeros(0, np.int64)
        return (counts, (r >> 1).astype(np.uint32), p & 0xFFFFFF,
                (r & 1).astype(np.uint8), p >> 24)


def _chunk_table(allh, counts, tid, tpos, trev, tspan) -> PositionTable:
    """The chunk's queried hashes holding the postings the mesh returned
    (query order, CSR by count): for these queries it answers exactly as
    the host table does."""
    off = np.cumsum(counts) - counts
    _, first = np.unique(allh, return_index=True)
    first = first[counts[first] > 0]
    return PositionTable(
        hashes=allh[first], start=off[first],
        count=counts[first].astype(np.int32), rid=tid,
        pos=tpos.astype(np.uint32), rev=trev, span=tspan.astype(np.uint16))


def collect_anchors_mesh(mzs, gather: MeshAnchorGather, rids,
                         tlens: np.ndarray, hom_cov: int,
                         chunk_mz: int = 200_000):
    """Mesh twin of collect_anchors_many: identical Anchors, with the
    posting lookups routed through the sharded index."""
    max_cnt = max(int(hom_cov * (2.0 - HA_KMER_GOOD_RATIO)), 2)
    min_cnt = max(int(hom_cov * HA_KMER_GOOD_RATIO), 2)
    out = [None] * len(rids)
    try:
        from hifiasm_tpu_torch.native import collect_anchors_native, get_lib
        native_ok = get_lib() is not None
    except Exception:
        native_ok = False

    def empty():
        return Anchors(*(np.zeros(0, t) for t in (
            np.uint32, np.uint8, np.int64, np.int64, np.int64, np.int64)))

    c0 = 0
    while c0 < len(rids):
        c1, nm = c0, 0
        while c1 < len(rids) and nm < chunk_mz:
            nm += len(mzs[rids[c1]])
            c1 += 1
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
        if len(allh) == 0:
            for x in range(c0, c1):
                out[x] = empty()
            c0 = c1
            continue
        qread = np.concatenate(q_l)
        qpos_all = np.concatenate(qp_l)
        qrev_all = np.concatenate(qr_l)
        qspan_all = np.concatenate(qs_l)
        counts, tid, tpos, trev, tspan = gather.gather(allh)
        if int(counts.sum()) == 0:
            for x in range(c0, c1):
                out[x] = empty()
            c0 = c1
            continue
        if native_ok:
            nat = collect_anchors_native(
                mzs, _chunk_table(allh, counts, tid, tpos, trev, tspan),
                rids[c0:c1], tlens, hom_cov)
            if nat is not None:
                out[c0:c1] = nat
                c0 = c1
                continue
        qidx = np.repeat(np.arange(len(allh)), counts)
        qread_a = qread[qidx]
        keep = tid.astype(np.int64) != qread_a
        tid, tpos, trev, tspan, qread_a, qidx = (
            tid[keep], tpos[keep], trev[keep], tspan[keep], qread_a[keep],
            qidx[keep])
        occ = np.repeat(counts, counts)[keep]
        by_rid = finish_anchor_chunk(
            qread_a, qpos_all[qidx], qrev_all[qidx], qspan_all[qidx],
            tid, tpos, trev, tspan, occ, tlens, min_cnt, max_cnt)
        for x in range(c0, c1):
            out[x] = by_rid.get(rids[x], None) or empty()
        c0 = c1
    return out
