"""Bucket-sharded minimizer index with owner-routed queries.

The port of hifiasm_tpu/parallel/index_shard.py.  Shard s owns every hash
with ``h % n_shards == s`` (the reference's low-bit bucketing,
htab.cpp:118).  Queries are split into one equal slice per shard (the
JAX package's ``P("data")`` layout).  Each source shard routes its slice
to the owners through fixed-capacity lanes of ``cap`` queries per
(source, owner) pair; each owner answers by a lower-bound search of its
sorted hashes, and the answers travel back the same way.  Where the JAX
package runs ``lax.all_to_all`` inside ``shard_map``, this single
controller copies each lane to its destination device; ``psum`` is an
integer sum.

Hashes are uint64 on the host.  On the device they are int64 bit
patterns, and every search or sort runs on the key ``h ^ 2^63``, whose
signed order is the hashes' unsigned order (the JAX package's (hi, lo)
uint32 lexicographic order): torch has no unsigned 64-bit compares.  A
shard is the hash's low bits, which the key does not change.

As in the JAX package, a lane holds at most ``cap`` queries: a query past
it makes the call raise ``RuntimeError``, and the table build retries
with ``cap`` doubled up to four times.  ``ShardedIndex.build`` keeps the
JAX package's power-of-two shard count (``AssertionError`` otherwise),
and ``ShardedPostings`` its (span << 24 | pos) packing, which holds read
positions below 2^24 only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from hifiasm_tpu_torch.index.count import YAK_MAX_COUNT, YAK_N_COUNTS
from hifiasm_tpu_torch.index.pos_table import PositionTable
from hifiasm_tpu_torch.overlap.anchors import _expand_ranges
from hifiasm_tpu_torch.parallel.mesh import Mesh
from hifiasm_tpu_torch.utils import trace

_SIGN = -(1 << 63)            # key = bits ^ _SIGN: signed order == unsigned
_U32 = 0xFFFFFFFF

# lane traffic of the routed calls since the caller last reset them:
# calls, queries (or postings) routed, and those past a lane's capacity
STATS = trace.register("index_shard", {"calls": 0, "routed": 0,
                                       "overflow": 0})


def hash_bits(h: np.ndarray) -> torch.Tensor:
    """uint64 hashes -> their int64 bit patterns (a CPU tensor)."""
    return torch.from_numpy(np.ascontiguousarray(h, np.uint64).view(np.int64))


def _require_pow2(n: int, what: str) -> None:
    # the JAX package asserts this; the port raises the same error
    if n & (n - 1):
        raise AssertionError(f"{what} must be 2^k, got {n}")


@dataclass
class ShardedIndex:
    n_shards: int
    hashes: np.ndarray     # [S, Hmax] uint64, per-shard sorted, pad 2^64-1
    counts: np.ndarray     # [S, Hmax] int32
    h_len: np.ndarray      # [S] int32

    @classmethod
    def build(cls, pt: PositionTable, n_shards: int) -> "ShardedIndex":
        _require_pow2(n_shards, "n_shards")
        shard = (pt.hashes % np.uint64(n_shards)).astype(np.int64)
        hmax = max(int(np.bincount(shard, minlength=n_shards).max())
                   if len(shard) else 0, 1)
        hs = np.full((n_shards, hmax), np.uint64(0xFFFFFFFFFFFFFFFF),
                     np.uint64)
        cn = np.zeros((n_shards, hmax), np.int32)
        ln = np.zeros(n_shards, np.int32)
        for s in range(n_shards):
            sel = shard == s
            n = int(sel.sum())
            hs[s, :n] = pt.hashes[sel]       # sorted uint64 == key order
            cn[s, :n] = pt.count[sel]
            ln[s] = n
        return cls(n_shards, hs, cn, ln)


@dataclass
class ShardedPostings:
    """Bucket-sharded postings: per-shard CSR into packed position lists
    (the device form of ``ha_pt_t``'s count, offset and positions,
    htab.h:20-22): rid and rev pack into one lane (rid << 1 | rev), span
    and pos into another (span << 24 | pos)."""

    n_shards: int
    idx: ShardedIndex
    start: np.ndarray      # [S, Hmax] int32 CSR into the posting lanes
    p_rid: np.ndarray      # [S, Pmax] uint32 (rid << 1 | rev)
    p_pos: np.ndarray      # [S, Pmax] uint32 ((span << 24) | pos)

    @classmethod
    def build(cls, pt: PositionTable, n_shards: int) -> "ShardedPostings":
        idx = ShardedIndex.build(pt, n_shards)
        shard = (pt.hashes % np.uint64(n_shards)).astype(np.int64)
        per = np.bincount(shard, weights=pt.count.astype(np.int64),
                          minlength=n_shards).astype(np.int64)
        pmax = max(int(per.max()) if n_shards else 0, 1)
        st = np.zeros((n_shards, idx.hashes.shape[1]), np.int32)
        pr = np.zeros((n_shards, pmax), np.uint32)
        pp = np.zeros((n_shards, pmax), np.uint32)
        for s in range(n_shards):
            sel = np.flatnonzero(shard == s)
            c = pt.count[sel].astype(np.int64)
            st[s, :len(sel)] = np.cumsum(c) - c
            post = _expand_ranges(pt.start[sel], c)
            n = len(post)
            pr[s, :n] = (pt.rid[post].astype(np.uint32) << 1) | pt.rev[post]
            # span (k <= 64 fits in 8 bits) rides the top byte of the pos
            # lane; read positions stay < 2^24 for HiFi inputs
            pp[s, :n] = (pt.span[post].astype(np.uint32) << 24) | \
                pt.pos[post].astype(np.uint32)
        return cls(n_shards, idx, st, pr, pp)


# ---------------------------------------------------------------------------
# lanes: the single-controller all_to_all


class _Lanes:
    """One source shard's routing of its slice: ``send(cols)`` lays the
    columns out as [S, cap] lanes by owner; ``back`` reads answers that
    arrive in those lanes in the slice's order."""

    def __init__(self, dest: torch.Tensor, S: int, cap: int):
        n = dest.numel()
        dev = dest.device
        self.order = torch.argsort(dest, stable=True)
        d_srt = dest[self.order]
        per = torch.bincount(d_srt, minlength=S + 1)
        seg = torch.cumsum(per, 0) - per
        rank = torch.arange(n, device=dev) - seg[d_srt]
        self.ok = (rank < cap) & (d_srt < S)
        self.slot = torch.where(self.ok, d_srt * cap + rank,
                                torch.full_like(rank, S * cap))
        self.over = ((d_srt < S) & ~self.ok).sum()
        self.S, self.cap = S, cap

    def send(self, a: torch.Tensor, fill) -> torch.Tensor:
        """[n] source column -> [S, cap] lanes (``fill`` where empty)."""
        S, cap = self.S, self.cap
        out = torch.full((S * cap + 1,) + tuple(a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        out[self.slot] = a[self.order]
        return out[:-1].view((S, cap) + tuple(a.shape[1:]))

    def back(self, lanes: torch.Tensor) -> torch.Tensor:
        """[S * cap, ...] answers in lane order -> [n, ...] in the
        slice's order (0 where a query did not fit its lane)."""
        slotc = self.slot.clamp(max=self.S * self.cap - 1)
        ok = self.ok.view((-1,) + (1,) * (lanes.dim() - 1))
        got = torch.where(ok, lanes[slotc], torch.zeros_like(lanes[slotc]))
        out = torch.empty_like(got)
        out[self.order] = got
        return out


def _exchange(mesh: Mesh, lanes: List[torch.Tensor]) -> List[torch.Tensor]:
    """all_to_all: source d's lane s goes to shard s; shard s receives
    [S * cap, ...] ordered by source."""
    S = len(mesh)
    return [torch.cat([lanes[d][s].to(mesh.devices[s]) for d in range(S)])
            for s in range(S)]


def _count_overflow(lanes: Sequence[_Lanes], n: int) -> int:
    """The psum of the sources' lane overflows (one sync)."""
    dev0 = lanes[0].over.device
    ovf = int(sum(ln.over.to(dev0) for ln in lanes))
    STATS["calls"] += 1
    STATS["routed"] += n
    STATS["overflow"] += ovf
    return ovf


def _routed_query(mesh: Mesh, tables, cap: int,
                  answer: Callable, what: str):
    """Returns query(q [Q] int64 hash bits) -> answer columns [Q, ...] on
    the mesh's first device; Q must be a multiple of the shard count.
    ``answer(table, q_key [S*cap]) -> tuple`` runs on each owner."""
    S = len(mesh)
    smask = S - 1

    def query(q: torch.Tensor):
        Q = q.numel()
        if Q % S:
            raise ValueError(f"{Q} queries do not split over {S} shards")
        Qd = Q // S
        srcs, sent = [], []
        for d, dev in enumerate(mesh.devices):
            qd = q[d * Qd:(d + 1) * Qd].to(dev)
            ln = _Lanes(qd & smask, S, cap)
            srcs.append(ln)
            sent.append(ln.send(qd, 0))
        recv = _exchange(mesh, sent)
        answers = [answer(tables[s], recv[s] ^ _SIGN) for s in range(S)]
        n_out = len(answers[0])
        outs = []
        for k in range(n_out):
            lanes = [a[k].reshape((S, cap) + tuple(a[k].shape[1:]))
                     for a in answers]
            back = _exchange(mesh, lanes)
            outs.append(torch.cat([srcs[d].back(back[d]).to(mesh.devices[0])
                                   for d in range(S)]))
        ovf = _count_overflow(srcs, Q)
        if ovf > 0:
            raise RuntimeError(
                f"{what} lane overflow: {ovf} queries past cap={cap}; "
                f"rebuild the query fn with a larger cap")
        return tuple(outs)

    return query


def _lookup(keys: torch.Tensor, qk: torch.Tensor):
    """Lower bound of each query key in a shard's sorted keys, and hit."""
    pos = torch.searchsorted(keys, qk)
    posc = pos.clamp(max=keys.numel() - 1)
    return posc, keys[posc] == qk


def _count_answer(table, qk):
    keys, counts = table
    posc, hit = _lookup(keys, qk)
    return (torch.where(hit, counts[posc], torch.zeros_like(counts[posc])),)


def _postings_answer(K: int):
    def answer(table, qk):
        keys, counts, st, pr, pp = table
        posc, hit = _lookup(keys, qk)
        zero = torch.zeros_like(counts[posc])
        n_loc = torch.where(hit, counts[posc].clamp(max=K), zero)
        base = torch.where(hit, st[posc], zero).long()
        ar = torch.arange(K, device=qk.device)
        gidx = (base[:, None] + ar[None, :]).clamp(max=pr.numel() - 1)
        valid = ar[None, :] < n_loc[:, None]
        z = torch.zeros((), dtype=pr.dtype, device=pr.device)
        return (n_loc, torch.where(valid, pr[gidx], z),
                torch.where(valid, pp[gidx], z))
    return answer


def _keys(h: np.ndarray, dev) -> torch.Tensor:
    return (hash_bits(h) ^ _SIGN).to(dev)


def _as_dev(a: np.ndarray, dev, dtype=torch.int64) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev,
                                                       dtype=dtype)


def make_sharded_cnt(mesh: Mesh, idx: ShardedIndex, cap: int):
    """Returns fn(q [Q] int64 hash bits) -> counts [Q] int32 (on the
    mesh's first device); Q = S * per-shard queries."""
    S = idx.n_shards
    if len(mesh) != S:
        raise ValueError(f"mesh of {len(mesh)} for {S} shards")
    tables = [(_keys(idx.hashes[s], dev), _as_dev(idx.counts[s], dev,
                                                  torch.int32))
              for s, dev in enumerate(mesh.devices)]
    fn = _routed_query(mesh, tables, cap, _count_answer, "sharded-cnt")
    return lambda q: fn(q)[0]


def sharded_cnt_np(query_fn, hashes: np.ndarray) -> np.ndarray:
    """uint64 numpy hashes -> counts via the routed query."""
    return query_fn(hash_bits(hashes)).cpu().numpy()


def make_sharded_postings(mesh: Mesh, sp: ShardedPostings, cap: int,
                          k_post: int):
    """Returns fn(q [Q]) -> (n [Q] int32, rid [Q, K], pos [Q, K] int64
    holding the uint32 lanes): the multi-device anchor gather.  Queries
    go to their bucket's owner, owners gather up to K postings each,
    answers come back."""
    S = sp.n_shards
    if len(mesh) != S:
        raise ValueError(f"mesh of {len(mesh)} for {S} shards")
    tables = [(_keys(sp.idx.hashes[s], d),
               _as_dev(sp.idx.counts[s], d, torch.int32),
               _as_dev(sp.start[s], d, torch.int32),
               _as_dev(sp.p_rid[s], d), _as_dev(sp.p_pos[s], d))
              for s, d in enumerate(mesh.devices)]
    return _routed_query(mesh, tables, cap, _postings_answer(k_post),
                         "sharded-postings")


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order, the LAST key primary (np.lexsort)."""
    idx = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        idx = idx[torch.argsort(k[idx], stable=True)]
    return idx


def _dump(n: int, fill, dtype, dev) -> torch.Tensor:
    """An [n + 1] buffer whose last slot takes the dropped writes."""
    return torch.full((n + 1,), fill, dtype=dtype, device=dev)


def _build_shard(cols, keep_min: int, keep_max: int):
    """One owner's bucket: sort the routed postings by (valid, hash, rid,
    pos), segment-reduce into the CSR form, filter by count, compact.
    Returns (keys, counts, start, rid lane, pos lane, h_len, hist)."""
    r_h, r_rid, r_pos, r_rev, r_span, r_vld = cols
    dev = r_h.device
    M = r_h.numel()
    key = r_h ^ _SIGN
    inv = 1 - r_vld
    sidx = _lexsort((r_pos, r_rid, key, inv))
    s_key, s_rid, s_pos = key[sidx], r_rid[sidx], r_pos[sidx]
    s_rev, s_span, s_vld = r_rev[sidx], r_span[sidx], r_vld[sidx] > 0
    ar = torch.arange(M, device=dev)
    newk = torch.ones(M, dtype=torch.bool, device=dev)
    newk[1:] = s_key[1:] != s_key[:-1]
    newk &= s_vld
    did = torch.cumsum(newk.long(), 0) - 1
    did_v = torch.where(s_vld, did, torch.full_like(did, M))
    counts = _dump(M, 0, torch.int64, dev).index_add_(
        0, did_v, torch.ones_like(did_v))[:M]
    firsts = _dump(M, M, torch.int64, dev).scatter_reduce_(
        0, did_v, ar, "amin")[:M]
    n_dist = newk.sum()
    live = ar < n_dist
    capped = counts.clamp(max=YAK_MAX_COUNT)
    hidx = torch.where(live, capped, torch.full_like(capped, YAK_N_COUNTS))
    hist = _dump(YAK_N_COUNTS, 0, torch.int64, dev).index_add_(
        0, hidx, torch.ones_like(hidx))[:YAK_N_COUNTS]
    keep = live & (counts >= keep_min) & (counts <= keep_max)
    kslot = torch.where(keep, torch.cumsum(keep.long(), 0) - 1,
                        torch.full_like(ar, M))
    f = firsts.clamp(max=M - 1)
    hh = _dump(M, (-1) ^ _SIGN, torch.int64, dev)
    hh[kslot] = s_key[f]
    cn = _dump(M, 0, torch.int64, dev)
    cn[kslot] = counts
    kc = torch.where(keep, counts, torch.zeros_like(counts))
    st = _dump(M, 0, torch.int64, dev)
    st[kslot] = torch.cumsum(kc, 0) - kc
    pkeep = s_vld & keep[did.clamp(0, M - 1)]
    pslot = torch.where(pkeep, torch.cumsum(pkeep.long(), 0) - 1,
                        torch.full_like(ar, M))
    pr = _dump(M, 0, torch.int64, dev)
    pr[pslot] = ((s_rid << 1) | (s_rev & 1)) & _U32
    pp = _dump(M, 0, torch.int64, dev)
    pp[pslot] = ((s_span << 24) | s_pos) & _U32
    return (hh[:M], cn[:M].int(), st[:M].int(), pr[:M], pp[:M],
            keep.sum(), hist)


def build_sharded_postings_mesh(mesh: Mesh, mz_per_read,
                                keep_min: int = 2,
                                keep_max: Optional[int] = None,
                                min_hist_cnt: int = 5,
                                cap: Optional[int] = None):
    """Build the position table sharded across the mesh: no device holds
    the whole table.  Each source shard takes a contiguous slice of the
    flattened postings and routes every posting to its owner (hash low
    bits) through fixed-capacity lanes; owners sort their bucket by
    (hash, rid, pos) and segment-reduce it into the CSR form; the count
    histogram is summed across shards (the reference's bucketed
    ``ha_pt_gen``, htab.cpp:118, :971).

    Returns ``(query_factory, hist, h_len)``: ``query_factory(k_post,
    q_cap=None)`` builds the routed anchor-gather query over the built
    shards; hist [YAK_N_COUNTS] and h_len [S] are host arrays."""
    if keep_max is None:
        keep_max = YAK_MAX_COUNT - 1
    S = len(mesh)
    _require_pow2(S, "mesh size")
    # flatten the postings on the host (the table never materialises)
    def cat(parts, dt):
        return np.concatenate(parts).astype(dt) if parts else np.zeros(0, dt)
    h = cat([np.asarray(m.hash, np.uint64) for m in mz_per_read], np.uint64)
    P_tot = len(h)
    rid = cat([np.full(len(m.hash), i, np.int64)
               for i, m in enumerate(mz_per_read)], np.int64)
    pos = cat([np.asarray(m.pos, np.uint32) for m in mz_per_read], np.int64)
    rev = cat([np.asarray(m.rev, np.uint8) for m in mz_per_read], np.int64)
    span = cat([np.asarray(m.span, np.uint16) for m in mz_per_read],
               np.int64)
    Pd = -(-max(P_tot, 1) // S)
    if cap is None:
        cap = int(Pd / S * 1.5) + 256
    bits = np.full(S * Pd, -1, np.int64)
    bits[:P_tot] = h.view(np.int64)

    def pad(a):
        out = np.zeros(S * Pd, np.int64)
        out[:P_tot] = a
        return out

    host = [bits, pad(rid), pad(pos), pad(rev), pad(span),
            pad(np.ones(P_tot, np.int64))]
    fills = (-1, 0, 0, 0, 0, 0)
    src = [[torch.from_numpy(a[d * Pd:(d + 1) * Pd]).to(dev) for a in host]
           for d, dev in enumerate(mesh.devices)]

    def attempt(cap):
        lanes, sent = [], []
        for d in range(S):
            h_d, vld = src[d][0], src[d][5]
            dest = torch.where(vld > 0, h_d & (S - 1),
                               torch.full_like(h_d, S))
            ln = _Lanes(dest, S, cap)
            lanes.append(ln)
            sent.append([ln.send(c, f) for c, f in zip(src[d], fills)])
        recv = [_exchange(mesh, [sent[d][k] for d in range(S)])
                for k in range(len(host))]
        shards = [_build_shard([recv[k][s] for k in range(len(host))],
                               keep_min, keep_max) for s in range(S)]
        ovf = _count_overflow(lanes, P_tot)
        return shards, ovf

    for _ in range(4):
        shards, ovf = attempt(cap)
        if ovf == 0:
            break
        cap *= 2
    else:
        raise RuntimeError(
            f"sharded table build: {ovf} postings still overflow the "
            f"routing lanes at cap={cap}")
    hist = sum(sh[6].cpu() for sh in shards).numpy()
    h_len = np.array([int(sh[5]) for sh in shards], np.int32)
    M = S * cap
    tables = [sh[:5] for sh in shards]

    def query_factory(k_post: int, q_cap: Optional[int] = None):
        return _routed_query(
            mesh, tables, q_cap if q_cap is not None else max(M // S, 256),
            _postings_answer(k_post), "sharded-postings")

    return query_factory, hist, h_len
