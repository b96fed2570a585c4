"""Device-resident minimizer position table and anchor gather (PyTorch ops).

The port of hifiasm_tpu/index/pos_table_jax.py.  The main path uploads
the host-built ``PositionTable`` (index/pos_table.py) once per EC round
(``device_table_from_host``) and queries it on the device (~``ha_pt_get``,
htab.cpp:518); the anchors of a chunk of reads are expanded, weighted
(anchor.cpp:1063-1071) and sorted in the host path's exact (qread, tid,
rev, qpos, t_off) order without leaving the device, and the (read, tid,
rev) groups that feed the device chaining (overlap/chain_device.py) are
found there too.  The table can also be built on the device
(``build_table_device``, after the device sketch in
``build_position_table_device``), and the anchors fetched per read
(``collect_anchors_device``); no entry point calls these yet.

PyTorch on the CPU has no unsigned 64-bit compares, so hashes are held
as int64 with bit 63 flipped: signed order is then the reference's
unsigned order, and ``torch.searchsorted`` over the flipped keys gives
the binary search's leftmost match.  The JAX package's pow2 padding,
its packed 3-word sort key and its ``Gcap`` group compaction exist for
XLA's compile cache and the TPU link; PyTorch runs eagerly, so the
anchors are kept exactly (no padding) and sorted stably in two passes,
which gives the same order for any read or target count (the JAX
package's "wide" branch included).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hifiasm_tpu_torch.device import resolve_device
from hifiasm_tpu_torch.index.count import (
    YAK_MAX_COUNT, YAK_N_COUNTS, analyze_count,
)
from hifiasm_tpu_torch.index.pos_table import PositionTable
from hifiasm_tpu_torch.overlap.anchors import HA_KMER_GOOD_RATIO, Anchors
from hifiasm_tpu_torch.utils import trace
from hifiasm_tpu_torch.utils.logging import log

_FLIP = np.uint64(1 << 63)

# counters of the runs since the caller last reset them: seconds
# (trace.span) of the table upload and of the anchor stages (lookup +
# expand + sort + groups, synced at the group fetch), anchors kept and
# chunks gathered
STATS = trace.register("pos_table_dev", {
    "upload_s": 0.0, "anchors_s": 0.0, "anchors": 0, "chunks": 0})


def flip_u64(h: np.ndarray) -> np.ndarray:
    """uint64 hashes -> int64 keys whose signed order is the unsigned
    order of the hashes."""
    return (np.asarray(h, np.uint64) ^ _FLIP).view(np.int64)


def unflip_u64(keys: np.ndarray) -> np.ndarray:
    """The inverse of ``flip_u64``."""
    return np.asarray(keys, np.int64).view(np.uint64) ^ _FLIP


@dataclass
class DevicePositionTable:
    """The minimizer index resident on one device (exact sizes)."""

    keys: torch.Tensor     # [H] int64 flipped hashes, sorted
    start: torch.Tensor    # [H] int64 into the postings
    count: torch.Tensor    # [H] int64
    rid: torch.Tensor      # [P] int64 (sorted by hash, rid, pos)
    pos: torch.Tensor      # [P] int64
    rev: torch.Tensor      # [P] uint8
    span: torch.Tensor     # [P] int64

    @property
    def n_distinct(self) -> int:
        return int(self.keys.numel())

    @property
    def tot_pos(self) -> int:
        return int(self.rid.numel())

    def to_host(self) -> PositionTable:
        """The host PositionTable with the host build's dtypes."""
        def h(t, dt):
            return t.cpu().numpy().astype(dt)

        return PositionTable(
            hashes=unflip_u64(self.keys.cpu().numpy()),
            start=h(self.start, np.int64), count=h(self.count, np.int32),
            rid=h(self.rid, np.uint32), pos=h(self.pos, np.uint32),
            rev=h(self.rev, np.uint8), span=h(self.span, np.uint16))


def device_table_from_host(pt, device) -> DevicePositionTable:
    """Upload a host-built PositionTable: the front end builds on the host
    (native sketch + numpy lexsort) and serves from device memory."""
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    with trace.span("ec.upload", STATS, "upload_s") as sp:
        tbl = DevicePositionTable(
            keys=up(flip_u64(pt.hashes), torch.int64),
            start=up(pt.start, torch.int64), count=up(pt.count, torch.int64),
            rid=up(pt.rid, torch.int64), pos=up(pt.pos, torch.int64),
            rev=up(pt.rev, torch.uint8), span=up(pt.span, torch.int64))
        if tbl.keys.is_cuda:
            torch.cuda.synchronize(tbl.keys.device)
    log("device_table", f"{tbl.n_distinct} keys, {tbl.tot_pos} postings "
        f"resident in {sp.s:.2f}s")
    return tbl


def build_table_device(mz_per_read: Sequence, keep_min: int = 2,
                       keep_max: int = YAK_MAX_COUNT - 1,
                       min_hist_cnt: int = 5, device="cuda"):
    """Per-read Minimizers -> (DevicePositionTable, peak_hom, peak_het),
    every pass on ``device`` (port of build_position_table_jax and its
    _build_kernel): one stable sort by (hash, rid, pos), the group
    starts, CSR offsets, the capped occurrence histogram and the
    [keep_min, keep_max] band filter.  ``to_host()`` of the table equals
    the tail of index/pos_table.build_position_table."""
    dev = resolve_device(device)
    n_per = np.array([len(m) for m in mz_per_read], np.int64)

    def up(f, dtype, mask=None):
        a = np.concatenate([np.asarray(f(m)) for m in mz_per_read]) \
            if len(mz_per_read) else np.zeros(0, dtype)
        a = a.astype(np.int64) & mask if mask else a.astype(dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    keys = up(lambda m: flip_u64(m.hash), np.int64)
    rid = torch.from_numpy(np.repeat(np.arange(len(n_per)), n_per)).to(dev)
    # the host table holds pos as uint32 and span as uint16
    pos = up(lambda m: m.pos, np.int64, 0xFFFFFFFF)
    rev = up(lambda m: m.rev, np.uint8)
    span = up(lambda m: m.span, np.int64, 0xFFFF)
    # two stable passes, minor key first: (rid, pos) packed (rid < 2^31,
    # pos < 2^32), then the flipped hash
    o = torch.argsort((rid << 32) | pos, stable=True)
    o = o[torch.argsort(keys[o], stable=True)]
    keys, rid, pos, rev, span = (t[o] for t in (keys, rid, pos, rev, span))
    P = keys.numel()
    new = torch.ones(P, dtype=torch.bool, device=dev)
    if P > 1:
        new[1:] = keys[1:] != keys[:-1]
    first = torch.nonzero(new).flatten()
    counts = torch.diff(first, append=torch.tensor([P], device=dev))
    hist = torch.bincount(counts.clamp(max=YAK_MAX_COUNT),
                          minlength=YAK_N_COUNTS)
    hist[0] = 0
    keepg = (counts >= keep_min) & (counts <= keep_max)
    cnt = counts[keepg]
    post = torch.repeat_interleave(keepg, counts)
    table = DevicePositionTable(
        keys=keys[first[keepg]], start=torch.cumsum(cnt, 0) - cnt,
        count=cnt, rid=rid[post], pos=pos[post], rev=rev[post],
        span=span[post])
    peak_hom, peak_het = analyze_count(hist.cpu().numpy(),
                                       start_cnt=min_hist_cnt)
    if peak_hom > 0:
        log("build_table_device",
            f"peak_hom: {peak_hom}; peak_het: {peak_het}")
    log("build_table_device",
        f"indexed {table.tot_pos} positions, {table.n_distinct} distinct "
        f"minimizer k-mers (device)")
    return table, peak_hom, peak_het


def build_position_table_device(read_codes, k: int, w: int, ft=None,
                                min_hist_cnt: int = 5, keep_min: int = 2,
                                keep_max: int = YAK_MAX_COUNT - 1,
                                device="cuda"):
    """The device analog of index/pos_table.build_position_table: the
    device sketch (ops/sketch_dev.py), then ``build_table_device``.
    Returns (DevicePositionTable, peak_hom, peak_het, mz_per_read)."""
    from hifiasm_tpu_torch.ops.sketch_dev import sketch_many_device
    mzs = sketch_many_device(list(read_codes), k, w, ft=ft, device=device)
    table, peak_hom, peak_het = build_table_device(
        mzs, keep_min=keep_min, keep_max=keep_max,
        min_hist_cnt=min_hist_cnt, device=device)
    return table, peak_hom, peak_het, mzs


def lookup(q_keys: torch.Tensor, table: DevicePositionTable):
    """(slot, found, count) per flipped query key (port of
    _lookup_kernel): slot is the leftmost match, clamped to the table."""
    n = table.n_distinct
    if n == 0:
        z = torch.zeros_like(q_keys)
        return z, torch.zeros_like(q_keys, dtype=torch.bool), z
    idx = torch.searchsorted(table.keys, q_keys).clamp(max=n - 1)
    found = table.keys[idx] == q_keys
    cnt = torch.where(found, table.count[idx], torch.zeros_like(idx))
    return idx, found, cnt


def weight_lut(hom_cov: int) -> np.ndarray:
    """Occurrence-class weight per occurrence count (anchor.cpp:1063-1071),
    computed in float64 on the host so that device arithmetic stays
    integer."""
    max_cnt = max(int(hom_cov * (2.0 - HA_KMER_GOOD_RATIO)), 2)
    min_cnt = max(int(hom_cov * HA_KMER_GOOD_RATIO), 2)
    occ_ax = np.arange(YAK_N_COUNTS, dtype=np.int64)
    wl = np.ones(YAK_N_COUNTS, np.int64)
    wl[occ_ax <= min_cnt] = 2
    hi_m = occ_ax >= max_cnt
    wh = 1 + ((occ_ax[hi_m] + (max_cnt << 1) - 1) // (max_cnt << 1))
    wl[hi_m] = np.floor(np.power(wh.astype(np.float64), 1.1)).astype(
        np.int64)
    return np.minimum(wl, 0xFFFFFF)


def expand_fill(slot, cnt, q_read, q_pos, q_rev, q_span,
                table: DevicePositionTable, lens, wlut):
    """Every (query minimizer, posting) pair of a chunk as one anchor,
    self hits dropped, sorted stably by (qread, tid, rev, qpos, t_off)
    (port of _expand_fill).  Returns the sorted columns
    (read, tid, rev, qpos, t_off, span, w)."""
    dev = slot.device
    m = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    post = table.start[slot[m]] + (torch.arange(m.numel(), device=dev)
                                   - first[m])
    tid = table.rid[post]
    qr = q_read[m]
    keep = tid != qr
    m, post, tid, qr = m[keep], post[keep], tid[keep], qr[keep]
    tpos = table.pos[post]
    rev = (q_rev[m] != table.rev[post]).to(torch.uint8)
    t_off = torch.where(rev == 0, tpos,
                        lens[tid] - 1 - (tpos + 1 - table.span[post]))
    qpos = q_pos[m]
    w = wlut[cnt[m].clamp(max=wlut.numel() - 1)]
    # two stable passes: minor keys (rev, qpos, t_off), then major keys
    # (qread, tid); qpos and t_off are < 2^31, so each key fits an int64
    o = torch.argsort((rev.long() << 62) | (qpos << 31) | t_off,
                      stable=True)
    o = o[torch.argsort((qr[o] << 31) | tid[o], stable=True)]
    return (qr[o], tid[o], rev[o], qpos[o], t_off[o], q_span[m][o], w[o])


def group_detect(a_read, a_tid, a_rev):
    """Starts of the (read, tid, rev) runs of the sorted anchors and the
    run keys (port of _group_detect), fetched to the host."""
    n = a_read.numel()
    new = torch.ones(n, dtype=torch.bool, device=a_read.device)
    if n > 1:
        new[1:] = (a_read[1:] != a_read[:-1]) | (a_tid[1:] != a_tid[:-1]) \
            | (a_rev[1:] != a_rev[:-1])
    gs = torch.nonzero(new).flatten()
    return tuple(t.cpu().numpy().astype(np.int64)
                 for t in (gs, a_read[gs], a_tid[gs], a_rev[gs]))


def _anchor_chunks(mzs, table: DevicePositionTable, rids, tlens, hom_cov,
                   chunk_mz: int):
    """Chunks of ``rids`` split on read boundaries (each at least one read
    and about ``chunk_mz`` minimizers); yields (reads, cols): the sorted
    anchor columns of the chunk on the table's device (None when it has
    none)."""
    dev = table.keys.device
    wlut = torch.from_numpy(weight_lut(hom_cov)).to(dev)
    lens = torch.from_numpy(np.asarray(tlens, np.int64)).to(dev)
    c0 = 0
    while c0 < len(rids):
        c1, nm = c0, 0
        while c1 < len(rids) and (nm == 0 or nm < chunk_mz):
            nm += len(mzs[rids[c1]])
            c1 += 1
        sub = rids[c0:c1]
        c0 = c1
        ms = [mzs[rr] for rr in sub]

        def cat(f, dtype):
            a = np.concatenate([f(mz) for mz in ms]) if ms else \
                np.zeros(0, dtype)
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        q_keys = cat(lambda mz: flip_u64(mz.hash), np.int64)
        q_read = torch.from_numpy(np.repeat(
            np.asarray(sub, np.int64), [len(mz) for mz in ms])).to(dev)
        q_pos = cat(lambda mz: mz.pos, np.int64)
        q_rev = cat(lambda mz: mz.rev, np.uint8)
        q_span = cat(lambda mz: mz.span, np.int64)
        slot, _, cnt = lookup(q_keys, table)
        if int(cnt.sum()) == 0:
            yield sub, None
            continue
        yield sub, dict(zip(
            ("read", "tid", "rev", "qpos", "toff", "span", "w"),
            expand_fill(slot, cnt, q_read, q_pos, q_rev, q_span, table,
                        lens, wlut)))


def collect_anchor_groups_device(mzs, table: DevicePositionTable, rids,
                                 tlens: np.ndarray, hom_cov: int,
                                 chunk_mz: int = 2_000_000
                                 ) -> Iterator[Tuple[Optional[dict], dict]]:
    """Device-resident anchor collection, chunk by chunk of reads.

    Yields (cols, meta) per chunk: ``cols`` are the sorted anchor columns
    on the device (read, tid, qpos, toff, span, w as int64, rev uint8),
    ``meta`` the host arrays (reads, n_keep, g_start, g_end, g_read,
    g_tid, g_rev as int64).  Chunks split on read boundaries, so groups
    never straddle chunks; cols is None for a chunk without anchors.
    A chunk's anchor stages, from its lookup to its group fetch, are one
    ``ec.anchors`` span."""
    chunks = _anchor_chunks(mzs, table, rids, tlens, hom_cov, chunk_mz)
    while True:
        with trace.span("ec.anchors", STATS, "anchors_s"):
            sub, cols = next(chunks, (None, None))
            if cols is not None:
                gs, g_read, g_tid, g_rev = group_detect(
                    cols["read"], cols["tid"], cols["rev"])
        if sub is None:
            return
        if cols is None:
            yield None, dict(reads=sub, n_keep=0)
            continue
        nk = int(cols["read"].numel())
        STATS["anchors"] += nk
        STATS["chunks"] += 1
        meta = dict(reads=sub, n_keep=nk, g_start=gs,
                    g_end=np.append(gs[1:], nk).astype(np.int64),
                    g_read=g_read, g_tid=g_tid, g_rev=g_rev)
        yield cols, meta


def _empty_anchors() -> Anchors:
    return Anchors(*(np.zeros(0, t) for t in (
        np.uint32, np.uint8, np.int64, np.int64, np.int64, np.int64)))


def collect_anchors_device(mzs, table: DevicePositionTable, rids,
                           tlens: np.ndarray, hom_cov: int,
                           chunk_mz: int = 2_000_000) -> List[Anchors]:
    """Anchors of many reads gathered on the table's device, returned per
    read as host ``Anchors`` (port of the JAX package's function of the
    same name): equal to overlap/anchors.collect_anchors_many, in its
    (qread, tid, rev, qpos, t_off) order.

    The JAX package packs the sort key into 20-bit read and target lanes,
    asserts a chunk's read-id span below 2^20 and sorts "wide" beyond
    2^20 targets; ``expand_fill`` sorts exactly for any count, so neither
    the assert nor a second branch is needed here."""
    out = [_empty_anchors() for _ in rids]
    pos_of = {rr: i for i, rr in enumerate(rids)}
    for _, cols in _anchor_chunks(mzs, table, rids, tlens, hom_cov,
                                  chunk_mz):
        if cols is None or cols["read"].numel() == 0:
            continue
        read, tid, rev, qpos, toff, span, w = (
            cols[k].cpu().numpy() for k in
            ("read", "tid", "rev", "qpos", "toff", "span", "w"))
        bnd = np.flatnonzero(np.diff(read)) + 1
        for s, e in zip(np.concatenate([[0], bnd]),
                        np.concatenate([bnd, [len(read)]])):
            out[pos_of[int(read[s])]] = Anchors(
                tid[s:e].astype(np.uint32), rev[s:e], qpos[s:e],
                toff[s:e], span[s:e], w[s:e])
    return out
