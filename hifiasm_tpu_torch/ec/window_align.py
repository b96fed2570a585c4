"""Windowed overlap alignment for error correction.

Re-expresses ``gen_hc_r_alin_ea`` (ecovlp.cpp:2810): each overlap region is
sliced into windows of ``wl`` (WINDOW_HC = 775 for HiFi) on the query; the
matching target slice is located from the chain hits (the reference
interpolates its "fake cigar" gap-shift checkpoints, Hash_Table.h:71-76);
each window is aligned by banded bit-parallel Myers with error budget
``ceil(wlen * e_rate)`` capped at THRESHOLD_MAX_SIZE = 31, retrying failed
windows once with a doubled band (the reference's double_error_threshold
retry in Correct.cpp's verify_window flow).

TPU-first shape: windows from ALL reads of a batch are flattened into large
fixed-shape launches (``WindowBatcher``) instead of the reference's
one-window-at-a-time SSE calls.  The engine is pluggable: the numpy oracle
(ops/banded_batch.py) or the jitted JAX scan (ops/banded_align_jax.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from hifiasm_tpu_torch.config import THRESHOLD_MAX_SIZE, WINDOW_HC
from hifiasm_tpu_torch.ops.banded_batch import banded_batch_np
from hifiasm_tpu_torch.overlap.anchors import OverlapRegions

Engine = Callable[..., "BatchAlign"]  # (x, xlen, y, ylen, e) -> BatchAlign


def resolve_engine(name: str = "auto") -> Engine:
    """Host engine: native C++ when it builds, else numpy."""
    if name == "numpy":
        return banded_batch_np
    if name == "native":
        from hifiasm_tpu_torch.native import banded_batch_native, get_lib
        if get_lib() is None:
            raise RuntimeError("native engine unavailable (build failed)")
        return banded_batch_native
    try:
        from hifiasm_tpu_torch.native import get_lib, banded_batch_native
        if get_lib() is not None:
            return banded_batch_native
    except Exception:
        pass
    return banded_batch_np


@dataclass
class OverlapTracebacks:
    """Per-overlap windowed alignment results, positions in CSR layout.

    Position arrays cover each overlap's query range [x_s, x_e] inclusive;
    ``off[o] + (p - x_s[o])`` indexes query position p of overlap o.
    """

    off: np.ndarray        # [n_ov + 1] int64
    tb: np.ndarray         # flat uint8: 0..3 target base, 4 del, 5 unaligned
    ins_cnt: np.ndarray    # flat uint8
    ins_base: np.ndarray   # flat uint8
    win_tot: np.ndarray    # [n_ov] int32
    win_ok: np.ndarray     # [n_ov] int32
    err: np.ndarray        # [n_ov] int64 total errors over aligned windows
    ts: np.ndarray         # [n_ov] int64 precise target start (query frame)
    te: np.ndarray         # [n_ov] int64 precise target end (incl., query frame)
    x_s: np.ndarray = None  # [n_ov] int64 query start of each overlap
    arena: tuple = None     # shared flush arena (tb, ins_cnt, ins_base)
    arena_base: int = 0     # this read's absolute offset into the arena

    def fully_aligned(self) -> np.ndarray:
        return (self.win_tot > 0) & (self.win_ok == self.win_tot)

    def view(self, o: int, field: str) -> np.ndarray:
        a = getattr(self, field)
        return a[self.off[o]:self.off[o + 1]]


def _window_threshold(wlen: int, e_rate: float) -> int:
    t = int(np.ceil(wlen * e_rate))
    return max(2, min(t, THRESHOLD_MAX_SIZE))


def _grid_phase(y_id, rev, wl: int):
    """Per-overlap window-grid phase = first-window length, QUANTIZED
    to multiples of wl//5 (0 keeps the x_s-anchored grid).

    With every overlap extended to the read boundary (x_s == 0), all
    voters' window seams land on the SAME query columns, so an indel
    that an alignment tie hides at a seam is hidden for every voter at
    once (measured: half the residual EC errors sat within +-8 of the
    775 grid).  A deterministic per-target phase scatters the seams:
    each seam column is interior to ~4/5 of the other voters' windows,
    restoring the evidence there.  The QUANTIZATION (5 classes instead
    of per-base phases) keeps the native kernel's 4-lane SIMD viable
    for the partial first windows: within a read they take only 4
    distinct lengths, so same-length lane groups form across overlaps
    (per-base phases forced every first window through the scalar
    lane — a measured ~10-15% host EC wall hit).  The reference instead
    tracks each overlap's y continuation ACROSS windows (Correct.cpp
    window loop), which breaks the seam ties the other way; phase
    scatter reaches the same place without per-window sequential
    dependencies."""
    q5 = wl // 5
    y = np.asarray(y_id)
    if q5 < 64:
        return np.zeros(len(y), np.int64)
    cls = (y.astype(np.int64) * 197 + np.asarray(rev).astype(np.int64)) \
        % 5
    return cls * q5


def plan_read_windows(ov: OverlapRegions, wl: int, e_rate: float,
                      with_tws: bool = True):
    """Window coordinates for every overlap of one read.

    Returns dict of arrays: ov_idx, ws (query window start), wlen, t_ws
    (target window nominal start, query frame), thre (per-window error
    budget), last (final window of its overlap).  Shared by the host
    WindowBatcher and the device-resident EC planner.  With
    ``with_tws=False`` (device-resident hits) t_ws is left out — the
    caller fills it from chain_device.tws_for_windows, which computes
    the identical searchsorted on device.
    """
    n_ov = len(ov)
    if n_ov == 0:
        z = np.zeros(0, np.int64)
        return dict(ov_idx=z, ws=z, wlen=z, t_ws=z, thre=z,
                    last=np.zeros(0, bool))
    spans = (ov.x_e - ov.x_s + 1).astype(np.int64)
    p0 = _grid_phase(ov.y_id, ov.rev, wl)
    P = np.where(p0 == 0, wl, p0)                # first-window length
    n_win = 1 + np.maximum(-(-(spans - P) // wl), 0)
    tot = int(n_win.sum())
    ov_idx = np.repeat(np.arange(n_ov), n_win)
    woff = np.concatenate([[0], np.cumsum(n_win)])
    local = np.arange(tot) - np.repeat(woff[:-1], n_win)
    xs_r = np.repeat(ov.x_s.astype(np.int64), n_win)
    P_r = np.repeat(P, n_win)
    ws = xs_r + np.where(local == 0, 0, P_r + (local - 1) * wl)
    xe_r = np.repeat(ov.x_e.astype(np.int64), n_win)
    wlen = np.minimum(xs_r + P_r + local * wl, xe_r + 1) - ws
    last = ws + wlen > xe_r
    thre = np.clip(np.ceil(wlen * e_rate).astype(np.int64), 2,
                   THRESHOLD_MAX_SIZE)
    pl = dict(ov_idx=ov_idx, ws=ws, wlen=wlen, thre=thre, last=last)
    if with_tws:
        # nearest chain hit at-or-after each window start (anchor offsets
        # are k-mer ENDS, so a hit >= ws constrains the window best)
        t_ws = np.empty(tot, np.int64)
        for o in range(n_ov):
            hs = ov.hit_self[ov.hit_start[o]:ov.hit_start[o] +
                             ov.n_hits[o]]
            ht = ov.hit_t[ov.hit_start[o]:ov.hit_start[o] + ov.n_hits[o]]
            sl = slice(int(woff[o]), int(woff[o + 1]))
            hi = np.minimum(np.searchsorted(hs, ws[sl]), len(hs) - 1)
            t_ws[sl] = ht[hi] + (ws[sl] - hs[hi])
        pl["t_ws"] = t_ws
    return pl


def plan_windows_many(items, wl: int, e_rate: float, with_tws: bool = False):
    """Vectorized ``plan_read_windows`` over a whole chunk: ONE numpy pass
    over the concatenated overlap columns instead of a per-read Python
    loop (the loop costs seconds per multi-Mb chunk at genome scale).
    ``items``: [(rid, OverlapRegions)] -> {rid: plan} with per-read views
    into the shared arrays (identical contents).  ``with_tws`` (host
    hits) adds t_ws, from one search over every overlap's hits keyed by
    (overlap, self offset)."""
    z = np.zeros(0, np.int64)
    rids = [rr for rr, _ in items]
    n_ovs = np.array([len(ov) for _, ov in items], np.int64)
    if int(n_ovs.sum()) == 0:
        return {rr: dict(ov_idx=z, ws=z, wlen=z, t_ws=z, thre=z,
                         last=np.zeros(0, bool)) for rr in rids}
    xs = np.concatenate([ov.x_s.astype(np.int64) for _, ov in items
                         if len(ov)])
    xe = np.concatenate([ov.x_e.astype(np.int64) for _, ov in items
                         if len(ov)])
    yid = np.concatenate([ov.y_id for _, ov in items if len(ov)])
    rev = np.concatenate([ov.rev for _, ov in items if len(ov)])
    ov_read = np.repeat(np.arange(len(items)), n_ovs)
    ov_base = np.concatenate([[0], np.cumsum(n_ovs)])
    spans = xe - xs + 1
    p0 = _grid_phase(yid, rev, wl)
    P = np.where(p0 == 0, wl, p0)
    n_win = 1 + np.maximum(-(-(spans - P) // wl), 0)
    tot = int(n_win.sum())
    ov_idx_g = np.repeat(np.arange(len(xs)), n_win)
    woff = np.concatenate([[0], np.cumsum(n_win)])
    local = np.arange(tot) - np.repeat(woff[:-1], n_win)
    xs_r = np.repeat(xs, n_win)
    P_r = np.repeat(P, n_win)
    ws = xs_r + np.where(local == 0, 0, P_r + (local - 1) * wl)
    xe_r = np.repeat(xe, n_win)
    wlen = np.minimum(xs_r + P_r + local * wl, xe_r + 1) - ws
    last = ws + wlen > xe_r
    thre = np.clip(np.ceil(wlen * e_rate).astype(np.int64), 2,
                   THRESHOLD_MAX_SIZE)
    w_read = ov_read[ov_idx_g]
    bounds = np.searchsorted(w_read, np.arange(len(items) + 1))
    t_ws = _tws_many(items, ov_idx_g, ws) if with_tws else None
    out = {}
    for i, rr in enumerate(rids):
        sl = slice(int(bounds[i]), int(bounds[i + 1]))
        out[rr] = dict(ov_idx=ov_idx_g[sl] - ov_base[ov_read[ov_idx_g[sl]]]
                       if bounds[i + 1] > bounds[i] else z,
                       ws=ws[sl], wlen=wlen[sl], thre=thre[sl],
                       last=last[sl])
        if t_ws is not None:
            out[rr]["t_ws"] = t_ws[sl]
    return out


def _tws_many(items, ov_idx_g, ws):
    """plan_read_windows' t_ws for every window of a chunk: the nearest
    chain hit at or after the window start within its overlap's hits."""
    nz = [ov for _, ov in items if len(ov)]
    n_hits = np.concatenate([ov.n_hits.astype(np.int64) for ov in nz])
    base = np.cumsum([0] + [len(ov.hit_self) for ov in nz[:-1]])
    start = np.concatenate([ov.hit_start.astype(np.int64) + b
                            for ov, b in zip(nz, base)])
    h_self = np.concatenate([ov.hit_self.astype(np.int64) for ov in nz])
    h_t = np.concatenate([ov.hit_t.astype(np.int64) for ov in nz])
    src = np.repeat(start - np.cumsum(n_hits) + n_hits, n_hits) + \
        np.arange(int(n_hits.sum()))
    big = np.int64(1) << np.int64(33)      # self offsets stay below 2^32
    keys = np.repeat(np.arange(len(n_hits)), n_hits) * big + h_self[src]
    seg_end = np.cumsum(n_hits)
    hi = np.minimum(np.searchsorted(keys, ov_idx_g * big + ws),
                    seg_end[ov_idx_g] - 1)
    return h_t[src[hi]] + (ws - h_self[src[hi]])


_T2_NONE = np.int64(-(1 << 62))


def retry_plan(key: np.ndarray, t_ws: np.ndarray, wlen: np.ndarray,
               acc: np.ndarray, win_y: np.ndarray, e: int):
    """Window-boundary retry plan (~recalcate_window_advance,
    Correct.cpp:10935), shared by every engine path.

    A pass-1-rejected window retries at the offset CHAINED from a
    pass-1-accepted neighbor of the SAME overlap (``key``): the previous
    window's precise target end (forward, takes precedence) or the next
    window's precise start minus this window's length (backward).  The
    plan reads ONLY pass-1 results, so one batched retry round keeps all
    engines bit-identical.  Returns (indices, new t_ws).
    """
    n = len(acc)
    t2 = np.full(n, _T2_NONE, np.int64)
    if n > 1:
        ys = win_y[:, 0] - (t_ws.astype(np.int64) - e)
        nxt = np.zeros(n, bool)
        nxt[:-1] = (key[:-1] == key[1:]) & acc[1:] & (ys[1:] >= 0)
        t2[nxt] = win_y[1:, 0][nxt[:-1]] - wlen[nxt]
        prv = np.zeros(n, bool)
        prv[1:] = (key[1:] == key[:-1]) & acc[:-1]
        t2[prv] = win_y[:-1, 1][prv[1:]]
    cand = (~acc) & (t2 != _T2_NONE) & (t2 != t_ws)
    idx = np.flatnonzero(cand)
    return idx, t2[idx]


def _alloc_tracebacks(ov: OverlapRegions) -> OverlapTracebacks:
    n_ov = len(ov)
    spans = (ov.x_e - ov.x_s + 1) if n_ov else np.zeros(0, np.int64)
    off = np.concatenate([[0], np.cumsum(spans)]).astype(np.int64)
    total = int(off[-1])
    return OverlapTracebacks(
        off=off,
        tb=np.full(total, 5, np.uint8),
        ins_cnt=np.zeros(total, np.uint8),
        ins_base=np.zeros(total, np.uint8),
        win_tot=np.zeros(n_ov, np.int32),
        win_ok=np.zeros(n_ov, np.int32),
        err=np.zeros(n_ov, np.int64),
        ts=ov.y_s.copy() if n_ov else np.zeros(0, np.int64),
        te=ov.y_e.copy() if n_ov else np.zeros(0, np.int64),
        x_s=ov.x_s.astype(np.int64).copy() if n_ov else np.zeros(0, np.int64),
    )


def scatter_segments(tbs: OverlapTracebacks, o, col, n, src, tb, ic,
                     ib) -> None:
    """Copy window results into a read's CSR tracebacks: segment k holds
    ``n[k]`` columns from query column ``col[k]`` of overlap ``o[k]``,
    read from the flat ``tb``/``ic``/``ib`` arrays at ``src[k]``."""
    n = np.asarray(n, np.int64)
    tot = int(n.sum())
    seg = np.arange(tot) - np.repeat(np.cumsum(n) - n, n)
    dst = np.repeat(tbs.off[o] + col - tbs.x_s[o], n) + seg
    s = np.repeat(src, n) + seg
    tbs.tb[dst] = tb[s]
    tbs.ins_cnt[dst] = ic[s]
    tbs.ins_base[dst] = ib[s]


def seam_insert(tbs: OverlapTracebacks, o: int, qcol: int, g: int,
                base: int) -> None:
    """A window seam's ``g`` skipped target bases of one homopolymer run
    ``base``, written as an insertion after query column ``qcol`` (the
    left window's last) of overlap ``o``: taken where the column has no
    insertion, added to one of the same base."""
    col = int(tbs.off[o] + qcol - tbs.x_s[o])
    if tbs.ins_cnt[col] == 0:
        tbs.ins_cnt[col] = min(g, 255)
        tbs.ins_base[col] = base
    elif tbs.ins_base[col] == base:
        tbs.ins_cnt[col] = min(int(tbs.ins_cnt[col]) + g, 255)


@dataclass
class WindowColumns:
    """Some columns of one read's final window results (pass 1, or the
    retry where it won), as gathered from K1's outputs on the device:
    segment k is ``n[k]`` columns from query column ``col[k]`` of overlap
    ``o[k]``, at ``src[k]`` in the flat ``tb``/``ins_cnt``/``ins_base``
    arrays; ``seams`` [k, 4] int64 rows (overlap, query column, gap,
    base) are the window seams of those columns."""

    o: np.ndarray
    col: np.ndarray
    n: np.ndarray
    src: np.ndarray
    tb: np.ndarray
    ins_cnt: np.ndarray
    ins_base: np.ndarray
    seams: np.ndarray

    def tracebacks(self, ov: OverlapRegions) -> OverlapTracebacks:
        """The read's tracebacks over these columns, the host path's
        (``align_overlaps``) there: the columns scattered as
        ``WindowBatcher._scatter`` does, then the seam insertions; every
        other column unaligned (5)."""
        tbs = _alloc_tracebacks(ov)
        scatter_segments(tbs, self.o, self.col, self.n, self.src, self.tb,
                         self.ins_cnt, self.ins_base)
        for o, qcol, g, base in self.seams.tolist():
            seam_insert(tbs, o, qcol, g, base)
        return tbs


class WindowBatcher:
    """Accumulates window jobs across many reads, runs them in large
    batches, scatters results back into per-read tracebacks.

    Two execution paths: the zero-copy native job kernel (default when
    available — window sequences are addressed, never copied) and the
    legacy engine path (numpy / jax engines, used by tests and when the
    native library is absent)."""

    def __init__(self, get_target: Callable[[int, int], np.ndarray],
                 e_rate: float, wl: int = WINDOW_HC,
                 engine: Optional[Engine] = None, chunk: int = 32768):
        self.get_target = get_target
        self.e_rate = e_rate
        self.wl = wl
        self.engine = engine
        self.chunk = chunk
        self._reads: List[tuple] = []     # (q, ov, tbs, plan)

    def add_read(self, q: np.ndarray, ov: OverlapRegions
                 ) -> OverlapTracebacks:
        tbs = _alloc_tracebacks(ov)
        self._reads.append((q, ov, tbs, None))
        return tbs

    # ---- shared helpers ----
    def _plan_all(self):
        """Window planning for EVERY queued read in one vectorized pass
        (same per-window math as plan_read_windows; the per-overlap hit
        searchsorted runs globally on (overlap << 32) + pos keys).
        Also fills each read's win_tot."""
        R = len(self._reads)
        n_ovs = np.array([len(ov) for _, ov, _, _ in self._reads],
                         np.int64)
        obase = np.zeros(R + 1, np.int64)
        np.cumsum(n_ovs, out=obase[1:])
        NO = int(obase[-1])
        if NO == 0:
            z = np.zeros(0, np.int64)
            return dict(ws=z, wlen=z, t_ws=z, thre=z,
                        last=np.zeros(0, bool), read=z, ov=z)
        ovs = [ov for _, ov, _, _ in self._reads]
        x_s = np.concatenate([ov.x_s for ov in ovs])
        x_e = np.concatenate([ov.x_e for ov in ovs])
        n_hits = np.concatenate([ov.n_hits for ov in ovs])
        hsz = np.array([len(ov.hit_self) for ov in ovs], np.int64)
        hbase = np.zeros(R + 1, np.int64)
        np.cumsum(hsz, out=hbase[1:])
        hit_self = np.concatenate([ov.hit_self for ov in ovs])
        hit_t = np.concatenate([ov.hit_t for ov in ovs])
        hit_start = np.concatenate(
            [ov.hit_start + hbase[r] for r, ov in enumerate(ovs)])
        read_of_ov = np.repeat(np.arange(R), n_ovs)

        wl = self.wl
        spans = (x_e - x_s + 1).astype(np.int64)
        yid = np.concatenate([ov.y_id for ov in ovs])
        rev = np.concatenate([ov.rev for ov in ovs])
        p0 = _grid_phase(yid, rev, wl)
        P = np.where(p0 == 0, wl, p0)
        n_win = 1 + np.maximum(-(-(spans - P) // wl), 0)
        tot = int(n_win.sum())
        ov_g = np.repeat(np.arange(NO), n_win)
        woff = np.zeros(NO + 1, np.int64)
        np.cumsum(n_win, out=woff[1:])
        local = np.arange(tot) - np.repeat(woff[:-1], n_win)
        ws = x_s[ov_g] + np.where(local == 0, 0,
                                  P[ov_g] + (local - 1) * wl)
        wlen = np.minimum(x_s[ov_g] + P[ov_g] + local * wl,
                          x_e[ov_g] + 1) - ws
        last = ws + wlen > x_e[ov_g]
        # nearest chain hit at-or-after each window start
        ov_of_hit = np.repeat(np.arange(NO), n_hits)
        comb = (ov_of_hit << 32) + hit_self
        p = np.searchsorted(comb, (ov_g << 32) + ws)
        hs0 = hit_start[ov_g]
        loc = np.minimum(p - hs0, n_hits[ov_g] - 1)
        g = hs0 + loc
        t_ws = hit_t[g] + (ws - hit_self[g])
        thre = np.clip(np.ceil(wlen * self.e_rate).astype(np.int64), 2,
                       THRESHOLD_MAX_SIZE)
        wt = np.bincount(ov_g, minlength=NO).astype(np.int32)
        for r, (_, ov, tbs, _) in enumerate(self._reads):
            tbs.win_tot[:] = wt[obase[r]:obase[r + 1]]
        return dict(read=read_of_ov[ov_g], ov=ov_g - obase[read_of_ov[ov_g]],
                    ws=ws, wlen=wlen, t_ws=t_ws, thre=thre, last=last)

    def _scatter(self, jobs, sel, wlen_eff, out_tb, out_ic, out_ib,
                 accepted, err, win_y):
        """Vectorized per-read scatter of accepted windows into the CSR
        traceback arrays."""
        XL = out_tb.shape[1]
        flat = (out_tb.reshape(-1), out_ic.reshape(-1), out_ib.reshape(-1))
        for i, (q, ov, tbs, pl) in enumerate(self._reads):
            m = accepted & (jobs["read"][sel] == i)
            if not m.any():
                continue
            widx = np.flatnonzero(m)
            o = jobs["ov"][sel][widx]
            scatter_segments(tbs, o, jobs["ws"][sel][widx], wlen_eff[widx],
                             widx * XL, *flat)
            np.add.at(tbs.win_ok, o, 1)
            np.add.at(tbs.err, o, err[widx])

    def _read_bounds(self, jobs):
        """Per-read job ranges; jobs are appended in read order, so
        jobs["read"] is nondecreasing and ranges come from searchsorted."""
        return np.searchsorted(jobs["read"],
                               np.arange(len(self._reads) + 1))

    def _finalize_ranges(self, jobs, acc_all, win_y):
        """Per-overlap precise target range from first/last accepted
        window (global y can be slightly negative from virtual pads)."""
        rb = self._read_bounds(jobs)
        for i, (q, ov, tbs, pl) in enumerate(self._reads):
            s, e = int(rb[i]), int(rb[i + 1])
            if s == e:
                continue
            acc = acc_all[s:e]
            if not acc.any():
                continue
            widx = s + np.flatnonzero(acc)
            o = jobs["ov"][widx]
            n_ov = len(ov)
            first_w = np.full(n_ov, len(jobs["read"]), np.int64)
            last_w = np.full(n_ov, -1, np.int64)
            np.minimum.at(first_w, o, widx)
            np.maximum.at(last_w, o, widx)
            has = last_w >= 0
            fw = first_w[has]
            lw = last_w[has]
            tbs.ts[has] = np.maximum(win_y[fw, 0], 0)
            tbs.te[has] = win_y[lw, 1] - 1

    def flush(self) -> None:
        jobs = self._plan_all()
        n = len(jobs["ws"])
        if n == 0:
            self._reads.clear()
            return
        native = None
        if self.engine is None:
            try:
                from hifiasm_tpu_torch.native import banded_jobs_native, get_lib
                if get_lib() is not None:
                    native = banded_jobs_native
            except Exception:
                native = None
        if native is not None:
            self._flush_native(jobs, n, native)
        else:
            self._flush_engine(jobs, n)
        self._reads.clear()

    # ---- native zero-copy path ----
    def _flush_native(self, jobs, n, native) -> None:
        # flat sequence arena: queries first, then each referenced target
        qbase = np.zeros(len(self._reads), np.int64)
        bufs = []
        off = 0
        for i, (q, ov, tbs, pl) in enumerate(self._reads):
            qbase[i] = off
            bufs.append(q)
            off += len(q)
        rb = self._read_bounds(jobs)
        # job -> (target, strand) key, then one fetch per distinct target
        n_ovs = np.array([len(ov) for _, ov, _, _ in self._reads],
                         np.int64)
        obase = np.zeros(len(self._reads) + 1, np.int64)
        np.cumsum(n_ovs, out=obase[1:])
        key_all = np.concatenate(
            [(ov.y_id.astype(np.int64) << 1) | ov.rev
             for _, ov, _, _ in self._reads]) if self._reads else \
            np.zeros(0, np.int64)
        key_w = key_all[obase[jobs["read"]] + jobs["ov"]]
        uk, inv = np.unique(key_w, return_inverse=True)
        t_arr = [self.get_target(int(k) >> 1, int(k) & 1) for k in uk]
        t_lens = np.array([len(t) for t in t_arr], np.int64)
        t_bases = off + np.concatenate([[0], np.cumsum(t_lens[:-1])]) \
            if len(t_arr) else np.zeros(0, np.int64)
        bufs.extend(t_arr)
        off += int(t_lens.sum())
        t_base_w = t_bases[inv]
        t_len_w = t_lens[inv]
        flat = np.concatenate(bufs) if bufs else np.zeros(0, np.uint8)
        x_off = qbase[jobs["read"]] + jobs["ws"]

        # shared CSR arena; per-read traceback arrays become views into it
        sizes = np.array([int(tbs.off[-1])
                          for _, _, tbs, _ in self._reads], np.int64)
        abase = np.concatenate([[0], np.cumsum(sizes)])
        tb_arena = np.full(int(abase[-1]), 5, np.uint8)
        ic_arena = np.zeros(int(abase[-1]), np.uint8)
        ib_arena = np.zeros(int(abase[-1]), np.uint8)
        dst_base = np.empty(n, np.int64)
        for i, (q, ov, tbs, pl) in enumerate(self._reads):
            s, e = int(rb[i]), int(rb[i + 1])
            o = jobs["ov"][s:e]
            dst_base[s:e] = abase[i] + tbs.off[o] + jobs["ws"][s:e] - \
                tbs.x_s[o]
            tbs.tb = tb_arena[abase[i]:abase[i + 1]]
            tbs.ins_cnt = ic_arena[abase[i]:abase[i + 1]]
            tbs.ins_base = ib_arena[abase[i]:abase[i + 1]]
            tbs.arena = (tb_arena, ic_arena, ib_arena)
            tbs.arena_base = int(abase[i])

        accept_thre = np.minimum(jobs["thre"] * 2, THRESHOLD_MAX_SIZE)
        win_y = np.zeros((n, 2), np.int64)
        acc_all = np.zeros(n, bool)
        err_all = np.zeros(n, np.int64)
        e = THRESHOLD_MAX_SIZE
        for c0 in range(0, n, self.chunk):
            sel = np.arange(c0, min(c0 + self.chunk, n))
            err, ys, yn = native(
                flat, x_off[sel], jobs["wlen"][sel], t_base_w[sel],
                jobs["t_ws"][sel], t_len_w[sel],
                jobs["last"][sel].astype(np.uint8), dst_base[sel],
                accept_thre[sel], tb_arena, ic_arena, ib_arena,
                self.wl, e)
            y0 = jobs["t_ws"][sel] - e
            acc_all[sel] = err >= 0
            err_all[sel] = err
            win_y[sel, 0] = y0 + ys
            win_y[sel, 1] = y0 + yn
        # one boundary-retry round for rejected windows (pass-1 plan)
        key = (jobs["read"].astype(np.int64) << 32) | jobs["ov"]
        ridx, t2 = retry_plan(key, jobs["t_ws"], jobs["wlen"], acc_all,
                              win_y, e)
        for c0 in range(0, len(ridx), self.chunk):
            rs = ridx[c0:c0 + self.chunk]
            tw = t2[c0:c0 + self.chunk]
            err, ys, yn = native(
                flat, x_off[rs], jobs["wlen"][rs], t_base_w[rs], tw,
                t_len_w[rs], jobs["last"][rs].astype(np.uint8),
                dst_base[rs], accept_thre[rs], tb_arena, ic_arena,
                ib_arena, self.wl, e)
            ok = err >= 0
            upd = rs[ok]
            acc_all[upd] = True
            err_all[upd] = err[ok]
            y0r = tw[ok] - e
            win_y[upd, 0] = y0r + ys[ok]
            win_y[upd, 1] = y0r + yn[ok]
        # per-overlap stats (vectorized per read)
        for i, (q, ov, tbs, pl) in enumerate(self._reads):
            s, e = int(rb[i]), int(rb[i + 1])
            acc = acc_all[s:e]
            if not acc.any():
                continue
            o = jobs["ov"][s:e][acc]
            n_ov = len(ov)
            tbs.win_ok[:] += np.bincount(o, minlength=n_ov
                                         ).astype(np.int32)
            tbs.err[:] += np.bincount(o, weights=err_all[s:e][acc],
                                      minlength=n_ov).astype(np.int64)
        self._inject_seams(jobs, acc_all, win_y)
        self._finalize_ranges(jobs, acc_all, win_y)

    # ---- legacy engine path (numpy / jax / explicit engines) ----
    def _engine_chunk(self, engine, jobs, sel, t_ws, accept_thre,
                      acc_all, win_y, e):
        """Align one chunk of window jobs (t_ws may be a retry plan) and
        scatter accepted tracebacks; updates acc_all/win_y in place."""
        B = len(sel)
        XL = self.wl
        YL = XL + 2 * e
        xb = np.full((B, XL), 4, np.uint8)
        yb = np.full((B, YL), 4, np.uint8)
        xlen = np.zeros(B, np.int64)
        ylen = np.zeros(B, np.int64)
        y0 = np.zeros(B, np.int64)
        for bi, w in enumerate(sel):
            q, ov, tbs, pl = self._reads[int(jobs["read"][w])]
            ws = int(jobs["ws"][w])
            wlen = int(jobs["wlen"][w])
            xb[bi, :wlen] = q[ws:ws + wlen]
            xlen[bi] = wlen
            o = int(jobs["ov"][w])
            t = self.get_target(int(ov.y_id[o]), int(ov.rev[o]))
            y0v = int(t_ws[bi]) - e
            src_lo = max(0, y0v)
            src_hi = min(len(t), y0v + wlen + 2 * e)
            if src_hi <= src_lo:
                continue
            yb[bi, src_lo - y0v:src_hi - y0v] = t[src_lo:src_hi]
            ylen[bi] = src_hi - y0v
            y0[bi] = y0v
            if jobs["last"][w] and ylen[bi] < xlen[bi]:
                xlen[bi] = ylen[bi]
        out = engine(xb, xlen, yb, ylen, e)
        accepted = (out.err >= 0) & (out.err <= accept_thre[sel])
        acc_all[sel] = accepted
        win_y[sel, 0] = y0 + out.y_start
        win_y[sel, 1] = y0 + out.y_end
        self._scatter(jobs, sel, xlen, out.tb_base, out.ins_cnt,
                      out.ins_base, accepted, out.err.astype(np.int64),
                      win_y)

    def _flush_engine(self, jobs, n) -> None:
        engine = self.engine or banded_batch_np
        e = THRESHOLD_MAX_SIZE
        accept_thre = np.minimum(jobs["thre"] * 2, THRESHOLD_MAX_SIZE)
        win_y = np.zeros((n, 2), np.int64)
        acc_all = np.zeros(n, bool)
        ck = min(self.chunk, 4096)
        for c0 in range(0, n, ck):
            sel = np.arange(c0, min(c0 + ck, n))
            self._engine_chunk(engine, jobs, sel, jobs["t_ws"][sel],
                               accept_thre, acc_all, win_y, e)
        # one boundary-retry round for rejected windows (pass-1 plan)
        key = (jobs["read"].astype(np.int64) << 32) | jobs["ov"]
        ridx, t2 = retry_plan(key, jobs["t_ws"], jobs["wlen"], acc_all,
                              win_y, e)
        for c0 in range(0, len(ridx), ck):
            self._engine_chunk(engine, jobs, ridx[c0:c0 + ck],
                               t2[c0:c0 + ck], accept_thre, acc_all,
                               win_y, e)
        self._inject_seams(jobs, acc_all, win_y)
        self._finalize_ranges(jobs, acc_all, win_y)

    def seam_sites(self, jobs, acc_all, win_y):
        """Window-SEAM insertion evidence (~the reference's round-2
        window repair, ecovlp.cpp's second `cal_ec_r` pass): an
        insertion straddling the boundary between two windows is
        invisible to both windows' alignments — window k's optimal path
        ends before the extra target base and window k+1 starts after
        it (its t_ws comes from a chain hit past the seam).  The
        skipped target bases show up as a GAP between consecutive
        accepted windows' target ranges.  Returns (w, gap) arrays:
        job index of the LEFT window and the number of skipped target
        bases (1..MAX_INS_TRACK candidates only)."""
        read = jobs["read"]
        ovw = jobs["ov"]
        ws = jobs["ws"]
        if len(read) < 2:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        same = (read[1:] == read[:-1]) & (ovw[1:] == ovw[:-1]) & \
            (ws[1:] == ws[:-1] + self.wl)
        cand = np.flatnonzero(same & acc_all[1:] & acc_all[:-1])
        gap = win_y[cand + 1, 0] - win_y[cand, 1]
        keep = (gap >= 1) & (gap <= 8)
        return cand[keep], gap[keep]

    def _inject_seams(self, jobs, acc_all, win_y) -> None:
        """Write homopolymer seam insertions into the traceback arrays
        at the left window's last column (engine + native-jobs paths
        share this; the fused native kernel and the device path apply
        the identical rule in their own vote accumulators)."""
        cand, gap = self.seam_sites(jobs, acc_all, win_y)
        for w, g in zip(cand.tolist(), gap.tolist()):
            q, ov, tbs, pl = self._reads[int(jobs["read"][w])]
            o = int(jobs["ov"][w])
            t = self.get_target(int(ov.y_id[o]), int(ov.rev[o]))
            lo = int(win_y[w, 1])
            seg = t[lo:lo + int(g)]
            if len(seg) == 0 or (seg != seg[0]).any() or seg[0] > 3:
                continue                # mixed-content/N seam: leave it
            seam_insert(tbs, o, int(jobs["ws"][w] + jobs["wlen"][w] - 1),
                        int(g), int(seg[0]))


def align_overlaps(q: np.ndarray, ov: OverlapRegions,
                   get_target: Callable[[int, int], np.ndarray],
                   e_rate: float, wl: int = WINDOW_HC,
                   engine: Optional[Engine] = None) -> OverlapTracebacks:
    """Single-read convenience wrapper around WindowBatcher."""
    wb = WindowBatcher(get_target, e_rate, wl, engine=engine)
    tbs = wb.add_read(q, ov)
    wb.flush()
    return tbs
