"""Window planning and the traceback layout of error correction.

Re-expresses the planning half of ``gen_hc_r_alin_ea`` (ecovlp.cpp:2810):
each overlap region is sliced into windows of ``wl`` (WINDOW_HC = 775 for
HiFi) on the query; the matching target slice is located from the chain
hits (the reference interpolates its "fake cigar" gap-shift checkpoints,
Hash_Table.h:71-76); each window gets the error budget
``ceil(wlen * e_rate)`` capped at THRESHOLD_MAX_SIZE = 31
(``plan_read_windows``, ``plan_windows_many``), and a failed window is
retried once at an offset chained from an accepted neighbour
(``retry_plan``, the reference's double_error_threshold retry in
Correct.cpp's verify_window flow).  The windows themselves are aligned on
the device (ec/device_ec.py, K1).

``OverlapTracebacks`` is one read's per-overlap alignment columns in CSR
layout; the host DAG pass rebuilds it from the columns DeviceEC gathers
(``WindowColumns.tracebacks``: ``scatter_segments``, ``seam_insert``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hifiasm_tpu_torch.config import THRESHOLD_MAX_SIZE
from hifiasm_tpu_torch.overlap.anchors import OverlapRegions


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

    def view(self, o: int, field: str) -> np.ndarray:
        a = getattr(self, field)
        return a[self.off[o]:self.off[o + 1]]


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
    of per-base phases) is the JAX package's, whose host alignment
    kernel needs same-length first windows for its 4-lane SIMD; the port
    keeps it so that its windows, and so its corrections, are the JAX
    package's.  The reference instead
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
    budget), last (final window of its overlap).  With
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
    Correct.cpp:10935).

    A pass-1-rejected window retries at the offset CHAINED from a
    pass-1-accepted neighbor of the SAME overlap (``key``): the previous
    window's precise target end (forward, takes precedence) or the next
    window's precise start minus this window's length (backward).  The
    plan reads ONLY pass-1 results, so one batched retry round is the
    JAX package's, bit for bit.  Returns (indices, new t_ws).
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
        """The read's tracebacks over these columns, as the JAX package's
        host alignment (``align_overlaps``) gives them there: the columns
        scattered, then the seam insertions; every other column
        unaligned (5)."""
        tbs = _alloc_tracebacks(ov)
        scatter_segments(tbs, self.o, self.col, self.n, self.src, self.tb,
                         self.ins_cnt, self.ins_base)
        for o, qcol, g, base in self.seams.tolist():
            seam_insert(tbs, o, qcol, g, base)
        return tbs
