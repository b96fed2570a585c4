"""Device-resident anchor chaining for the EC front end (PyTorch ops).

The port of hifiasm_tpu/overlap/chain_device.py.  The sorted anchors of
a chunk stay on the device (index/pos_table_dev.py); every (read, tid,
rev) group of at most 2,048 anchors runs the quick chain pass there
(ops/chain_batch.chain_quick_batch).  A group that passes IS one chain
over all its anchors (``quick_ck_lchain``, Hash_Table.cpp:2007), so its
score, endpoints and hits have closed forms.  The other groups (the
quick pass fails, or the group is larger than the top bucket) take the
host scalar DP (``lchain_qdp_mcopy_fast``, Hash_Table.cpp:2097) on their
own anchors only: the reference's own shortcut, and each kind is counted
in ``STATS``.  Only per-group and per-chain numbers reach the host, where
the region assembly, quota and dedup of overlap/anchors.py run as they
are.  The window planner's one per-hit need, the chain hit at or after
each window start (t_ws), is a device search over the chunk's anchors
(``tws_for_windows``).

The JAX package stacks groups into fixed pow2 slabs and scans them in
one launch for XLA's compile cache; here a bucket's groups run in slabs
sized only to bound memory, and a quick chain's hits are its group's
rows of the sorted anchor columns, so nothing is copied for them.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from hifiasm_tpu_torch.ops.chain import ChainParams, chain_dp_group
from hifiasm_tpu_torch.ops.chain_batch import chain_quick_batch
from hifiasm_tpu_torch.overlap.anchors import OverlapRegions, _finish_regions
from hifiasm_tpu_torch.utils import trace

_BUCKETS = (32, 128, 512, 2048)
_SLAB_CELLS = 1 << 22        # [groups, Nb] cells per quick-pass slab

# counters of the runs since the caller last reset them: seconds
# (trace.span) of the device quick pass (synced at its fetch) and of the
# host DP, and groups by route: quick on the device, host DP because the
# quick pass failed, host DP because the group is larger than the top
# bucket
STATS = trace.register("chain_device", {
    "quick_s": 0.0, "host_dp_s": 0.0, "quick_groups": 0,
    "host_nonquick_groups": 0, "host_oversize_groups": 0})


def _ranges(starts: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Concatenated [s, s + n) index ranges."""
    rep = torch.repeat_interleave(torch.arange(sizes.numel(),
                                               device=sizes.device), sizes)
    first = torch.cumsum(sizes, 0) - sizes
    return starts[rep] + torch.arange(rep.numel(), device=sizes.device) \
        - first[rep]


def gather_groups(cols, g_start, gids, sizes, Nb: int):
    """[P] anchor columns -> [G, Nb] padded (qpos, toff, span, w) of the
    groups ``gids`` (port of _gather_groups); pad entries are 0."""
    P = cols["qpos"].numel()
    ar = torch.arange(Nb, device=gids.device)[None, :]
    idx = (g_start[gids][:, None] + ar).clamp(0, P - 1)
    m = ar < sizes[:, None]
    return tuple(torch.where(m, cols[k][idx], torch.zeros_like(idx))
                 for k in ("qpos", "toff", "span", "w"))


def _host_chains(cols, meta, gids: np.ndarray, rlens, tlens,
                 params: ChainParams):
    """Host scalar DP over the anchors of groups ``gids`` (only those
    anchors are fetched); returns [(qpos, toff, [(score, idx), ...])]."""
    dev = cols["qpos"].device
    s = meta["g_start"][gids]
    n = meta["g_end"][gids] - s
    idx = _ranges(torch.from_numpy(s).to(dev), torch.from_numpy(n).to(dev))
    so, to, sp, w = (cols[k][idx].cpu().numpy()
                     for k in ("qpos", "toff", "span", "w"))
    off = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    xl = rlens[meta["g_read"][gids]].astype(np.int64)
    yl = tlens[meta["g_tid"][gids]].astype(np.int64)
    # the native kernel is bit-identical with chain_dp_group (the same
    # choice as overlap/anchors.chain_many)
    from hifiasm_tpu_torch.native import chain_groups_native
    nat = chain_groups_native(off, so, to, sp, w, xl, yl, params)
    out = []
    for i in range(len(gids)):
        a, b = int(off[i]), int(off[i + 1])
        if nat is None:
            chains = chain_dp_group(so[a:b], to[a:b], sp[a:b], w[a:b],
                                    int(xl[i]), int(yl[i]), params)
        else:
            cnt, score, start, hits, hit_idx = nat     # start: into hit_idx
            chains = [(int(score[i, k]),
                       hit_idx[start[i, k]:start[i, k] + hits[i, k]])
                      for k in range(int(cnt[i]))]
        out.append((so[a:b], to[a:b], chains))
    return out


def _quick_pass(cols, meta, rlens: np.ndarray, tlens: np.ndarray,
                params: ChainParams):
    """The quick chain pass of every group of a chunk on the device, by
    size bucket.  Returns, per group, whether it passed, its score and
    the endpoints (qpos and toff of its first and last anchors) on the
    host, and the groups' sizes and ends on the device."""
    g_start, g_end = meta["g_start"], meta["g_end"]
    sizes = g_end - g_start
    ng = len(sizes)
    dev = cols["qpos"].device
    gs_d = torch.from_numpy(g_start).to(dev)
    ge_d = torch.from_numpy(g_end).to(dev)
    sz_d = ge_d - gs_d
    xl_d = torch.from_numpy(rlens[meta["g_read"]].astype(np.int64)).to(dev)
    yl_d = torch.from_numpy(tlens[meta["g_tid"]].astype(np.int64)).to(dev)
    quick_d = torch.zeros(ng, dtype=torch.bool, device=dev)
    score_d = torch.zeros(ng, dtype=torch.int32, device=dev)
    lo = 0
    for Nb in _BUCKETS:
        gids = np.flatnonzero((sizes > lo) & (sizes <= Nb))
        lo = Nb
        slab = max(1, _SLAB_CELLS // Nb)
        for r0 in range(0, len(gids), slab):
            gi = torch.from_numpy(gids[r0:r0 + slab]).to(dev)
            so, to, sp, w = gather_groups(cols, gs_d, gi, sz_d[gi], Nb)
            fq, _, quick = chain_quick_batch(
                so, to, sp, w, sz_d[gi], xl_d[gi], yl_d[gi],
                quick_check=params.quick_check, pg_q16=params.pg_q16,
                pskip_q16=params.pskip_q16, bw_q16=params.bw_q16,
                invbw_q4=params.invbw_q4)
            quick_d[gi] = quick
            score_d[gi] = fq[torch.arange(gi.numel(), device=dev),
                             sz_d[gi] - 1]
    ends = (cols["qpos"][gs_d], cols["qpos"][ge_d - 1],
            cols["toff"][gs_d], cols["toff"][ge_d - 1])
    return (tuple(t.cpu().numpy() for t in (quick_d, score_d) + ends),
            sz_d, ge_d)


class DeviceChunkChains:
    """Chained anchors of one collect chunk; the anchors stay on the
    device.  Per chain (group order, then copy order): ``g_of``,
    ``score``, ``n_hits``, endpoints ``xs``/``xe``/``ts``/``te`` and
    ``host_ref`` (-1 for a quick chain, whose hits are its group's
    anchors; else an index into the host-DP hit list)."""

    def __init__(self, cols, meta, rlens: np.ndarray, tlens: np.ndarray,
                 params: ChainParams):
        self.meta = meta
        self.cols = cols
        z = np.zeros(0, np.int64)
        self.g_of = self.score = self.n_hits = self.host_ref = z
        self.xs = self.xe = self.ts = self.te = z
        self._host_hits: List[Tuple[np.ndarray, np.ndarray]] = []
        if cols is None or meta["n_keep"] == 0:
            return
        sizes = meta["g_end"] - meta["g_start"]
        with trace.span("ec.quick", STATS, "quick_s"):
            (quick, score, xs, xe, ts, te), sz_d, ge_d = _quick_pass(
                cols, meta, rlens, tlens, params)
        oversize = sizes > _BUCKETS[-1]
        host = np.flatnonzero(~quick)
        STATS["quick_groups"] += int(quick.sum())
        STATS["host_oversize_groups"] += int(oversize.sum())
        STATS["host_nonquick_groups"] += int((~quick & ~oversize).sum())

        q = np.flatnonzero(quick)
        rows = [(q, score[q].astype(np.int64), sizes[q], xs[q], xe[q],
                 ts[q], te[q], np.full(len(q), -1, np.int64))]
        if len(host):
            with trace.span("ec.host_dp", STATS, "host_dp_s"):
                for g, (so_h, to_h, chains) in zip(
                        host, _host_chains(cols, meta, host, rlens, tlens,
                                           params)):
                    for sck, idx in chains:
                        rows.append((
                            np.array([g]), np.array([sck]),
                            np.array([len(idx)]), so_h[idx[:1]],
                            so_h[idx[-1:]], to_h[idx[:1]], to_h[idx[-1:]],
                            np.array([len(self._host_hits)])))
                        self._host_hits.append((so_h[idx].astype(np.int64),
                                                to_h[idx].astype(np.int64)))
        # groups in ascending order, chains in copy order: the order in
        # which the host chain_many emits regions
        c = [np.concatenate([r[i] for r in rows]).astype(np.int64)
             for i in range(8)]
        o = np.argsort(c[0], kind="stable")
        (self.g_of, self.score, self.n_hits, self.xs, self.xe, self.ts,
         self.te, self.host_ref) = (a[o] for a in c)
        # search key of every anchor: (group, qpos), ascending over the
        # sorted columns
        gid = torch.repeat_interleave(
            torch.arange(len(sizes), device=sz_d.device), sz_d)
        self._key = (gid << 32) | cols["qpos"]
        self._g_end = ge_d

    def tws_for_windows(self, chain_idx: np.ndarray, ws: np.ndarray
                        ) -> np.ndarray:
        """t_ws per window (port of _tws_kernel): the first chain hit at
        or after ws (else the chain's last hit) maps ws to the target,
        as plan_read_windows' searchsorted does.  ``chain_idx`` indexes
        this chunk's chains."""
        out = np.zeros(len(ws), np.int64)
        ref = self.host_ref[chain_idx]
        d = np.flatnonzero(ref < 0)
        if len(d):
            dev = self._key.device
            g = torch.from_numpy(self.g_of[chain_idx[d]]).to(dev)
            wq = torch.from_numpy(np.asarray(ws[d], np.int64)).to(dev)
            j = torch.minimum(torch.searchsorted(self._key, (g << 32) | wq),
                              self._g_end[g] - 1)
            out[d] = (self.cols["toff"][j] + wq -
                      self.cols["qpos"][j]).cpu().numpy()
        for i in np.flatnonzero(ref >= 0):
            hs, ht = self._host_hits[int(ref[i])]
            j = min(int(np.searchsorted(hs, ws[i])), len(hs) - 1)
            out[i] = ht[j] + (ws[i] - hs[j])
        return out


def regions_from_device_chains(dcc: DeviceChunkChains, rlens: np.ndarray,
                               tlens: np.ndarray, max_n_chain: int = 100
                               ) -> List[Tuple[int, OverlapRegions]]:
    """Per-read OverlapRegions from the chain metadata: the same boundary
    extension, quota, dedup and order as the host chain_many
    (overlap/anchors._assemble_regions / _finish_regions), with the hits
    left on the device (``hit_ref`` names each region's chain)."""
    meta = dcc.meta
    out = []
    nch = len(dcc.g_of)
    seg_of = {}
    if nch:
        gr = meta["g_read"][dcc.g_of]
        gt = meta["g_tid"][dcc.g_of]
        gv = meta["g_rev"][dcc.g_of]
        xs, xe = dcc.xs.copy(), dcc.xe.copy()
        ts, te = dcc.ts.copy(), dcc.te.copy()
        # extend to boundaries (push_ovlp_chain_qgen, Hash_Table.cpp:1752)
        shift = np.minimum(xs, ts)
        xs -= shift
        ts -= shift
        ext = np.minimum(rlens[gr] - xe - 1, tlens[gt] - te - 1)
        xe += ext
        te += ext
        bnd = np.flatnonzero(np.diff(gr)) + 1
        seg_of = {int(gr[s]): (s, e) for s, e in
                  zip(np.concatenate([[0], bnd]), np.append(bnd, nch))}
    for rr in meta["reads"]:
        ov = OverlapRegions(rr)
        if rr in seg_of:
            sel = np.arange(*seg_of[rr])
            ov.y_id = gt[sel].astype(np.uint32)
            ov.rev = gv[sel].astype(np.uint8)
            ov.x_s, ov.x_e = xs[sel], xe[sel]
            ov.y_s, ov.y_e = ts[sel], te[sel]
            ov.score = dcc.score[sel]
            ov.n_hits = dcc.n_hits[sel]
            ov.hit_start = np.zeros(len(sel), np.int64)
            ov.hit_ref = sel
            ov = _finish_regions(ov, int(rlens[rr]), max_n_chain)
        out.append((rr, ov))
    return out
