"""String graph construction from overlap records.

Re-expresses the reference's ``asg_t`` (Overlaps.h:223-244) and the
``gen_init_sg`` chain (Overlaps.cpp:39228): symmetrize overlaps, coverage
cut (``ma_hit_sub`` :1931), clip (``ma_hit_cut`` :2533), filter
(``ma_hit_flt`` :1865), containment (``ma_hit_contained_advance`` :1781),
arc generation (``ma_hit2arc`` Overlaps.h:366), and Myers transitive
reduction (``asg_arc_del_trans`` :5357).

Vertices are ``rid << 1 | dir``; arcs are columnar numpy arrays sorted by
``ul = (u << 32) | l`` with a CSR index per vertex — the same packing as the
reference, chosen here because it makes the graph a set of flat arrays that
vectorized passes (and later C++ kernels) can chew through.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from hifiasm_tpu_torch.overlap.paf import PafRecords, PafStore
from hifiasm_tpu_torch.utils.logging import log

MA_HT_INT = -1
MA_HT_QCONT = -2
MA_HT_TCONT = -3
MA_HT_SHORT_OVLP = -4


@dataclass
class CoverageCut:
    """~ma_sub_t per read: retained high-coverage subregion."""

    s: np.ndarray
    e: np.ndarray
    del_: np.ndarray

    @classmethod
    def full(cls, lens: np.ndarray) -> "CoverageCut":
        n = len(lens)
        return cls(np.zeros(n, np.int64), lens.astype(np.int64).copy(),
                   np.zeros(n, np.uint8))


class StringGraph:
    """Columnar asg_t."""

    def __init__(self, n_seq: int, seq_len: np.ndarray):
        self.n_seq = n_seq
        self.seq_len = seq_len.astype(np.int64)
        self.seq_del = np.zeros(n_seq, np.uint8)
        self.ul = np.zeros(0, np.uint64)
        self.v = np.zeros(0, np.uint32)
        self.ol = np.zeros(0, np.int64)
        self.strong = np.zeros(0, np.uint8)
        self.el = np.zeros(0, np.uint8)
        self.no_l_indel = np.zeros(0, np.uint8)
        self.del_ = np.zeros(0, np.uint8)
        self.idx_s = np.zeros(2 * n_seq, np.int64)
        self.idx_n = np.zeros(2 * n_seq, np.int64)

    # --- basic ops ---
    @property
    def n_arcs(self) -> int:
        return len(self.ul)

    def arc_u(self) -> np.ndarray:
        return (self.ul >> np.uint64(32)).astype(np.uint32)

    def arc_len(self) -> np.ndarray:
        return (self.ul & np.uint64(0xFFFFFFFF)).astype(np.int64)

    def set_arcs(self, ul, v, ol, strong, el, no_l_indel, del_=None):
        self.ul = ul.astype(np.uint64)
        self.v = v.astype(np.uint32)
        self.ol = ol.astype(np.int64)
        self.strong = strong.astype(np.uint8)
        self.el = el.astype(np.uint8)
        self.no_l_indel = no_l_indel.astype(np.uint8)
        self.del_ = (del_.astype(np.uint8) if del_ is not None
                     else np.zeros(len(ul), np.uint8))
        self._sort_index()

    def _sort_index(self):
        order = np.argsort(self.ul, kind="stable")
        for f in ("ul", "v", "ol", "strong", "el", "no_l_indel", "del_"):
            setattr(self, f, getattr(self, f)[order])
        u = self.arc_u()
        self.idx_s = np.zeros(2 * self.n_seq, np.int64)
        self.idx_n = np.zeros(2 * self.n_seq, np.int64)
        if len(u):
            uniq, first, cnt = np.unique(u, return_index=True,
                                         return_counts=True)
            self.idx_s[uniq] = first
            self.idx_n[uniq] = cnt

    def cleanup(self):
        """Drop deleted arcs and arcs touching deleted reads; reindex."""
        u = self.arc_u()
        keep = (self.del_ == 0) & (self.seq_del[u >> 1] == 0) & \
               (self.seq_del[self.v >> 1] == 0)
        for f in ("ul", "v", "ol", "strong", "el", "no_l_indel", "del_"):
            setattr(self, f, getattr(self, f)[keep])
        self._sort_index()

    def arcs_of(self, vtx: int) -> np.ndarray:
        """Indices of live arcs out of vertex vtx."""
        s, n = int(self.idx_s[vtx]), int(self.idx_n[vtx])
        idx = np.arange(s, s + n)
        return idx[self.del_[idx] == 0]

    def symm_del(self):
        """Propagate arc deletions to complement arcs (asg_symm analog)."""
        if self.n_arcs == 0:
            return
        u = self.arc_u()
        key = (u.astype(np.uint64) << np.uint64(32)) | self.v.astype(np.uint64)
        ckey = ((self.v.astype(np.uint64) ^ np.uint64(1)) << np.uint64(32)) \
            | (u.astype(np.uint64) ^ np.uint64(1))
        order = np.argsort(key)
        pos = np.minimum(np.searchsorted(key[order], ckey), len(key) - 1)
        comp = order[pos]
        valid = key[order][pos] == ckey
        dead = self.del_ == 1
        self.del_[comp[valid & dead]] = 1


def hit2arc(qs, qe, tn, ts, te, rev, ql, tl, max_hang, int_frac, min_ovlp):
    """Vectorized ma_hit2arc (Overlaps.h:366).

    Returns (code, u, v, l, ol): code >= 0 -> arc; else MA_HT_* classes.
    ``u``/``v`` here are only the DIRECTION bits; caller adds read ids.
    """
    qs = np.asarray(qs, np.int64)
    qe = np.asarray(qe, np.int64)
    ts = np.asarray(ts, np.int64)
    te = np.asarray(te, np.int64)
    rev = np.asarray(rev).astype(bool)
    ql = np.asarray(ql, np.int64)
    tl = np.asarray(tl, np.int64)

    tl5 = np.where(rev, tl - te, ts)
    tl3 = np.where(rev, ts, tl - te)
    ext5 = np.minimum(qs, tl5)
    ext3 = np.minimum(ql - qe, tl3)

    code = np.zeros(len(qs), np.int64)
    bad = (ext5 > max_hang) | (ext3 > max_hang) | \
        (qe - qs < (qe - qs + ext5 + ext3) * int_frac) | \
        (te - ts < (te - ts + ext5 + ext3) * int_frac)
    qcont = (qs <= tl5) & (ql - qe <= tl3)
    tcont = (qs >= tl5) & (ql - qe >= tl3)
    q2t = qs > tl5

    u = np.where(q2t, 0, 1).astype(np.uint32)
    vdir = np.where(q2t, rev.astype(np.uint32), (~rev).astype(np.uint32))
    l = np.where(q2t, qs - tl5, (ql - qe) - tl3)
    short = ((qe - qs + ext5 + ext3) < min_ovlp) | \
            ((te - ts + ext5 + ext3) < min_ovlp)

    code[:] = l
    code = np.where(short, MA_HT_SHORT_OVLP, code)
    code = np.where(tcont, MA_HT_TCONT, code)
    code = np.where(qcont, MA_HT_QCONT, code)
    code = np.where(bad, MA_HT_INT, code)
    ol = ql - l
    return code, u, vdir, l, ol


def normalize_paf(paf: PafStore, lens: np.ndarray,
                  rescue_el: bool = False) -> PafStore:
    """Pair-symmetric overlap normalization
    (~normalize_ma_hit_t_single_side_advance, Overlaps.cpp:1139).

    Matches the reference's semantics: an overlap pair must exist in BOTH
    directions — one-sided pairs are dropped (rescued only when
    ``rescue_el`` is set, the ONT path, and the record is exact/el,
    Overlaps.cpp:1185-1191).  For two-sided pairs the record with the
    longer query span wins (ties: the lower read id's record,
    Overlaps.cpp:1170-1178) and the opposite direction is overwritten
    with its exact coordinate swap (set_reverse_overlap,
    Overlaps.cpp:1093), so reciprocal records stay mirrored — the arc
    symmetry that symm_del and ug_post_join rely on."""
    qn, c = paf.flatten()
    out = PafStore(len(paf))
    if len(qn) == 0:
        return out
    qn = qn.astype(np.uint64)
    tn = c["tn"].astype(np.uint64)
    rev = c["rev"].astype(np.uint64)

    # 1. dedup per (qn, tn, rev): keep max ml (stable on ties)
    key = (qn << np.uint64(33)) | (tn << np.uint64(1)) | rev
    order = np.lexsort((-c["ml"], key))
    ks = key[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    sel = order[first]

    # 2. pair resolution on the deduped records
    dq, dt, dr = qn[sel], tn[sel], rev[sel]
    lo = np.minimum(dq, dt)
    hi = np.maximum(dq, dt)
    pkey = (lo << np.uint64(33)) | (hi << np.uint64(1)) | dr
    side = (dq > dt).astype(np.uint8)            # 0 = record from lower id
    o2 = np.lexsort((side, pkey))
    pks = pkey[o2]
    paired = np.zeros(len(o2), bool)
    paired[:-1] = pks[:-1] == pks[1:]            # row i pairs with i+1
    i0 = o2[np.flatnonzero(paired)]              # side-0 record of each pair
    i1 = o2[np.flatnonzero(paired) + 1]          # side-1 record

    span = c["qe"][sel] - c["qs"][sel]
    win = np.where(span[i1] > span[i0], i1, i0)  # ties -> lower-id side

    # one-sided records: ONT el-rescue only
    si = np.flatnonzero(~_mark(len(sel), i0, i1))
    if rescue_el:
        si = si[c["el"][sel][si] != 0]
    else:
        si = si[:0]

    keep = np.concatenate([win, si])             # indices into `sel`
    if len(keep) == 0:
        return out
    kidx = sel[keep]

    # 3. emit winner + exact mirror for every kept record
    w_qn = qn[kidx].astype(np.uint32)
    w_tn = tn[kidx].astype(np.uint32)
    a_qn = np.concatenate([w_qn, w_tn])
    a_tn = np.concatenate([w_tn, w_qn])
    a_qs = np.concatenate([c["qs"][kidx], c["ts"][kidx]])
    a_qe = np.concatenate([c["qe"][kidx], c["te"][kidx]])
    a_ts = np.concatenate([c["ts"][kidx], c["qs"][kidx]])
    a_te = np.concatenate([c["te"][kidx], c["qe"][kidx]])
    a_rev = np.concatenate([c["rev"][kidx]] * 2)
    a_ml = np.concatenate([c["ml"][kidx]] * 2)
    a_bl = np.concatenate([c["bl"][kidx]] * 2)
    a_el = np.concatenate([c["el"][kidx]] * 2)
    a_nli = np.concatenate([c["no_l_indel"][kidx]] * 2)

    fkey = (a_qn.astype(np.uint64) << np.uint64(33)) | \
        (a_tn.astype(np.uint64) << np.uint64(1)) | a_rev.astype(np.uint64)
    forder = np.argsort(fkey, kind="stable")
    qsel = a_qn[forder]
    bounds = np.flatnonzero(np.diff(qsel)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(forder)]])
    for s, e in zip(starts, ends):
        rid = int(qsel[s])
        idx = forder[s:e]
        out[rid] = PafRecords.from_columns(
            qs=a_qs[idx], qe=a_qe[idx], tn=a_tn[idx], ts=a_ts[idx],
            te=a_te[idx], rev=a_rev[idx], ml=a_ml[idx], bl=a_bl[idx],
            el=a_el[idx], no_l_indel=a_nli[idx])
    return out


def _mark(n: int, *idx_arrays: np.ndarray) -> np.ndarray:
    m = np.zeros(n, bool)
    for a in idx_arrays:
        m[a] = True
    return m


def ma_hit_sub(min_dp: int, paf: PafStore, lens: np.ndarray,
               min_ovlp: int) -> CoverageCut:
    """Per-read longest subregion with coverage >= min_dp (~Overlaps.cpp:1931)."""
    n = len(lens)
    cov = CoverageCut.full(lens)
    if min_dp <= 1:
        return cov
    for i in range(n):
        rec = paf[i]
        live = rec.del_ == 0
        if not live.any():
            cov.s[i] = cov.e[i] = 0
            cov.del_[i] = 1
            continue
        ev = np.concatenate([rec.qs[live] * 2, rec.qe[live] * 2 + 1])
        ev.sort()
        dp = 0
        start = 0
        best = (0, 0)
        for x in ev:
            old = dp
            dp += -1 if (x & 1) else 1
            if old < min_dp <= dp:
                start = x >> 1
            elif old >= min_dp > dp:
                ln = (x >> 1) - start
                if ln > best[1] - best[0]:
                    best = (start, x >> 1)
        if best[1] - best[0] > 0:
            cov.s[i], cov.e[i] = best
        else:
            cov.s[i] = cov.e[i] = 0
            cov.del_[i] = 1
    return cov


def detect_chimeric_reads(paf: PafStore, lens: np.ndarray,
                          cov: CoverageCut, chem_cov: int = 0,
                          chem_flank: int = 0) -> int:
    """Drop reads with an internal low-support junction flanked by
    well-covered sequence (~detect_chimeric_reads, Overlaps.cpp:2449 and
    the ONT chemical-artifact detection gen_chemical_arc_rf,
    ecovlp.cpp:6479): a read spanning a false join has overlaps on both
    sides but <= chem_cov reads across the joint. ``chem_flank`` requires
    > chem_cov support at least that far on both sides (--chem-f); the
    HiFi default (0, 0) keeps the strict zero-gap rule."""
    n_reads = len(paf)
    qn, pcols = paf.flatten()
    qn = qn.astype(np.int64)
    flat_live = (pcols["del_"] == 0) & (cov.del_[qn] == 0)
    lens64 = lens.astype(np.int64)
    n_chim = 0
    if chem_cov == 0 and chem_flank == 0:
        # HiFi default: zero-depth junction == internal gap in the union
        # of overlap intervals — O(n_overlaps), no depth arrays
        q = qn[flat_live]
        qs = pcols["qs"][flat_live].astype(np.int64)
        qe = pcols["qe"][flat_live].astype(np.int64)
        order = np.lexsort((qs, q))
        q, qs, qe = q[order], qs[order], qe[order]
        if len(q):
            big = np.int64(int(lens64.max(initial=0)) + 1)
            cummax_e = np.maximum.accumulate(qe + q * big) - q * big
            same = np.concatenate([[False], q[1:] == q[:-1]])
            gap = same & (qs > np.concatenate([[0], cummax_e[:-1]]))
            if gap.any():
                chim = np.unique(q[gap])
                cov.del_[chim] = 1
                cov.s[chim] = 0
                cov.e[chim] = 0
                n_chim = len(chim)
        if n_chim:
            log("detect_chimeric_reads",
                f"dropped {n_chim} chimeric reads")
        return n_chim
    # chunked flat sweep (vectorized across reads; memory stays bounded)
    CHUNK_BASES = 8_000_000
    r0 = 0
    while r0 < n_reads:
        r1, bases = r0, 0
        while r1 < n_reads and bases < CHUNK_BASES:
            bases += int(lens64[r1])
            r1 += 1
        lens_c = lens64[r0:r1]
        base = np.zeros(r1 - r0 + 1, np.int64)
        np.cumsum(lens_c, out=base[1:])
        tot = int(base[-1])
        sel = flat_live & (qn >= r0) & (qn < r1)
        rid_l = qn[sel] - r0
        gs = base[rid_l] + np.minimum(pcols["qs"][sel], lens_c[rid_l])
        ge = base[rid_l] + np.minimum(pcols["qe"][sel], lens_c[rid_l])
        depth = np.bincount(gs, minlength=tot + 1).astype(np.int64) - \
            np.bincount(ge, minlength=tot + 1).astype(np.int64)
        dp = np.cumsum(depth[:-1])
        # segmented cummax via the +seg*BIG trick (seg non-decreasing)
        seg = np.repeat(np.arange(r1 - r0, dtype=np.int64), lens_c)
        big = np.int64(int(dp.max(initial=0)) + chem_cov + 2)
        pmax = np.maximum.accumulate(dp + seg * big) - seg * big
        smax = (np.maximum.accumulate((dp - seg * big)[::-1])[::-1]
                + seg * big)
        pos = np.arange(tot, dtype=np.int64)
        off = pos - base[seg]                   # position within the read
        interior = (off >= chem_flank) & (off < lens_c[seg] - chem_flank) \
            & (lens_c[seg] > 2 * chem_flank + 1)
        flag = interior & (dp <= chem_cov) & \
            (pmax[np.maximum(pos - chem_flank, base[seg])] > chem_cov) & \
            (smax[np.minimum(pos + chem_flank, base[seg + 1] - 1)]
             > chem_cov)
        if flag.any():
            chim = np.unique(seg[flag]) + r0
            chim = chim[cov.del_[chim] == 0]
            cov.del_[chim] = 1
            cov.s[chim] = 0
            cov.e[chim] = 0
            n_chim += len(chim)
        r0 = r1
    if n_chim:
        log("detect_chimeric_reads", f"dropped {n_chim} chimeric reads")
    return n_chim


def _paf_offsets(paf: PafStore) -> np.ndarray:
    counts = np.fromiter((len(r) for r in paf.recs), np.int64,
                         len(paf.recs))
    off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def ma_hit_cut(paf: PafStore, lens: np.ndarray, cov: CoverageCut,
               min_ovlp: int, flat=None) -> None:
    """Clip overlaps into the coverage-cut subregions and renormalize
    coordinates to the cut frame (~Overlaps.cpp:2533). In-place.

    Runs flat over the whole store (one vectorized pass), then scatters
    the new columns back into the per-read records (or, with ``flat``
    given, updates the shared flat columns in place — gen_init_sg
    flattens once and scatters once for the whole stage chain)."""
    if flat is not None:
        qn, c, _ = flat
    else:
        qn, c = paf.flatten()
    if len(qn) == 0:
        return
    tn = c["tn"]
    rq_s, rq_e = cov.s[qn], cov.e[qn]
    rt_s, rt_e = cov.s[tn], cov.e[tn]
    dead = (cov.del_[qn] == 1) | (cov.del_[tn] == 1) | (c["del_"] == 1)
    rev = c["rev"].astype(bool)
    oqs, oqe, ots, ote = c["qs"], c["qe"], c["ts"], c["te"]
    qs = np.where(rev,
                  np.where(ote < rt_e, oqs, oqs + ote - rt_e),
                  np.where(ots > rt_s, oqs, oqs + rt_s - ots))
    qe = np.where(rev,
                  np.where(ots > rt_s, oqe, oqe - (rt_s - ots)),
                  np.where(ote < rt_e, oqe, oqe - (ote - rt_e)))
    ts = np.where(rev,
                  np.where(oqe < rq_e, ots, ots + oqe - rq_e),
                  np.where(oqs > rq_s, ots, ots + rq_s - oqs))
    te = np.where(rev,
                  np.where(oqs > rq_s, ote, ote - (rq_s - oqs)),
                  np.where(oqe < rq_e, ote, ote - (oqe - rq_e)))
    qs = np.maximum(qs, rq_s) - rq_s
    qe = np.minimum(qe, rq_e) - rq_s
    ts = np.maximum(ts, rt_s) - rt_s
    te = np.minimum(te, rt_e) - rt_s
    ok = (qe - qs >= min_ovlp) & (te - ts >= min_ovlp) & ~dead
    del_ = np.where(ok, 0, 1).astype(np.uint8)
    if flat is not None:
        c["qs"][:], c["qe"][:] = qs, qe
        c["ts"][:], c["te"][:] = ts, te
        c["del_"][:] = del_
        return
    pos = 0
    for i in range(len(paf)):
        rec = paf[i]
        n = len(rec)
        if n == 0:
            continue
        sl = slice(pos, pos + n)
        pos += n
        rec.qs, rec.qe = qs[sl], qe[sl]
        rec.ts, rec.te = ts[sl], te[sl]
        rec.del_ = del_[sl]


def ma_hit_flt(paf: PafStore, cov: CoverageCut, max_hang: int,
               int_frac: float, min_ovlp: int, flat=None) -> None:
    """Drop overlaps ma_hit2arc rejects (~Overlaps.cpp:1865). In-place.

    The hit2arc classification is a pure function of coordinates, so it
    runs ONCE over all records flat; the read loop only applies the
    reference's sequential liveness coupling (a read whose overlaps all
    die is del'd and stops qualifying later reads' overlaps)."""
    if flat is not None:
        qn, c, off = flat
    else:
        qn, c = paf.flatten()
        off = _paf_offsets(paf)
    if len(qn) == 0:
        return
    ql = (cov.e - cov.s)[qn]
    tl = cov.e[c["tn"]] - cov.s[c["tn"]]
    code, _, _, _, _ = hit2arc(c["qs"], c["qe"], c["tn"], c["ts"],
                               c["te"], c["rev"], ql, tl, max_hang,
                               int_frac, min_ovlp)
    code_ok = (code >= 0) | (code == MA_HT_QCONT) | (code == MA_HT_TCONT)
    del_f = c["del_"]
    tn_f = c["tn"]
    use_flat = flat is not None
    for i in range(len(paf)):
        s0, s1 = int(off[i]), int(off[i + 1])
        if s0 == s1:
            continue
        sl = slice(s0, s1)
        d_i = del_f[sl] if use_flat else paf[i].del_
        t_i = tn_f[sl] if use_flat else paf[i].tn
        live = (d_i == 0) & (cov.del_[t_i] == 0) & (cov.del_[i] == 0)
        ok = live & code_ok[sl]
        new_del = np.where(ok, 0, 1).astype(np.uint8)
        if use_flat:
            del_f[sl] = new_del
        else:
            paf[i].del_ = new_del
        if not ok.any():
            cov.del_[i] = 1


def ma_hit_contained(paf: PafStore, cov: CoverageCut, max_hang: int,
                     int_frac: float, min_ovlp: int, flat=None
                     ) -> np.ndarray:
    """Mark contained reads; returns container map r_to_u[rid] = container
    rid or -1 (~ma_hit_contained_advance, Overlaps.cpp:1781)."""
    n = len(paf)
    r_to_u = np.full(n, -1, np.int64)
    # hit2arc codes are a pure function of record coordinates: compute
    # them ONCE over the flat store; the read loop below only applies
    # the reference's sequential containment coupling
    if flat is not None:
        qn_f, c_f, off = flat
    else:
        qn_f, c_f = paf.flatten()
        off = _paf_offsets(paf)
    if len(qn_f):
        ql_f = (cov.e - cov.s)[qn_f]
        tl_f = cov.e[c_f["tn"]] - cov.s[c_f["tn"]]
        code_f, _, _, _, _ = hit2arc(
            c_f["qs"], c_f["qe"], c_f["tn"], c_f["ts"], c_f["te"],
            c_f["rev"], ql_f, tl_f, max_hang, int_frac, min_ovlp)
    del_f = c_f["del_"]
    tn_f = c_f["tn"]
    use_flat = flat is not None
    for i in range(n):
        s0, s1 = int(off[i]), int(off[i + 1])
        if cov.del_[i] or s0 == s1:
            continue
        sl = slice(s0, s1)
        d_i = del_f[sl] if use_flat else paf[i].del_
        t_i = tn_f[sl] if use_flat else paf[i].tn
        live = (d_i == 0) & (cov.del_[t_i] == 0)
        if not live.any():
            continue
        code = code_f[sl]
        qc = live & (code == MA_HT_QCONT)
        tc = live & (code == MA_HT_TCONT)
        for j in np.flatnonzero(qc):
            if cov.del_[i] == 0:
                cov.del_[i] = 1
                r_to_u[i] = int(t_i[j])
            d_i[j] = 1
        for j in np.flatnonzero(tc):
            t = int(t_i[j])
            if cov.del_[t] == 0:
                cov.del_[t] = 1
                r_to_u[t] = i
            d_i[j] = 1
    # resolve container chains (transfor_R_to_U)
    for i in range(n):
        u = r_to_u[i]
        seen = set()
        while u >= 0 and cov.del_[u] and r_to_u[u] >= 0 and u not in seen:
            seen.add(u)
            u = r_to_u[u]
        if r_to_u[i] >= 0:
            r_to_u[i] = u
    # second pass: drop hits touching deleted reads
    for i in range(n):
        s0, s1 = int(off[i]), int(off[i + 1])
        if s0 == s1:
            continue
        sl = slice(s0, s1)
        d_i = del_f[sl] if use_flat else paf[i].del_
        t_i = tn_f[sl] if use_flat else paf[i].tn
        live = (d_i == 0) & (cov.del_[t_i] == 0) & (cov.del_[i] == 0)
        new_del = np.where(live, 0, 1).astype(np.uint8)
        if use_flat:
            del_f[sl] = new_del
        else:
            paf[i].del_ = new_del
        if not live.any() and cov.del_[i] == 0:
            cov.del_[i] = 1
    return r_to_u


def ma_sg_gen(paf: PafStore, cov: CoverageCut, max_hang: int,
              int_frac: float, min_ovlp: int, flat=None) -> StringGraph:
    """Overlap records -> string graph arcs (~ma_sg_gen, Overlaps.cpp)."""
    n = len(paf)
    g = StringGraph(n, (cov.e - cov.s))
    g.seq_del = cov.del_.copy()
    if flat is not None:
        qn, c, _ = flat
    else:
        qn, c = paf.flatten()
    if len(qn):
        live = (c["del_"] == 0) & (cov.del_[qn] == 0) & \
            (cov.del_[c["tn"]] == 0)
        idx = np.flatnonzero(live)
        if len(idx):
            qn_l = qn[idx]
            tn_l = c["tn"][idx]
            ql = (cov.e - cov.s)[qn_l]
            tl = cov.e[tn_l] - cov.s[tn_l]
            code, u, vdir, l, ol = hit2arc(
                c["qs"][idx], c["qe"][idx], tn_l, c["ts"][idx],
                c["te"][idx], c["rev"][idx], ql, tl, max_hang, int_frac,
                min_ovlp)
            good = code >= 0
            gi = idx[good]
            uu = (qn_l[good].astype(np.uint32) << np.uint32(1)) | u[good]
            vv = (tn_l[good].astype(np.uint32) << np.uint32(1)) | \
                vdir[good]
            g.set_arcs(
                (uu.astype(np.uint64) << np.uint64(32))
                | l[good].astype(np.uint64),
                vv,
                ql[good] - l[good],
                (c["ml"][gi] >= c["bl"][gi] * 0.999).astype(np.uint8),
                c["el"][gi], c["no_l_indel"][gi])
    log("ma_sg_gen", f"{g.n_arcs} arcs over {int((cov.del_ == 0).sum())} "
        f"live reads")
    return g


def asg_arc_del_trans(g: StringGraph, fuzz: int) -> int:
    """Myers transitive reduction (~Overlaps.cpp:5357).

    Uses the native C++ kernel when available (hifiasm_tpu.native);
    the python loop below is the reference implementation/fallback."""
    from hifiasm_tpu_torch.native import trans_reduce

    alen_native = g.arc_len()
    n_native = trans_reduce(g.idx_s, g.idx_n, g.v, alen_native,
                            g.seq_del, g.del_, fuzz)
    if n_native is not None:
        if n_native:
            g.symm_del()
            g.cleanup()
        log("asg_arc_del_trans",
            f"transitively reduced {n_native} arcs (native)")
        return n_native

    mark = np.zeros(2 * g.n_seq, np.uint8)
    alen = g.arc_len()
    n_reduced = 0
    # NOTE: like the reference, already-reduced arcs keep providing
    # reachability inside this pass (the inner loop has no del check),
    # so raw arc ranges are used throughout, not arcs_of().
    for vtx in range(2 * g.n_seq):
        s, n = int(g.idx_s[vtx]), int(g.idx_n[vtx])
        ai = np.arange(s, s + n)
        if n == 0:
            continue
        if g.seq_del[vtx >> 1]:
            g.del_[ai] = 1
            n_reduced += n
            continue
        targets = g.v[ai]
        mark[targets] = 1
        L = int(alen[ai[-1]]) + fuzz
        for k, w in enumerate(targets):
            if mark[w] != 1:
                continue
            ws, wn = int(g.idx_s[w]), int(g.idx_n[w])
            aw = np.arange(ws, ws + wn)
            ok = alen[aw] + int(alen[ai[k]]) <= L
            hit = aw[ok]
            hv = g.v[hit]
            mark[hv[mark[hv] != 0]] = 2
        red = mark[targets] == 2
        g.del_[ai[red]] = 1
        n_reduced += int(red.sum())
        mark[targets] = 0
    if n_reduced:
        g.symm_del()
        g.cleanup()
    log("asg_arc_del_trans", f"transitively reduced {n_reduced} arcs")
    return n_reduced


def gen_init_sg(paf: PafStore, lens: np.ndarray, min_dp: int,
                min_ovlp: int, max_hang: int, int_frac: float,
                gap_fuzz: int, chem_cov: int = 0, chem_flank: int = 0
                ) -> Tuple[StringGraph, CoverageCut, np.ndarray]:
    """The gen_init_sg chain (Overlaps.cpp:39228) for the HiFi-only path."""
    cov = ma_hit_sub(min_dp, paf, lens, min_ovlp)
    detect_chimeric_reads(paf, lens, cov, chem_cov, chem_flank)
    # flatten ONCE for the whole cut/flt/contained/sg_gen chain; the
    # stages update the shared flat columns in place and the records
    # are re-sliced from them at the end (one scatter)
    qn, cols = paf.flatten()
    off = _paf_offsets(paf)
    flat = (qn, cols, off)
    ma_hit_cut(paf, lens, cov, min_ovlp, flat=flat)
    ma_hit_flt(paf, cov, max_hang, int_frac, min_ovlp, flat=flat)
    r_to_u = ma_hit_contained(paf, cov, max_hang, int_frac, min_ovlp,
                              flat=flat)
    g = ma_sg_gen(paf, cov, max_hang, int_frac, min_ovlp, flat=flat)
    for i in range(len(paf)):
        rec = paf[i]
        if len(rec) == 0:
            continue
        sl = slice(int(off[i]), int(off[i + 1]))
        rec.qs, rec.qe = cols["qs"][sl], cols["qe"][sl]
        rec.ts, rec.te = cols["ts"][sl], cols["te"][sl]
        rec.del_ = cols["del_"][sl]
    asg_arc_del_trans(g, gap_fuzz)
    return g, cov, r_to_u
