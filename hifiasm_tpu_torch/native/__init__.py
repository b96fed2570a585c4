"""Native C++ host kernels (ctypes), built on demand with graceful
fallback to the numpy/python implementations."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "hifiasm_native.cpp")
# built libraries go to the gitignored build/ beside the package
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                      "build", "native")
_SO = os.path.join(_BUILD, "_hifiasm_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
BUILD_LOG = ""          # why the last build failed (compiler output)


def _build() -> bool:
    global BUILD_LOG
    try:
        src_m = os.path.getmtime(_SRC)
        os.makedirs(_BUILD, exist_ok=True)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= src_m:
            return True
        # build to a private name, then rename: concurrent test workers
        # never load a half-written library
        tmp = f"{_SO}.{os.getpid()}.tmp"
        r = subprocess.run(
            ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-o", tmp, _SRC],
            capture_output=True, timeout=120)
        if r.returncode != 0 or not os.path.exists(tmp):
            BUILD_LOG = r.stderr.decode(errors="replace")
            return False
        os.replace(tmp, _SO)
        return True
    except Exception as ex:
        BUILD_LOG = repr(ex)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    # These kernels are short OpenMP regions called between numpy and
    # torch work on the same cores; libgomp's default active spin-wait
    # after each region would keep a core busy-waiting through that
    # work.  Must be set before libgomp initializes, i.e. before the
    # first dlopen of the kernels.
    os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
    lib = ctypes.CDLL(_SO)
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.ht_trans_reduce.restype = ctypes.c_int64
    lib.ht_trans_reduce.argtypes = [
        ctypes.c_int64, i64p, i64p, u32p, i64p, u8p, u8p, ctypes.c_int64]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.ht_chain_dp.restype = ctypes.c_int64
    lib.ht_chain_dp.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p]
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    u32cp = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.ht_sketch_many.restype = ctypes.c_int64
    lib.ht_sketch_many.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u64p, u16p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i64p, u64p, i64p, u8p, i64p, u32cp, i64p]
    lib.ht_collect_anchors.restype = ctypes.c_int64
    lib.ht_collect_anchors.argtypes = [
        ctypes.c_int64, i64p, u64p, i64p, u8p, i64p, i64p,
        u64p, i64p, i32p, ctypes.c_int64,
        u32p, u32p, u8p, u16p, i64p,
        ctypes.c_int64, ctypes.c_int64,
        i64p, u32p, u8p, i64p, i64p, i64p, i64p, i64p]
    lib.ht_count_kmers.restype = ctypes.c_int64
    lib.ht_count_kmers.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        u64p, u32cp]
    lib.ht_count_kmers_bloom.restype = ctypes.c_int64
    lib.ht_count_kmers_bloom.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int64, u64p,
        ctypes.c_int64, u64p]
    lib.ht_unique_u64.restype = ctypes.c_int64
    lib.ht_unique_u64.argtypes = [u64p, ctypes.c_int64, u32cp]
    lib.ht_set_threads.restype = None
    lib.ht_set_threads.argtypes = [ctypes.c_int32]
    lib.ht_finish_regions.restype = None
    lib.ht_finish_regions.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, u8p, i64p,
        ctypes.c_int64, i64p, i64p]
    lib.ht_chain_groups.restype = ctypes.c_int64
    lib.ht_chain_groups.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, i64p, i64p]
    lib.ht_hic_map.restype = None
    lib.ht_hic_map.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u64p, i32p, i64p, ctypes.c_int64, i64p, ctypes.c_double,
        i64p, i64p, i64p]
    lib.ht_dag_reads.restype = ctypes.c_void_p
    lib.ht_dag_reads.argtypes = [
        ctypes.c_int64, i64p, u8p, u8p, u8p, u8p, u8p, u8p, i64p, i64p,
        i64p, i64p, i64p, u8p, u8p, i64p, i64p, i64p, i64p, i64p,
        u8p, u8p, u8p, ctypes.c_int64, i64p, i64p, i64p, ctypes.c_double,
        ctypes.c_int32, i64p]
    lib.ht_dag_take.restype = None
    lib.ht_dag_take.argtypes = [ctypes.c_void_p, u8p, i64p, i64p]
    _lib = lib
    return _lib


def set_threads(n: int) -> None:
    """Bound the OpenMP worker count of every native kernel (-t)."""
    lib = get_lib()
    if lib is not None and n > 0:
        lib.ht_set_threads(n)


def chain_dp_native(self_off, t_off, span, weight, xl: int, yl: int, p):
    """Native chain DP for one anchor group -> (f, pre, quick) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(self_off)
    f = np.zeros(n, np.int64)
    pre = np.zeros(n, np.int64)
    t = np.zeros(max(n, 1), np.int64)
    quick = lib.ht_chain_dp(
        n, np.ascontiguousarray(self_off, np.int64),
        np.ascontiguousarray(t_off, np.int64),
        np.ascontiguousarray(span, np.int64),
        np.ascontiguousarray(weight, np.int64),
        xl, yl, p.max_iter, p.max_skip, p.max_dis,
        1 if p.quick_check else 0,
        p.bw_q16, p.pg_q16, p.pskip_q16, p.invbw_q4,
        f, pre, t)
    return f, pre, bool(quick)


def chain_groups_native(off, self_off, t_off, span, weight, xl_g, yl_g, p):
    """All-groups chain DP + traceback + mcopy in one native call.

    Returns (chain_cnt [G], score [G, m], start [G, m], hits [G, m],
    hit_idx flat) or None. hit_idx holds group-local anchor indices.
    """
    lib = get_lib()
    if lib is None:
        return None
    G = len(off) - 1
    m = p.mcopy_num
    total = int(off[-1])
    cnt = np.zeros(G, np.int64)
    score = np.zeros(G * m, np.int64)
    start = np.zeros(G * m, np.int64)
    hits = np.zeros(G * m, np.int64)
    hit_idx = np.zeros(max(total, 1), np.int64)
    lib.ht_chain_groups(
        G, np.ascontiguousarray(off, np.int64),
        np.ascontiguousarray(self_off, np.int64),
        np.ascontiguousarray(t_off, np.int64),
        np.ascontiguousarray(span, np.int64),
        np.ascontiguousarray(weight, np.int64),
        np.ascontiguousarray(xl_g, np.int64),
        np.ascontiguousarray(yl_g, np.int64),
        p.max_iter, p.max_skip, p.max_dis, 1 if p.quick_check else 0,
        p.bw_q16, p.pg_q16, p.pskip_q16, p.invbw_q4,
        m, p.mcopy_q16, p.mcopy_khit_cut,
        cnt, score, start, hits, hit_idx)
    return (cnt, score.reshape(G, m), start.reshape(G, m),
            hits.reshape(G, m), hit_idx)


def sketch_many_native(codes_list, k: int, w: int, ft=None,
                       sample_dist: int = 500, is_unique: bool = False):
    """Native whole-batch HPC minimizer sketch; returns list[Minimizers]
    or None (unavailable / overflow)."""
    lib = get_lib()
    if lib is None:
        return None
    from hifiasm_tpu_torch.ops.sketch import Minimizers

    n = len(codes_list)
    bounds = np.zeros(n + 1, np.int64)
    for i, c in enumerate(codes_list):
        bounds[i + 1] = bounds[i] + len(c)
    flat = np.concatenate(codes_list) if n else np.zeros(0, np.uint8)
    caps = np.array([max(64, min(len(c) + 2, 6 * len(c) // max(w, 1) + 64))
                     for c in codes_list], np.int64)
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(caps, out=out_off[1:])
    tot = int(out_off[-1])
    oh = np.empty(tot, np.uint64)
    op = np.empty(tot, np.int64)
    orv = np.empty(tot, np.uint8)
    osp = np.empty(tot, np.int64)
    oc = np.empty(tot, np.uint32)
    on = np.zeros(n, np.int64)
    if ft is not None and len(ft):
        fh = np.ascontiguousarray(ft.hashes, np.uint64)
        fc = np.ascontiguousarray(ft.counts, np.uint16)
        nft = len(fh)
    else:
        fh = np.zeros(1, np.uint64)
        fc = np.zeros(1, np.uint16)
        nft = 0
    rc = lib.ht_sketch_many(
        np.ascontiguousarray(flat, np.uint8), bounds, n, k, w,
        fh, fc, nft, sample_dist, 1 if is_unique else 0,
        out_off, oh, op, orv, osp, oc, on)
    if rc != 0:
        return None
    out = []
    for i in range(n):
        s = int(out_off[i])
        e = s + int(on[i])
        # views into the batch buffers (alive for the round; avoids
        # 5 small copies per read)
        out.append(Minimizers(oh[s:e], op[s:e], orv[s:e], osp[s:e],
                              oc[s:e]))
    return out


def count_kmers_native(codes_list, k: int, chunk_bases: int = 32_000_000):
    """Fused HPC k-mer count: hash + parallel sort + unique in native code.

    Returns (sorted unique uint64 hashes, uint32 counts) over all complete
    canonical HPC k-mers, or None if the library is unavailable. Same
    k-mer set as ops/sketch.all_kmers_read (~ha_ft_gen, htab.cpp:1136).

    Processes the reads in ~chunk_bases slices with one reused scratch
    buffer (first-touch page faults on an input-sized buffer dominate the
    small-genome case otherwise) and merges per-chunk sorted tables
    LSM-style, so peak memory tracks the distinct-k-mer table, not total
    occurrences.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(codes_list)
    hbuf = cbuf = None
    stack = []                          # [(h, c)] pairwise-merge stack

    def _push(h, c):
        stack.append((h, c))
        while len(stack) >= 2 and \
                len(stack[-1][0]) * 2 >= len(stack[-2][0]):
            hb, cb = stack.pop()
            ha, ca = stack.pop()
            stack.append(_merge_sorted_counts(ha, ca, hb, cb))

    c0 = 0
    while c0 < n:
        c1, bases = c0, 0
        while c1 < n and bases < chunk_bases:
            bases += len(codes_list[c1])
            c1 += 1
        chunk = codes_list[c0:c1]
        bounds = np.zeros(len(chunk) + 1, np.int64)
        for i, c in enumerate(chunk):
            bounds[i + 1] = bounds[i] + len(c)
        flat = np.concatenate(chunk) if chunk else np.zeros(0, np.uint8)
        tot = max(int(bounds[-1]), 1)
        if hbuf is None or len(hbuf) < tot:
            hbuf = np.empty(tot, np.uint64)
            cbuf = np.empty(tot, np.uint32)
        ne = lib.ht_count_kmers(
            np.ascontiguousarray(flat, np.uint8), bounds, len(chunk), k,
            0, hbuf, cbuf)
        em = hbuf[:ne]
        em.sort()                       # numpy SIMD (avx) sort
        nu = lib.ht_unique_u64(em, ne, cbuf)
        _push(em[:nu].copy(), cbuf[:nu].copy())
        c0 = c1
    if len(stack) == 1:                 # single chunk: no merge, no copy
        h, c32 = stack[0]
        return h, c32.astype(np.uint32, copy=False)
    h = np.zeros(0, np.uint64)
    c = np.zeros(0, np.int64)
    while stack:
        hb, cb = stack.pop()
        h, c = _merge_sorted_counts(h, c, hb, cb)
    return h, np.minimum(c, 0xFFFFFFFF).astype(np.uint32)


def _merge_sorted_counts(ha, ca, hb, cb):
    """Merge two sorted (hash, count) tables, summing shared keys."""
    if len(ha) == 0:
        return hb, cb.astype(np.int64)
    if len(hb) == 0:
        return ha, ca.astype(np.int64)
    h = np.concatenate([ha, hb])
    c = np.concatenate([ca.astype(np.int64), cb.astype(np.int64)])
    order = np.argsort(h, kind="stable")
    h, c = h[order], c[order]
    new = np.empty(len(h), bool)
    new[0] = True
    np.not_equal(h[1:], h[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    csum = np.add.reduceat(c, starts)
    return h[starts], csum


def count_kmers_bloom_native(codes_list, k: int, bf_bits: int,
                             chunk_bases: int = 32_000_000):
    """Bloom-prefiltered HPC k-mer counting (~ha_ft_gen's -f pass,
    htab.cpp:74-116 + 1136): singleton k-mers never enter the
    sort/count stage, so peak memory tracks distinct NON-singleton
    k-mers instead of total occurrences. Per-chunk (hash, count)
    tables are merged pairwise (LSM-style) to keep intermediates
    ~2x the final table. Returned counts are occurrences + 1
    (the first, bloom-swallowed occurrence restored), saturating at
    uint32. Returns (sorted unique hashes, uint32 counts) or None.
    """
    lib = get_lib()
    if lib is None:
        return None
    bf_bits = max(bf_bits, 12)
    bloom = np.zeros(1 << max(bf_bits - 6, 9), np.uint64)
    stack = []                          # [(h, c)] pairwise-merge stack

    def _push(h, c):
        stack.append((h, c))
        while len(stack) >= 2 and \
                len(stack[-1][0]) * 2 >= len(stack[-2][0]):
            hb, cb = stack.pop()
            ha, ca = stack.pop()
            stack.append(_merge_sorted_counts(ha, ca, hb, cb))

    c0, n = 0, len(codes_list)
    while c0 < n:
        c1, bases = c0, 0
        while c1 < n and bases < chunk_bases:
            bases += len(codes_list[c1])
            c1 += 1
        chunk = codes_list[c0:c1]
        bounds = np.zeros(len(chunk) + 1, np.int64)
        for i, s in enumerate(chunk):
            bounds[i + 1] = bounds[i] + len(s)
        flat = np.concatenate(chunk) if chunk else np.zeros(0, np.uint8)
        hbuf = np.empty(max(int(bounds[-1]), 1), np.uint64)
        ne = lib.ht_count_kmers_bloom(
            np.ascontiguousarray(flat, np.uint8), bounds, len(chunk), k,
            bloom, max(bf_bits - 6, 9), hbuf)
        em = hbuf[:ne]                   # partition-ordered, not sorted
        em.sort()                        # numpy SIMD sort
        cb = np.empty(max(ne, 1), np.uint32)
        nu = lib.ht_unique_u64(em, ne, cb)
        _push(em[:nu].copy(), cb[:nu].copy())
        c0 = c1
    h = np.zeros(0, np.uint64)
    c = np.zeros(0, np.int64)
    while stack:
        hb, cb = stack.pop()
        h, c = _merge_sorted_counts(h, c, hb, cb)
    c = np.minimum(c + 1, 0xFFFFFFFF).astype(np.uint32)
    return h, c


def collect_anchors_native(mzs, pt, rids, tlens, hom_cov: int):
    """Native anchor collection for many reads -> list[Anchors] or None."""
    lib = get_lib()
    if lib is None or pt.n_distinct == 0:
        return None
    from hifiasm_tpu_torch.overlap.anchors import HA_KMER_GOOD_RATIO, Anchors

    max_cnt = max(int(hom_cov * (2.0 - HA_KMER_GOOD_RATIO)), 2)
    min_cnt = max(int(hom_cov * HA_KMER_GOOD_RATIO), 2)
    n = len(rids)
    mz_off = np.zeros(n + 1, np.int64)
    for i, rid in enumerate(rids):
        mz_off[i + 1] = mz_off[i] + len(mzs[rid])
    mh = np.concatenate([mzs[r].hash for r in rids]) if n else \
        np.zeros(0, np.uint64)
    mp = np.concatenate([mzs[r].pos.astype(np.int64) for r in rids]) \
        if n else np.zeros(0, np.int64)
    mr = np.concatenate([mzs[r].rev for r in rids]) if n else \
        np.zeros(0, np.uint8)
    ms = np.concatenate([mzs[r].span.astype(np.int64) for r in rids]) \
        if n else np.zeros(0, np.int64)
    # per-read capacity = sum of posting counts of its minimizers
    cnts = pt.cnt(mh).astype(np.int64)
    cs = np.zeros(len(cnts) + 1, np.int64)
    np.cumsum(cnts, out=cs[1:])
    caps = cs[mz_off[1:]] - cs[mz_off[:-1]]
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(caps, out=out_off[1:])
    tot = int(out_off[-1])
    o_tid = np.empty(max(tot, 1), np.uint32)
    o_rev = np.empty(max(tot, 1), np.uint8)
    o_qp = np.empty(max(tot, 1), np.int64)
    o_to = np.empty(max(tot, 1), np.int64)
    o_sp = np.empty(max(tot, 1), np.int64)
    o_w = np.empty(max(tot, 1), np.int64)
    o_n = np.zeros(n, np.int64)
    rc = lib.ht_collect_anchors(
        n, mz_off, np.ascontiguousarray(mh, np.uint64),
        np.ascontiguousarray(mp), np.ascontiguousarray(mr),
        np.ascontiguousarray(ms),
        np.ascontiguousarray(np.asarray(rids, np.int64)),
        np.ascontiguousarray(pt.hashes, np.uint64),
        np.ascontiguousarray(pt.start, np.int64),
        np.ascontiguousarray(pt.count, np.int32), pt.n_distinct,
        np.ascontiguousarray(pt.rid, np.uint32),
        np.ascontiguousarray(pt.pos, np.uint32),
        np.ascontiguousarray(pt.rev, np.uint8),
        np.ascontiguousarray(pt.span, np.uint16),
        np.ascontiguousarray(tlens, np.int64),
        min_cnt, max_cnt, out_off,
        o_tid, o_rev, o_qp, o_to, o_sp, o_w, o_n)
    if rc != 0:
        return None
    out = []
    for i in range(n):
        s = int(out_off[i])
        e = s + int(o_n[i])
        out.append(Anchors(o_tid[s:e], o_rev[s:e], o_qp[s:e],
                           o_to[s:e], o_sp[s:e], o_w[s:e]))
    return out


def finish_regions_native(r_ov_off, score, x_s, x_e, y_id, rev, rlen_of,
                          max_n_chain: int):
    """Batched quota+dedup+order over flat overlap columns; returns
    (kept global indices in final order, new r_ov_off) or None."""
    lib = get_lib()
    if lib is None:
        return None
    R = len(r_ov_off) - 1
    n_ov = int(r_ov_off[-1])
    out_idx = np.zeros(max(n_ov, 1), np.int64)
    out_cnt = np.zeros(max(R, 1), np.int64)
    lib.ht_finish_regions(
        R, np.ascontiguousarray(r_ov_off, np.int64),
        np.ascontiguousarray(score, np.int64),
        np.ascontiguousarray(x_s, np.int64),
        np.ascontiguousarray(x_e, np.int64),
        np.ascontiguousarray(y_id, np.int64),
        np.ascontiguousarray(rev, np.uint8),
        np.ascontiguousarray(rlen_of, np.int64),
        max_n_chain, out_idx, out_cnt)
    new_off = np.zeros(R + 1, np.int64)
    np.cumsum(out_cnt[:R], out=new_off[1:])
    # compact the per-read slices (kept indices live at each read's o0)
    seg = np.arange(int(new_off[-1])) - np.repeat(new_off[:-1],
                                                  out_cnt[:R])
    src = np.repeat(np.asarray(r_ov_off[:-1], np.int64),
                    out_cnt[:R]) + seg
    return out_idx[src], new_off


def trans_reduce(idx_s, idx_n, av, alen, seq_del, del_, fuzz: int
                 ) -> Optional[int]:
    """Native transitive reduction; returns n_reduced or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    n_vtx = len(idx_s)
    return int(lib.ht_trans_reduce(
        n_vtx, np.ascontiguousarray(idx_s, np.int64),
        np.ascontiguousarray(idx_n, np.int64),
        np.ascontiguousarray(av, np.uint32),
        np.ascontiguousarray(alen, np.int64),
        np.ascontiguousarray(seq_del, np.uint8), del_, fuzz))


def hic_map_native(mat, k: int, hashes, uids, poss, pref16,
                   min_frac: float = 0.7):
    """Native Hi-C vote mapping (~hic_short_align, hic.cpp:17016);
    mirrors phasing/hic.py::_vote_place_batch bit-for-bit.  Returns
    (uid[N], pos[N], cands[N,2,3]) or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, np.uint8)
    N, L = mat.shape
    uid_out = np.empty(N, np.int64)
    pos_out = np.empty(N, np.int64)
    cands = np.empty((N, 2, 3), np.int64)
    lib.ht_hic_map(mat, N, L, k,
                   np.ascontiguousarray(hashes, np.uint64),
                   np.ascontiguousarray(uids, np.int32),
                   np.ascontiguousarray(poss, np.int64),
                   len(hashes), np.ascontiguousarray(pref16, np.int64),
                   float(min_frac), uid_out, pos_out,
                   cands.reshape(-1))
    return uid_out, pos_out, cands


def _flat(arrays, dtype) -> np.ndarray:
    """The arrays end to end, as one contiguous ``dtype`` array."""
    if not arrays:
        return np.zeros(0, dtype)
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(a).reshape(-1).astype(dtype, copy=False)
         for a in arrays]))


def _offsets(lens) -> np.ndarray:
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(np.asarray(lens, np.int64), out=off[1:])
    return off


def dag_reads_native(reads, threads: int):
    """The host DAG pass of a round's reads in one native call
    (``ht_dag_reads``) over ``threads`` OpenMP threads: ``reads`` is a
    list of (codes, ReadECOut, consensus inputs), as
    ``ec/pipeline._host_dag`` takes them, and the result is its list of
    (ConsensusResult, clusters, whether the read had its columns), bit
    for bit.  None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from hifiasm_tpu_torch.ec import consensus as C

    n = len(reads)
    qs = [q for q, _, _ in reads]
    ecos = [eco for _, eco, _ in reads]
    cns = [c for _, _, c in reads]
    q_off = _offsets([len(q) for q in qs])
    # the gathered columns: each distinct buffer once, segments rebased
    bufs, buf_base, n_col = [], {}, 0
    seg, seams = [], []
    for eco in ecos:
        d = eco.dag
        if d is None:
            seg.append(np.zeros((4, 0), np.int64))
            seams.append(np.zeros((0, 4), np.int64))
            continue
        key = tuple(a.__array_interface__["data"][0]
                    for a in (d.tb, d.ins_cnt, d.ins_base)) + (len(d.tb),)
        if key not in buf_base:
            buf_base[key] = n_col
            bufs.append((d.tb, d.ins_cnt, d.ins_base))
            n_col += len(d.tb)
        seg.append(np.stack([np.asarray(d.o, np.int64),
                             np.asarray(d.col, np.int64),
                             np.asarray(d.n, np.int64),
                             np.asarray(d.src, np.int64) + buf_base[key]]))
        seams.append(np.asarray(d.seams, np.int64).reshape(-1, 4))
    seg_off = _offsets([s.shape[1] for s in seg])
    segs = np.concatenate(seg, axis=1) if n else np.zeros((4, 0), np.int64)
    cols = [_flat([b[k] for b in bufs], np.uint8) for k in range(3)]
    ovs = [eco.ov for eco in ecos]
    params = np.array([C.DAG_CLUSTER_GAP, C.MAX_INS_TRACK,
                       C.MSA_MAX_BACKBONE, C.MSA_MAX_VOTER, C.OCC_TOT],
                      np.int64)
    res = np.zeros((n, 5), np.int64)
    h = lib.ht_dag_reads(
        n, q_off, _flat(qs, np.uint8),
        *(_flat([c[k] for c in cns], np.uint8) for k in range(5)),
        _offsets([len(e.het_sites) for e in ecos]),
        _flat([e.het_sites for e in ecos], np.int64),
        _offsets([len(ov) for ov in ovs]),
        _flat([ov.x_s for ov in ovs], np.int64),
        _flat([np.asarray(ov.x_e, np.int64) - ov.x_s + 1 for ov in ovs],
              np.int64),
        _flat([e.is_match == 1 for e in ecos], np.uint8),
        np.array([e.dag is not None for e in ecos], np.uint8),
        seg_off, *(np.ascontiguousarray(segs[k]) for k in range(4)),
        *cols, n_col, _offsets([len(s) for s in seams]),
        _flat(seams, np.int64), params, C.OCC_EXACT, int(threads), res)
    if not h:
        raise RuntimeError("ht_dag_reads: a gathered segment or seam lies "
                           "outside its overlap")
    seq = np.empty(int(res[:, 0].sum()), np.uint8)
    ed_pos = np.empty(int(res[:, 2].sum()), np.int64)
    ed_delta = np.empty_like(ed_pos)
    lib.ht_dag_take(h, seq, ed_pos, ed_delta)
    s_off = _offsets(res[:, 0])
    e_off = _offsets(res[:, 2])
    return [(C.ConsensusResult(
                seq[s_off[i]:s_off[i + 1]].copy(), int(res[i, 1]),
                (ed_pos[e_off[i]:e_off[i + 1]].copy(),
                 ed_delta[e_off[i]:e_off[i + 1]].copy())),
             int(res[i, 3]), bool(res[i, 4])) for i in range(n)]
