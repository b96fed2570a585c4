"""Filter table and minimizer position index.

TPU-first re-design of the reference's bucketed hash tables:

- ``FilterTable`` (~ha_ft_gen, htab.cpp:1136): high-occurrence k-mer mask.
  Here: a sorted uint64 hash array + uint16 counts, queried by vectorized
  binary search, instead of a 4096-bucket khashl.
- ``PositionTable`` (~ha_pt_gen, htab.cpp:1232): minimizer hash -> postings
  (rid, pos, rev, span). Here: sort/segment-reduce build; sorted unique
  hashes + CSR offsets + columnar postings. Query = searchsorted (host) or
  the device binary-search gather in ops/index_query.py. The reference's
  low-12-bit bucketing survives as the multi-chip shard key (parallel/).

Both are built in ONE sketch pass over the reads (the reference needs two
full passes because its hash table must be pre-sized, htab.cpp:1249-1275;
the sort-based build doesn't).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from hifiasm_tpu_torch.index.count import (
    YAK_MAX_COUNT, analyze_count, histogram_counts,
)
from hifiasm_tpu_torch.ops.sketch import Minimizers, all_kmers_read, sketch_read
from hifiasm_tpu_torch.utils.logging import log


@dataclass
class FilterTable:
    hashes: np.ndarray        # sorted uint64
    counts: np.ndarray        # uint16 (capped at max_kmer_cnt)
    cutoff: int

    def lookup(self, h: np.ndarray) -> np.ndarray:
        """Counts for hashes (0 when absent) ~ ha_ft_cnt."""
        if len(self.hashes) == 0:
            return np.zeros(len(h), dtype=np.uint32)
        idx = np.searchsorted(self.hashes, h)
        idx = np.minimum(idx, len(self.hashes) - 1)
        hit = self.hashes[idx] == h
        return np.where(hit, self.counts[idx].astype(np.uint32), 0)

    def __len__(self):
        return len(self.hashes)


def build_filter_table(read_codes: Iterable[np.ndarray], k: int,
                       high_factor: float = 5.0, max_kmer_cnt: int = 2000,
                       min_hist_cnt: int = 5, bf_shift: int = 0,
                       ) -> Tuple[FilterTable, int, int]:
    """Count ALL HPC k-mers, find coverage peaks, keep high-occ k-mers.

    ``bf_shift > 0`` (the -f option) enables the blocked-bloom singleton
    prefilter (~yak_bf_insert pass 0, htab.cpp:74-116): error k-mers
    seen once never enter the count table, bounding memory at large
    genome scale. The bloom is clamped down to ~4 bits/k-mer when the
    input is small (same false-positive budget, no 16 GB allocation for
    a bacterial run). Returns (table, peak_hom, peak_het).
    ~ha_ft_gen (htab.cpp:1136-1169).
    """
    codes_list = list(read_codes)
    if bf_shift > 0 and codes_list:
        try:
            from hifiasm_tpu_torch.native import count_kmers_bloom_native
            total = sum(len(c) for c in codes_list)
            bf = min(bf_shift,
                     max(22, int(np.ceil(np.log2(max(total, 1) * 4)))))
            uc = count_kmers_bloom_native(codes_list, k, bf)
        except Exception:
            uc = None
        if uc is not None:
            log("build_filter_table",
                f"bloom prefilter ({bf} bits): "
                f"{len(uc[0])} distinct non-singleton k-mers")
            return _finish_filter_table(uc[0], uc[1], high_factor,
                                        max_kmer_cnt, min_hist_cnt)
    uc = None
    if codes_list:
        try:
            # fused native path: hash + parallel sort + unique in one call
            from hifiasm_tpu_torch.native import count_kmers_native
            uc = count_kmers_native(codes_list, k)
        except Exception:
            uc = None
    if uc is not None:
        uniq, counts = uc
        return _finish_filter_table(uniq, counts, high_factor,
                                    max_kmer_cnt, min_hist_cnt)
    allh = None
    if codes_list:
        try:
            # w=1 native sketch emits exactly the complete canonical
            # k-mers; chunk reads to bound the output buffers
            from hifiasm_tpu_torch.native import sketch_many_native
            chunks = []
            c0 = 0
            ok = True
            while c0 < len(codes_list) and ok:
                c1, bases = c0, 0
                while c1 < len(codes_list) and bases < 2_000_000:
                    bases += len(codes_list[c1])
                    c1 += 1
                mz = sketch_many_native(codes_list[c0:c1], k, 1, None)
                if mz is None:
                    ok = False
                    break
                chunks.extend(m.hash for m in mz)
                c0 = c1
            if ok:
                allh = np.concatenate(chunks) if chunks else \
                    np.zeros(0, np.uint64)
        except Exception:
            allh = None
    if allh is None and codes_list:
        # chunked concatenation passes (read boundaries = N-stretch resets,
        # so no k-mer spans reads; chunks keep temporaries cache-resident)
        sep = np.array([4], np.uint8)
        chunks = []
        c0 = 0
        while c0 < len(codes_list):
            parts, bases = [], 0
            while c0 < len(codes_list) and bases < 120_000:
                parts.append(codes_list[c0])
                parts.append(sep)
                bases += len(codes_list[c0])
                c0 += 1
            chunks.append(all_kmers_read(np.concatenate(parts[:-1]), k))
        allh = np.concatenate(chunks)
    elif allh is None:
        allh = np.zeros(0, dtype=np.uint64)
    uniq, counts = np.unique(allh, return_counts=True)
    return _finish_filter_table(uniq, counts, high_factor, max_kmer_cnt,
                                min_hist_cnt)


def _finish_filter_table(uniq, counts, high_factor, max_kmer_cnt,
                         min_hist_cnt):
    hist = histogram_counts(counts)
    peak_hom, peak_het = analyze_count(hist, start_cnt=min_hist_cnt)
    if peak_hom > 0:
        log("build_filter_table", f"peak_hom: {peak_hom}; peak_het: {peak_het}")
    cutoff = YAK_MAX_COUNT - 1
    if peak_hom > 0:
        cutoff = min(int(peak_hom * high_factor), YAK_MAX_COUNT - 1)
    keep = counts >= cutoff
    ft = FilterTable(
        hashes=uniq[keep],
        counts=np.minimum(counts[keep], max_kmer_cnt).astype(np.uint16),
        cutoff=cutoff,
    )
    log("build_filter_table",
        f"filtered out {len(ft)} k-mers occurring {cutoff} or more times")
    return ft, peak_hom, peak_het


@dataclass
class PositionTable:
    """Minimizer index: sorted unique hashes + CSR postings."""

    hashes: np.ndarray        # [H] sorted uint64
    start: np.ndarray         # [H] int64 into postings
    count: np.ndarray         # [H] int32
    rid: np.ndarray           # [P] uint32
    pos: np.ndarray           # [P] uint32 (k-mer end position on the read)
    rev: np.ndarray           # [P] uint8
    span: np.ndarray          # [P] uint16

    @property
    def n_distinct(self) -> int:
        return len(self.hashes)

    @property
    def tot_pos(self) -> int:
        return len(self.rid)

    def get(self, h: int):
        """Postings for one hash ~ha_pt_get (htab.cpp:518)."""
        i = np.searchsorted(self.hashes, np.uint64(h))
        if i >= len(self.hashes) or self.hashes[i] != np.uint64(h):
            return None
        s, c = self.start[i], self.count[i]
        sl = slice(s, s + c)
        return self.rid[sl], self.pos[sl], self.rev[sl], self.span[sl]

    def cnt(self, h: np.ndarray) -> np.ndarray:
        """Vectorized occurrence count per query hash ~ha_pt_cnt."""
        if len(self.hashes) == 0:
            return np.zeros(len(h), dtype=np.int32)
        idx = np.searchsorted(self.hashes, h)
        idx = np.minimum(idx, len(self.hashes) - 1)
        hit = self.hashes[idx] == h
        return np.where(hit, self.count[idx], 0).astype(np.int32)

    def lookup_many(self, h: np.ndarray):
        """(slot_index, found) per query hash; slots index start/count."""
        idx = np.searchsorted(self.hashes, h)
        idxc = np.minimum(idx, max(len(self.hashes) - 1, 0))
        found = (self.hashes[idxc] == h) if len(self.hashes) else \
            np.zeros(len(h), dtype=bool)
        return idxc, found


def build_position_table(
    read_codes: Iterable[np.ndarray],
    k: int,
    w: int,
    ft: Optional[FilterTable] = None,
    min_hist_cnt: int = 5,
    keep_min: int = 2,
    keep_max: int = YAK_MAX_COUNT - 1,
    sketcher: Optional[Callable] = None,
) -> Tuple[PositionTable, int, int, list]:
    """Sketch every read, histogram minimizer counts, build the CSR index.

    Returns (table, peak_hom, peak_het, per_read_minimizers).
    ~ha_pt_gen (htab.cpp:1232-1287): keeps hashes whose count is within
    [keep_min, keep_max] (drops singletons and overflowing repeats).
    """
    ft_lookup = ft.lookup if ft is not None else None
    if sketcher is None:
        codes_list = list(read_codes)
        mz_per_read = None
        try:
            from hifiasm_tpu_torch.native import sketch_many_native
            mz_per_read = sketch_many_native(codes_list, k, w, ft)
        except Exception:
            mz_per_read = None
        if mz_per_read is None:
            # chunked whole-batch sketching: big enough to amortize numpy
            # call overhead, small enough that the ~dozen live temporaries
            # stay cache-resident
            from hifiasm_tpu_torch.ops.sketch import sketch_many
            mz_per_read = []
            c0 = 0
            while c0 < len(codes_list):
                c1, bases = c0, 0
                while c1 < len(codes_list) and bases < 120_000:
                    bases += len(codes_list[c1])
                    c1 += 1
                mz_per_read.extend(sketch_many(codes_list[c0:c1], k, w,
                                               ft_lookup))
                c0 = c1
    else:
        mz_per_read = [sketcher(codes) for codes in read_codes]
    h_chunks, rid_chunks, pos_chunks, rev_chunks, span_chunks = [], [], [], [], []
    for rid_i, mz in enumerate(mz_per_read):
        n = len(mz)
        h_chunks.append(mz.hash)
        rid_chunks.append(np.full(n, rid_i, dtype=np.uint32))
        pos_chunks.append(mz.pos.astype(np.uint32))
        rev_chunks.append(mz.rev)
        span_chunks.append(mz.span.astype(np.uint16))

    allh = np.concatenate(h_chunks) if h_chunks else np.zeros(0, np.uint64)
    rid = np.concatenate(rid_chunks) if rid_chunks else np.zeros(0, np.uint32)
    pos = np.concatenate(pos_chunks) if pos_chunks else np.zeros(0, np.uint32)
    rev = np.concatenate(rev_chunks) if rev_chunks else np.zeros(0, np.uint8)
    span = np.concatenate(span_chunks) if span_chunks else np.zeros(0, np.uint16)

    # sort postings by (hash, rid, pos) for deterministic CSR layout
    order = np.lexsort((pos, rid, allh))
    allh, rid, pos, rev, span = (allh[order], rid[order], pos[order],
                                 rev[order], span[order])
    uniq, first, counts = np.unique(allh, return_index=True, return_counts=True)

    hist = histogram_counts(counts)
    peak_hom, peak_het = analyze_count(hist, start_cnt=min_hist_cnt)
    if peak_hom > 0:
        log("build_position_table",
            f"peak_hom: {peak_hom}; peak_het: {peak_het}")

    keep = (counts >= keep_min) & (counts <= keep_max)
    # gather kept postings
    keep_post = np.zeros(len(allh) + 1, dtype=np.int8)
    np.add.at(keep_post, first[keep], 1)
    np.add.at(keep_post, first[keep] + counts[keep], -1)
    kp = np.cumsum(keep_post[:-1]) > 0
    new_counts = counts[keep].astype(np.int32)
    table = PositionTable(
        hashes=uniq[keep],
        start=np.concatenate([[0], np.cumsum(new_counts[:-1])]).astype(np.int64)
        if len(new_counts) else np.zeros(0, np.int64),
        count=new_counts,
        rid=rid[kp], pos=pos[kp], rev=rev[kp], span=span[kp],
    )
    log("build_position_table",
        f"indexed {table.tot_pos} positions, {table.n_distinct} distinct "
        f"minimizer k-mers")
    return table, peak_hom, peak_het, mz_per_read
