"""k-mer count histogram and coverage-peak analysis.

The peak analysis is a faithful port of ``ha_analyze_count`` /
``adj_m_peak_hom`` (hist.cpp:46-157) — these choose hom/het coverage and so
set every downstream threshold (filter-table cutoff, EC vote thresholds,
purge levels). Counting itself is sort/segment-reduce based (TPU-friendly)
rather than the reference's 4096-way bucketed hash (htab.cpp:118-294).
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np

YAK_COUNTER_BITS = 12
YAK_N_COUNTS = 1 << YAK_COUNTER_BITS
YAK_MAX_COUNT = YAK_N_COUNTS - 1


def histogram_counts(counts: np.ndarray) -> np.ndarray:
    """Per-k-mer occurrence counts -> histogram[0..YAK_MAX_COUNT]."""
    capped = np.minimum(counts, YAK_MAX_COUNT)
    return np.bincount(capped, minlength=YAK_N_COUNTS).astype(np.int64)


def _hist_line(c, x, exceed, cnt):
    label = f"{c:5d}" if c >= 0 else " rest"
    bar = "*" * x + (">" if exceed else "")
    sys.stderr.write(f"[M::ha_hist_line] {label}: {bar} {cnt}\n")


def adj_m_peak_hom(m_peak_hom: int, max_i: int, max2_i: int, max3_i: int
                   ) -> Tuple[int, int]:
    """Port of adj_m_peak_hom (hist.cpp:46). Returns (peak_hom, peak_het)."""
    peak_het = -1
    mm = [max2_i, max_i, max3_i]
    min_i, min_d = -1, -1
    for i in range(3):
        if mm[i] <= 0:
            continue
        d = abs(mm[i] - m_peak_hom)
        if min_d == -1 or min_d > d or (min_d == d and i == 1):
            min_d, min_i = d, i
    if min_i < 0:
        return m_peak_hom, peak_het
    if mm[min_i] < m_peak_hom:
        d = m_peak_hom - mm[min_i]
        if d >= mm[min_i] * 0.51:
            return m_peak_hom, mm[min_i]
    for i in range(min_i - 1, -1, -1):
        if mm[i] <= 0:
            continue
        peak_het = mm[i]
        break
    return mm[min_i], peak_het


def analyze_count(cnt: np.ndarray, start_cnt: int = 5,
                  m_peak_hom: int = -1, verbose: bool = True
                  ) -> Tuple[int, int]:
    """Port of ha_analyze_count (hist.cpp:74). Returns (peak_hom, peak_het).

    peak_hom == -1 signals low coverage (no peak found).
    """
    hist_max = 100
    n_cnt = len(cnt)
    assert n_cnt > start_cnt
    peak_het = -1
    start = 1 if cnt[1] > 0 else 2

    low_i = max(start, start_cnt)
    i = low_i + 1
    while i < n_cnt:
        if cnt[i] > cnt[i - 1]:
            break
        i += 1
    low_i = i - 1
    if verbose:
        sys.stderr.write(f"[M::analyze_count] lowest: count[{low_i}] = {cnt[low_i]}\n")
    if low_i == n_cnt - 1:
        return -1, peak_het  # low coverage

    max_i = low_i + 1
    mx = cnt[max_i]
    for i in range(low_i + 1, n_cnt):
        if cnt[i] > mx:
            mx, max_i = cnt[i], i
    if verbose:
        sys.stderr.write(f"[M::analyze_count] highest: count[{max_i}] = {cnt[max_i]}\n")
        for i in range(start, n_cnt):
            x = int(hist_max * cnt[i] / cnt[max_i] + 0.499)
            exceed = x > hist_max
            x = min(x, hist_max)
            if i > max_i and x == 0:
                break
            _hist_line(i, x, exceed, cnt[i])

    # smaller peak on the low end
    max2, max2_i = -1, -1
    for i in range(max_i - 1, low_i, -1):
        if cnt[i] >= cnt[i - 1] and cnt[i] >= cnt[i + 1]:
            if cnt[i] > max2:
                max2, max2_i = cnt[i], i
    if low_i < max2_i < max_i:
        mn = mx
        for i in range(max2_i + 1, max_i):
            mn = min(mn, cnt[i])
        if max2 < mx * 0.05 or mn > max2 * 0.95:
            max2, max2_i = -1, -1

    # smaller peak on the high end
    max3, max3_i = -1, -1
    for i in range(max_i + 1, n_cnt - 1):
        if cnt[i] >= cnt[i - 1] and cnt[i] >= cnt[i + 1]:
            if cnt[i] > max3:
                max3, max3_i = cnt[i], i
    if max3_i > max_i:
        mn = mx
        for i in range(max_i + 1, max3_i):
            mn = min(mn, cnt[i])
        if max3 < mx * 0.05 or mn > max3 * 0.95 or max3_i > max_i * 2.5:
            max3, max3_i = -1, -1

    if m_peak_hom > 0:
        return adj_m_peak_hom(m_peak_hom, max_i, max2_i, max3_i)
    if max3_i > 0:
        return max3_i, max_i
    if max2_i > 0:
        peak_het = max2_i
    return max_i, peak_het
