"""Banded affine-gap alignment (the ksw2 analog for UL refinement).

The port of hifiasm_tpu/ops/affine.py, a host copy: it is numpy in the
JAX package and reaches no kernel.  The reference links ksw2
(``ksw2_extz2_sse``) for its UL/ONT paths — affine-gap extension
alignment that tolerates the long indels Myers edit-distance windows
overpay for.  The DP is vectorized across the BAND (numpy lane ops per
query row), scores follow ksw2's defaults (match 2 / mismatch -4 / gap
open 4 / extend 2), and extension mode reports the best-scoring cell so
callers can trim alignment boundaries precisely (~inter.cpp's
ul_refine_alignment usage; ``ul.ul_refine_blocks`` here).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = -(1 << 30)


def affine_extend(x: np.ndarray, y: np.ndarray, bw: int = 32,
                  match: int = 2, mis: int = -4, gap_open: int = 4,
                  gap_ext: int = 2) -> Tuple[int, int, int]:
    """Banded affine-gap EXTENSION alignment of query ``x`` onto target
    ``y`` from their starts; returns (q_end, t_end, score) of the
    best-scoring cell (one-past-end lengths), (0, 0, 0) if extension
    never rises above the empty alignment.

    Band: |j - i| <= bw (target offset within bw of the diagonal).
    Vectorized over the band per query row: M/E/F lanes follow the
    standard 3-state affine recurrence (E = gap in query, F = gap in
    target).
    """
    n, m = len(x), len(y)
    if n == 0 or m == 0:
        return 0, 0, 0
    W = 2 * bw + 1
    ks = np.arange(W)
    # lane k of row i holds target column j = i + k - bw
    H = np.full(W, NEG, np.int64)      # best score ending at (i, j)
    F = np.full(W, NEG, np.int64)      # ends with gap in y (i advances)
    j0 = ks - bw
    H[bw] = 0
    lead = (j0 >= 1) & (j0 <= m)       # leading target gap
    H[lead] = -gap_open - gap_ext * j0[lead]
    best_sc, best_q, best_t = 0, 0, 0
    for i in range(1, n + 1):
        jrow = i + ks - bw
        sub = np.where(
            (jrow >= 1) & (jrow <= m),
            np.where(y[np.clip(jrow - 1, 0, m - 1)] == x[i - 1],
                     match, mis), NEG)
        # diagonal H[i-1][j-1] = same lane; up H[i-1][j] = lane k+1
        Mn = np.where(H > NEG // 2, H + sub, NEG)
        Hup = np.concatenate([H[1:], [NEG]])
        Fup = np.concatenate([F[1:], [NEG]])
        F = np.maximum(
            np.where(Hup > NEG // 2, Hup - gap_open - gap_ext, NEG),
            np.where(Fup > NEG // 2, Fup - gap_ext, NEG))
        Hp = np.maximum(Mn, F)         # row i before horizontal gaps
        # E[k] = max_{k'<k}(Hp[k'] - open - ext*(k - k'))
        #      = (exclusive prefix max of Hp + ext*k') - open - ext*k
        aug = np.where(Hp > NEG // 2, Hp + gap_ext * ks, NEG)
        pre = np.concatenate([[NEG], np.maximum.accumulate(aug)[:-1]])
        E = np.where(pre > NEG // 2, pre - gap_open - gap_ext * ks, NEG)
        H = np.maximum(Hp, E)
        inb = (jrow >= 0) & (jrow <= m)
        H = np.where(inb, H, NEG)
        F = np.where(inb, F, NEG)
        row_best = int(H.max())
        if row_best > best_sc:
            k = int(np.argmax(H))
            best_sc = row_best
            best_q = i
            best_t = int(jrow[k])
    return best_q, best_t, best_sc


def affine_extend_scalar(x, y, bw=32, match=2, mis=-4, gap_open=4,
                         gap_ext=2):
    """Readable full-DP oracle (no band) for cross-validation tests."""
    n, m = len(x), len(y)
    H = np.full((n + 1, m + 1), NEG, np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)
    F = np.full((n + 1, m + 1), NEG, np.int64)
    H[0, 0] = 0
    for j in range(1, m + 1):
        E[0, j] = -gap_open - gap_ext * j
        H[0, j] = E[0, j]
    for i in range(1, n + 1):
        F[i, 0] = -gap_open - gap_ext * i
        H[i, 0] = F[i, 0]
        for j in range(1, m + 1):
            if abs(j - i) > bw:
                continue
            sub = match if x[i - 1] == y[j - 1] else mis
            E[i, j] = max(H[i, j - 1] - gap_open - gap_ext,
                          E[i, j - 1] - gap_ext)
            F[i, j] = max(H[i - 1, j] - gap_open - gap_ext,
                          F[i - 1, j] - gap_ext)
            H[i, j] = max(H[i - 1, j - 1] + sub, E[i, j], F[i, j])
    best_sc, best_q, best_t = 0, 0, 0
    for i in range(n + 1):
        for j in range(m + 1):
            if H[i, j] > best_sc:
                best_sc, best_q, best_t = int(H[i, j]), i, j
    return best_q, best_t, best_sc
