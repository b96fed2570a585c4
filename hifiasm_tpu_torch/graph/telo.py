"""Telomere-aware tip protection (~gen_telo_end_t, Overlaps.cpp:39347).

``--telo-m CCCTAA``: read ends are scanned for the motif (both strands);
reads with a dense motif run at an end are telomeric, and cleaning must
never trim tips that contain them (``telo_end_t`` Overlaps.h:89-93,
threaded through every ``asg_arc_cut_tips`` call, gfa_ut.cpp:3059).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from hifiasm_tpu_torch.io.readstore import ReadStore, revcomp_codes, seq_to_codes
from hifiasm_tpu_torch.utils.logging import log


def _telo_scan_score(end_bytes: bytes, pat: bytes, pen: int,
                     drop: int) -> int:
    """Scored end walk (~the --telo-p/--telo-d scan): +len(motif) per
    motif hit, -pen per non-motif base, stop once the running score
    falls ``drop`` below its maximum; returns the best score (bases)."""
    mlen = len(pat)
    s = best = 0
    i = 0
    n = len(end_bytes)
    while i < n:
        if end_bytes.startswith(pat, i):
            s += mlen
            i += mlen
        else:
            s -= pen
            i += 1
        if s > best:
            best = s
        elif best - s > drop:
            break
    return best


def find_telo_reads(store: ReadStore, motif: str, end_len: int = 2000,
                    min_hits: int = 10, pen=None, drop=None) -> np.ndarray:
    """Boolean mask of reads with a telomeric motif run at either end.

    Default: plain motif-hit counting.  With ``pen``/``drop`` given
    (--telo-p / --telo-d), the reference's scored end scan gates
    additionally: the motif run must score >= min_hits * len(motif)
    bases before dropping ``drop`` below its running maximum."""
    m = seq_to_codes(motif.upper().encode())
    mr = revcomp_codes(m)
    out = np.zeros(store.n_reads, bool)
    pat = m.tobytes()
    pat_r = mr.tobytes()
    scored = pen is not None or drop is not None
    pen = 1 if pen is None else pen
    drop = 2000 if drop is None else drop
    for rid in range(store.n_reads):
        c = store.get_codes(rid)
        head = c[:end_len].tobytes()
        tail = c[-end_len:].tobytes()
        hits = max(head.count(pat), head.count(pat_r),
                   tail.count(pat), tail.count(pat_r))
        if hits < min_hits:
            continue
        if scored:
            sc = max(
                _telo_scan_score(head, pat, pen, drop),
                _telo_scan_score(head, pat_r, pen, drop),
                _telo_scan_score(tail[::-1], pat[::-1], pen, drop),
                _telo_scan_score(tail[::-1], pat_r[::-1], pen, drop))
            if sc < min_hits * len(pat):
                continue
        out[rid] = True
    log("find_telo_reads", f"{int(out.sum())} telomeric reads "
        f"(motif {motif})")
    return out
