"""Haplotig purging: move inter-haplotype duplicates to the alternate set.

Re-expresses the core of the built-in purge_dups (Purge_Dups.cpp:5527):
inter-haplotype homology is detected from the *trans* overlaps collected
during EC phasing (``reverse_paf`` — reads flipped at het SNP sites,
Purge_Dups.cpp lifts them to unitig coordinates in
``hap_alignment_advance_worker`` :5610).  A unitig whose reads are largely
trans-linked to a longer unitig is a haplotig duplicate: dropped from the
primary and emitted as alternate.  Coverage double-checks: a purged unitig
should carry roughly haploid coverage (het peak), not the hom peak.

Purge levels follow the CLI contract (-l0 off, -l1 contained-only,
-l2/-l3 similarity 0.75 / 0.55, CommandLines.cpp:299-310).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from hifiasm_tpu_torch.graph.unitig import UnitigGraph
from hifiasm_tpu_torch.overlap.paf import PafStore
from hifiasm_tpu_torch.utils.logging import log


@dataclass
class PurgeResult:
    primary: List[int]        # unitig ids kept in primary
    alternate: List[int]      # unitig ids moved to alternate
    hap_pairs: List[Tuple[int, int, float]]  # (purged, kept, link_frac)


def unitig_trans_links(ug: UnitigGraph, rev_paf: PafStore,
                       n_reads: int):
    """Sparse trans (inter-hap) read-link counts between unitigs
    (~the unitig-coordinate lift of hap_alignment_advance_worker).

    Returns ``{ua: {ub: count}}``; a dense [n, n] matrix is quadratic in
    unitig count and breaks at genome scale."""
    read_utg = np.full(n_reads, -1, np.int64)
    for uid, u in enumerate(ug.utgs):
        read_utg[(u.vs >> 1).astype(np.int64)] = uid
    qn, cols = rev_paf.flatten()
    ua = read_utg[qn.astype(np.int64)]
    ub = read_utg[cols["tn"].astype(np.int64)]
    keep = (ua >= 0) & (ub >= 0) & (ua != ub)
    # ONE distinct read of ua per ub: unique (read, target-unitig) pairs
    pair = np.unique(np.stack([qn[keep].astype(np.int64), ua[keep],
                               ub[keep]], axis=1), axis=0)
    links: dict = {}
    for a, b in zip(pair[:, 1], pair[:, 2]):
        row = links.setdefault(int(a), {})
        row[int(b)] = row.get(int(b), 0) + 1
    return links


def sym_link_edges(links: dict) -> dict:
    """{(a, b) a<b: links[a][b] + links[b][a]} from the sparse rows."""
    out: dict = {}
    for a, row in links.items():
        for b, c in row.items():
            k = (a, b) if a < b else (b, a)
            out[k] = out.get(k, 0) + c
    return out


HOM_PEAK_RATE = 1.25                  # Purge_Dups.h:12
HET_PEAK_RATE = HOM_PEAK_RATE * 2     # Purge_Dups.h:13
COV_COUNT = 1024                      # Purge_Dups.h:11


def purge_coverage_threshold(read_cov: np.ndarray, read_lens: np.ndarray,
                             hom_cov_kmer: int,
                             ploid_frac: float = 0.0) -> int:
    """Purge coverage threshold from the measured read-coverage histogram
    (~get_read_coverage_thres, Purge_Dups.cpp:394, + the if_ploid_sample
    fallback, :5591): above it a unitig is a collapsed homozygous region,
    not a haplotig duplicate.

    The length-weighted read-coverage peak (``coverage_only``) is checked
    against the k-mer histogram's hom peak (``k_mer_only``).  When they
    agree the threshold is k_mer_only * HOM_PEAK_RATE.  When they
    disagree, the ploidy test decides: a het-dominant sample
    (``ploid_frac`` — purge-candidate bases over total — above 1/3) makes
    the coverage peak the het peak, so thr = coverage_only *
    HET_PEAK_RATE; otherwise the k-mer peak wins."""
    if len(read_cov) == 0:
        return int(hom_cov_kmer * HOM_PEAK_RATE)
    cc = np.clip(read_cov.astype(np.int64), 0, COV_COUNT - 1)
    hist = np.bincount(cc, weights=read_lens.astype(np.float64),
                       minlength=COV_COUNT)
    hist[0] = 0                      # uncovered reads are not a peak
    coverage_only = int(np.argmax(hist))
    k_mer_only = max(int(hom_cov_kmer), 1)
    if abs(coverage_only - k_mer_only) <= 0.25 * k_mer_only:
        thr = int(k_mer_only * HOM_PEAK_RATE)
    elif ploid_frac > 1.0 / 3.0:
        thr = int(coverage_only * HET_PEAK_RATE)
    else:
        thr = int(k_mer_only * HOM_PEAK_RATE)
    log("purge_coverage_threshold",
        f"cov peak {coverage_only}, k-mer peak {k_mer_only}, "
        f"ploid_frac {ploid_frac:.2f} -> threshold {thr}")
    return thr


def purge_dups(ug: UnitigGraph, rev_paf: PafStore, n_reads: int,
               purge_level: int = 3, simi_rate: float = 0.55,
               min_ovlp_reads: int = 1, utg_cov=None,
               max_cov: int = -1, seed: int = 11) -> PurgeResult:
    """Phased duplicate purge (~purge_dups, Purge_Dups.cpp:5527-5679).

    Candidate haplotig pairs (trans-linked read fraction >= simi_rate)
    form a graph whose spins are solved with mc_solve — the reference
    phases all_ovlp before marking ALTER_LABLE (:5632) so chained
    duplicates are assigned consistently instead of greedily pair by
    pair.  Within each linked component the side with the larger total
    length stays primary; the other side's qualifying unitigs move to
    alternate.  ``max_cov`` (the purge coverage threshold) exempts
    collapsed homozygous unitigs."""
    n = len(ug.utgs)
    if purge_level <= 0 or n == 0:
        return PurgeResult(list(range(n)), [], [])
    links = unitig_trans_links(ug, rev_paf, n_reads)
    n_reads_utg = np.array([len(u.vs) for u in ug.utgs], np.int64)
    lens = np.array([u.len for u in ug.utgs], np.int64)

    def _cov_exempt(a: int) -> bool:
        return max_cov >= 0 and utg_cov is not None and \
            utg_cov[a] > max_cov

    # candidate pairs: either side trans-covered >= simi_rate by the other
    cand = {}
    for a, row in links.items():
        if _cov_exempt(a):
            continue
        for b, c in row.items():
            if b == a or c < min_ovlp_reads:
                continue
            frac = c / max(n_reads_utg[a], 1)
            if frac < simi_rate:
                continue
            key = (a, b) if a < b else (b, a)
            prev = cand.get(key)
            if prev is None or c > prev[0]:
                cand[key] = (c, float(frac))
    if not cand:
        log("purge_dups", f"purged 0 of {n} unitigs to alternate")
        return PurgeResult(list(range(n)), [], [])

    # phase the candidate graph (the mc_solve step inside purge)
    from hifiasm_tpu_torch.phasing.mc_solve import mc_solve
    ex = np.array([k[0] for k in sorted(cand)], np.int64)
    ey = np.array([k[1] for k in sorted(cand)], np.int64)
    ew = np.array([float(cand[k][0]) for k in sorted(cand)], np.float64)
    s = mc_solve(n, ex, ey, ew, seed=seed)

    # per component: the longer side stays primary
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(ex, ey):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    comp_len = {}
    in_cand = np.zeros(n, bool)
    in_cand[ex] = True
    in_cand[ey] = True
    for i in np.flatnonzero(in_cand):
        r = find(int(i))
        d = comp_len.setdefault(r, {1: 0, -1: 0})
        d[int(s[i]) if s[i] != 0 else 1] += int(lens[i])
    alive = np.ones(n, bool)
    alt, pairs = [], []
    best_partner = {}
    for (a, b), (c, frac) in cand.items():
        for x, y in ((a, b), (b, a)):
            cur = best_partner.get(x)
            if cur is None or c > cur[1]:
                best_partner[x] = (y, c, frac)
    for i in sorted(np.flatnonzero(in_cand).tolist()):
        if _cov_exempt(i) or s[i] == 0:
            continue
        r = find(i)
        d = comp_len[r]
        keep_side = 1 if d[1] >= d[-1] else -1
        if int(s[i]) != keep_side:
            alive[i] = False
            alt.append(i)
            b, c, frac = best_partner[i]
            pairs.append((i, int(b), float(frac)))
    primary = [i for i in range(n) if alive[i]]
    log("purge_dups", f"purged {len(alt)} of {n} unitigs to alternate "
        f"(phased over {len(cand)} candidate pairs)")
    return PurgeResult(primary, alt, pairs)


def link_purged_chains(ug: UnitigGraph, spans, purged: List[int]) -> int:
    """Join primary unitigs across purge gaps (~link_unitigs,
    Purge_Dups.cpp:4598 via the purge graph): when a purged haplotig m
    is covered by two primary partners over DISJOINT parts (a on m's
    left, b on m's right), the primaries adjoin in the other haplotype's
    frame — add the bridging arc a->b (and complement) so downstream
    joining/scaffolding can traverse the gap.

    ``spans``: [(m, partner, m_s, m_e, rev)] from the confirmed purge
    alignments.  Returns the number of bridges added."""
    by_m = {}
    for m, b, m_s, m_e, rev in spans:
        by_m.setdefault(int(m), []).append((int(m_s), int(m_e), int(b),
                                            int(rev)))
    purged_set = set(int(x) for x in purged)
    add_s, add_d = [], []
    have = {(int(a), int(b)) for a, b in zip(ug.a_src, ug.a_dst)}
    for m, parts in sorted(by_m.items()):
        if m not in purged_set or len(parts) < 2:
            continue
        parts.sort()
        for (s0, e0, a, ra), (s1, e1, b, rb) in zip(parts, parts[1:]):
            if a == b or a in purged_set or b in purged_set:
                continue
            if e0 > s1 + min(e0 - s0, e1 - s1) // 4:
                continue           # heavy overlap on m: not adjacent
            src = (a << 1) | ra
            dst = (b << 1) | rb
            if (src, dst) in have:
                continue
            for u, v in ((src, dst), (dst ^ 1, src ^ 1)):
                add_s.append(u)
                add_d.append(v)
                have.add((u, v))
    if add_s:
        ug.a_src = np.concatenate([ug.a_src,
                                   np.array(add_s, np.uint32)])
        ug.a_dst = np.concatenate([ug.a_dst,
                                   np.array(add_d, np.uint32)])
        ug.a_ol = np.concatenate([ug.a_ol,
                                  np.zeros(len(add_s), np.int64)])
    log("link_purged_chains", f"added {len(add_s) // 2} purge-gap bridges")
    return len(add_s) // 2
