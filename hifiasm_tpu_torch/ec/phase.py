"""Haplotype phasing of overlaps against a query read.

Re-expresses the het-SNP detection + overlap flipping of ``rphase_hc``
(ecovlp.cpp:3301) / ``generate_haplotypes_naive_HiFi`` (Correct.cpp:8845):
a site is heterozygous when BOTH the query allele and one alternate allele
have >= 2 supporting sequences (query counts for its own allele); overlaps
that carry the alternate haplotype at the het sites are flagged *trans*
(the reference's ``is_match = 2`` reverse overlaps) and excluded from the
consensus, which is what makes the correction haplotype-aware.

Vote collection is a segmented scatter-add over the CSR traceback arrays —
one ``np.add.at`` per read instead of the reference's per-site hash of
``haplotype_evdience`` records.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hifiasm_tpu_torch.ec.window_align import OverlapTracebacks
from hifiasm_tpu_torch.overlap.anchors import OverlapRegions


@dataclass
class PhaseResult:
    is_match: np.ndarray     # [n_ov] uint8: 1 cis, 2 trans, 0 dropped
    het_sites: np.ndarray    # sorted query positions of confirmed het SNPs
    site_alt: np.ndarray     # alternate allele per het site


def _positions(ov: OverlapRegions, tbs: OverlapTracebacks, usable: np.ndarray):
    """Flat (ov_idx, qpos) for every CSR slot of usable overlaps."""
    spans = (ov.x_e - ov.x_s + 1).astype(np.int64)
    oidx = np.repeat(np.arange(len(ov)), spans)
    if len(ov):
        off = np.concatenate([[0], np.cumsum(spans)])
        tot = int(off[-1])
        # segmented arange: x_s[o] + local offset within each overlap
        qpos = np.repeat(ov.x_s.astype(np.int64), spans) + \
            (np.arange(tot) - np.repeat(off[:-1], spans))
    else:
        qpos = np.zeros(0, np.int64)
    keep = usable[oidx]
    return oidx[keep], qpos[keep], keep


def het_from_counts(q: np.ndarray, cnt: np.ndarray, min_het_occ: int = 2,
                    del_cnt=None) -> tuple:
    """(het_sites, site_alt) from an allele-count matrix cnt [qlen, 4]
    that ALREADY includes the query's own vote.

    Base rule ~generate_haplotypes_naive_HiFi (occ0 >= 2 && occ1 >= 2),
    plus a two-sided balance test standing in for the reference's SNP
    matrix filter (SetSnpMatrix / rphase_hc, Correct.cpp:20191): a true
    het site splits the pile near 50/50, so the MINOR allele must carry
    >= 25% of the site's two-allele coverage.  Without it, two reads
    sharing a coincident sequencing error (2 vs 10) or a handful of
    divergent repeat-copy reads (3 vs 11) freeze the site as "het",
    invert the cis/trans split and block the correction — measured 1.3×
    to 2× residual-error excess vs the reference at err 0.01."""
    qlen = len(q)
    qsel = np.arange(qlen)
    qa = np.clip(q, 0, 3)
    occ0 = cnt[qsel, qa].astype(np.int64)
    alt_cnt = cnt.astype(np.int64).copy()
    alt_cnt[qsel, qa] = 0
    site_alt = np.argmax(alt_cnt, axis=1).astype(np.uint8)
    occ1 = alt_cnt[qsel, site_alt]
    minor = np.minimum(occ0, occ1)
    het = (occ0 >= min_het_occ) & (occ1 >= min_het_occ) & (q <= 3) & \
        (minor * 4 >= occ0 + occ1)
    if del_cnt is not None:
        # deletion-majority veto: a column where DELETION votes outnumber
        # every base vote combined is an uncorrected indel, not a SNP —
        # the few base votes that remain can split 2-2 and freeze the
        # site as het, blocking the deletion forever (the reference's
        # SNP matrix only ever sees base-vs-base splits)
        het &= ~(np.asarray(del_cnt, np.int64) > cnt.sum(axis=1))
    # alignment-SHIFT veto (~the reference's non_homopolymer_errors
    # discounting, ecovlp.cpp:2849): an uncorrected indel shifts the
    # voters' columns by one, minting ADJACENT pseudo-SNP pairs whose
    # alt alleles are the query shifted left/right by one.  Such pairs
    # flip half the local overlaps to trans and block the correction
    # forever — drop both sites.
    if qlen >= 2:
        sa = site_alt.astype(np.int64)
        pair = het[:-1] & het[1:]
        pairL = pair.copy()
        pairL[0] = False
        pairL[1:] &= (sa[1:-1] == qa[:-2]) & (sa[2:] == qa[1:-1])
        pairR = pair.copy()
        pairR[-1] = False
        pairR[:-1] &= (sa[:-2] == qa[1:-1]) & (sa[1:-1] == qa[2:])
        drop = np.zeros(qlen, bool)
        dp = pairL | pairR
        drop[:-1] |= dp
        drop[1:] |= dp
        het &= ~drop
    return np.flatnonzero(het), site_alt


def classify_overlaps(usable: np.ndarray, n_same: np.ndarray,
                      n_flip: np.ndarray, n_het_read: int = 0) -> np.ndarray:
    """is_match per overlap: 1 cis, 2 trans (flip wins), 0 unusable.

    An isolated het site can be a consensus-boundary artifact of the EC
    round — on haploid data such a site otherwise flips half the local
    overlaps and shatters the graph.  So on reads with < 3 het sites a
    trans flip needs >= 2 supporting sites; genuinely heterozygous reads
    (>= 3 sites) flip on standard majority evidence."""
    is_match = np.zeros(len(usable), np.uint8)
    is_match[usable] = 1
    min_flip = 1 if n_het_read >= 3 else 2
    is_match[usable & (n_flip > n_same) & (n_flip >= min_flip)] = 2
    return is_match


def phase_overlaps(q: np.ndarray, ov: OverlapRegions, tbs: OverlapTracebacks,
                   min_het_occ: int = 2) -> PhaseResult:
    n_ov = len(ov)
    is_match = np.zeros(n_ov, np.uint8)
    # per-WINDOW evidence (~wcns_gen, ecovlp.cpp:2293: every aligned
    # window of an is_match overlap votes; unaligned windows are skipped
    # individually, they do not disqualify the whole overlap) — at high
    # error rates requiring fully-aligned overlaps starves the consensus
    usable = tbs.win_ok > 0
    is_match[usable] = 1
    if n_ov == 0 or not usable.any():
        return PhaseResult(is_match, np.zeros(0, np.int64),
                           np.zeros(0, np.uint8))

    oidx, qpos, keep = _positions(ov, tbs, usable)
    tb = tbs.tb[keep]
    aligned = tb <= 3                      # substitution-comparable slots
    oidx_a, qpos_a, tb_a = oidx[aligned], qpos[aligned], tb[aligned]

    qlen = len(q)
    # allele counts per (position, base); query contributes its own allele
    # (bincount is ~20x faster than np.add.at for these scatter-adds)
    cnt = np.bincount(qpos_a * 4 + tb_a, minlength=qlen * 4
                      ).reshape(qlen, 4).astype(np.int32)
    cnt[np.arange(qlen), np.clip(q, 0, 3)] += np.int32(1)
    del_cnt = np.bincount(qpos[tb == 4], minlength=qlen)[:qlen]
    het_sites, site_alt = het_from_counts(q, cnt, min_het_occ,
                                          del_cnt=del_cnt)
    if len(het_sites) == 0:
        return PhaseResult(is_match, het_sites, site_alt[het_sites])

    # per-overlap het-site agreement: match query allele vs alternate allele
    qa = np.clip(q, 0, 3)
    het_mask = np.zeros(qlen, bool)
    het_mask[het_sites] = True
    at_het = het_mask[qpos_a]
    oh, ph, th = oidx_a[at_het], qpos_a[at_het], tb_a[at_het]
    n_same = np.bincount(oh[th == qa[ph]], minlength=n_ov).astype(np.int64)
    n_flip = np.bincount(oh[th == site_alt[ph]],
                         minlength=n_ov).astype(np.int64)
    is_match = classify_overlaps(usable, n_same, n_flip, len(het_sites))
    return PhaseResult(is_match, het_sites, site_alt[het_sites])
