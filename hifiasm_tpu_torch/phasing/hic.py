"""Hi-C integration: paired-read mapping onto contigs + phasing weights.

Re-expresses hic.cpp's ``hic_analysis`` (:17706) flow: a k=31 minimizer
index over the unitig sequences (``build_unitig_index`` :17711), exact
short-read mapping of the paired ends (``hic_short_align`` :17016), PE-hit
dedup, and link weighting between het unitigs feeding ``mc_solve``
(rcut.cpp) — Hi-C contacts are overwhelmingly intra-haplotype, so a PE
link between two unitigs is SAME-haplotype evidence (negative weight in
our max-cut convention), balanced against the inter-hap trans-overlap
evidence (positive weight).

Mapping here is the batched exact k-mer vote: a read maps to a unitig
when all its indexed k-mers agree on one unitig (unique placement), which
is what the reference's exact matcher converges to for short reads.

The port of hifiasm_tpu/phasing/hic.py.  Ends the vote cannot place are
seed-extend rescued by K2 (ops/banded_fwd.banded_forward) on the
assembly's device: the kernel for ``cuda``, its plain version for
``cpu``; both give the err of ``banded_batch_np(..., traceback=False)``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from hifiasm_tpu_torch.device import resolve_device
from hifiasm_tpu_torch.trio import yak_hash64_masked, sliding_all
from hifiasm_tpu_torch.utils.logging import log

HIC_K = 31

# wall seconds and counters of map_hic_pairs_pos_batch since the last
# reset: vote_s is the k-mer vote, pack_s the host packing of the rescue's
# X and Y rows, k2_s the rescue's K2 calls (upload, kernel, fetch)
STATS = {"vote_s": 0.0, "pack_s": 0.0, "k2_s": 0.0, "pairs": 0,
         "hits": 0, "rescue_rows": 0, "rescued": 0}


def _seq_kmers(codes: np.ndarray, k: int,
               with_pos: bool = False):
    """Canonical k-mer hashes at each end position (N-free windows only)."""
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.uint64)
        return (np.zeros(0, np.int64), z) if with_pos else z
    mask = np.uint64((1 << (2 * k)) - 1)
    valid = codes < 4
    c = np.where(valid, codes, 0).astype(np.uint64)
    # rolling accumulation: k O(n) passes with O(n) memory — the
    # sliding-window product materialized an [n, k] u64 plane (3.7 GB
    # for one 15 Mb unitig), the wall of UnitigIndex at genome scale
    m = n - k + 1
    two = np.uint64(2)
    fwd = np.zeros(m, np.uint64)
    for t in range(k):
        fwd = ((fwd << two) | c[t:t + m]) & mask
    d = (np.uint64(3) - c)[::-1]
    rcr = np.zeros(m, np.uint64)
    for t in range(k):
        rcr = ((rcr << two) | d[t:t + m]) & mask
    rc = rcr[::-1]
    canon = np.minimum(fwd, rc)
    ok = sliding_all(valid, k)
    h = yak_hash64_masked(canon[ok], mask)
    if with_pos:
        ends = np.arange(k - 1, n, dtype=np.int64)[ok]
        return ends, h
    return h


@dataclass
class UnitigIndex:
    hashes: np.ndarray    # sorted unique k-mer hashes that occur in ONE utg
    uid: np.ndarray       # unitig id per hash
    pos: Optional[np.ndarray] = None   # unitig coordinate per hash
    _pref16: Optional[np.ndarray] = None   # 65537 bucket starts (hash>>48)

    def pref16(self) -> np.ndarray:
        """Bucket starts by the hash's top 16 bits: bounds each probe's
        binary search to one cache-resident slice."""
        if self._pref16 is None:
            p = np.zeros(65537, np.int64)
            p[:65536] = np.searchsorted(
                self.hashes, np.arange(65536, dtype=np.uint64) << np.uint64(48))
            p[65536] = len(self.hashes)
            self._pref16 = p
        return self._pref16

    @classmethod
    def build(cls, utg_seqs: List[np.ndarray], k: int = HIC_K
              ) -> "UnitigIndex":
        hs, us, ps = [], [], []
        for uid, seq in enumerate(utg_seqs):
            ends, h = _seq_kmers(seq, k, with_pos=True)
            uh, first = np.unique(h, return_index=True)
            hs.append(uh)
            us.append(np.full(len(uh), uid, np.int32))
            ps.append(ends[first].astype(np.int64))
        allh = np.concatenate(hs) if hs else np.zeros(0, np.uint64)
        allu = np.concatenate(us) if us else np.zeros(0, np.int32)
        allp = np.concatenate(ps) if ps else np.zeros(0, np.int64)
        order = np.argsort(allh, kind="stable")
        allh, allu, allp = allh[order], allu[order], allp[order]
        uniq, first, cnt = np.unique(allh, return_index=True,
                                     return_counts=True)
        keep = cnt == 1                      # unique-to-one-unitig k-mers
        log("UnitigIndex", f"{int(keep.sum())} unique anchor k-mers over "
            f"{len(utg_seqs)} unitigs")
        return cls(uniq[keep], allu[first[keep]], allp[first[keep]])

    def map_read(self, codes: np.ndarray, k: int = HIC_K) -> int:
        """Unitig id if the read places uniquely, else -1."""
        return self.map_read_pos(codes, k)[0]

    def map_read_pos(self, codes: np.ndarray, k: int = HIC_K,
                     min_frac: float = 0.7) -> Tuple[int, int]:
        """(unitig id, position) of a confidently-placed read, else
        (-1, -1).  Placement is by majority vote over anchoring k-mers:
        sequencing errors can turn a k-mer into one that happens to anchor
        elsewhere, so requiring unanimity collapses the mapping rate on
        real short reads — a read places when >= min_frac of its matched
        k-mers (and >= 2 when more than one matched) agree on one unitig
        (the rescue half of the reference's mismatch-tolerant
        ``hic_short_align``, hic.cpp:17016)."""
        h = _seq_kmers(codes, k)
        if len(h) == 0 or len(self.hashes) == 0:
            return -1, -1
        idx = np.minimum(np.searchsorted(self.hashes, h),
                         len(self.hashes) - 1)
        hit = self.hashes[idx] == h
        if not hit.any():
            return -1, -1
        hit_idx = idx[hit]
        uids, cnt = np.unique(self.uid[hit_idx], return_counts=True)
        top = int(np.argmax(cnt))
        n_hit = int(cnt.sum())
        if cnt[top] < n_hit * min_frac:
            return -1, -1
        if n_hit > 1 and cnt[top] < 2:
            return -1, -1
        uid = int(uids[top])
        if self.pos is None:
            return uid, -1
        first_pos = hit_idx[self.uid[hit_idx] == uid][0]
        return uid, int(self.pos[first_pos])


def map_hic_pairs(index: UnitigIndex, pairs, k: int = HIC_K) -> np.ndarray:
    """pairs: iterable of (codes_r1, codes_r2) -> [n, 2] unitig ids of
    pairs where BOTH ends placed uniquely (~the deduped pe_hits)."""
    out = []
    for r1, r2 in pairs:
        u1 = index.map_read(r1, k)
        u2 = index.map_read(r2, k)
        if u1 >= 0 and u2 >= 0:
            out.append((u1, u2))
    hits = np.array(out, np.int64).reshape(-1, 2)
    log("map_hic_pairs", f"{len(hits)} PE hits mapped of "
        f"{len(out) if out else 0} candidates")
    return hits


def hic_link_matrix(n_utg: int, pe_hits: np.ndarray,
                    utg_lens: np.ndarray = None,
                    sc_weight: bool = True) -> dict:
    """Symmetric inter-unitig Hi-C contact weights, sparse
    {(a, b) a<b: weight} (dense [n, n] breaks at genome scale).

    With positions available (pe_hits [n, 4] = u1, p1, u2, p2 and
    ``utg_lens``), the default weighting classifies each hit by which
    HALF of each unitig its ends land in (4 classes) and scores the
    pair as 2x its strongest class (~hic_sc_type + the sw[] min pass of
    weight_kv_u_trans, hic.cpp:16029,16090-16109): weight dominated by
    a single end-pair region — adjacency rather than phasing signal —
    no longer out-votes spread contacts.  ``sc_weight=False``
    (--unskew) keeps the plain hit count."""
    m: dict = {}
    has_pos = pe_hits.shape[1] >= 4 and utg_lens is not None
    if not (sc_weight and has_pos):
        u1 = pe_hits[:, 0]
        u2 = pe_hits[:, 2] if pe_hits.shape[1] >= 4 else pe_hits[:, 1]
        sel = u1 != u2
        for a, b in zip(u1[sel], u2[sel]):
            k = (int(a), int(b)) if a < b else (int(b), int(a))
            m[k] = m.get(k, 0) + 1
        return m
    u1, p1, u2, p2 = (pe_hits[:, i] for i in range(4))
    sel = u1 != u2
    half1 = (p1[sel] >= utg_lens[u1[sel]] // 2).astype(np.int64)
    half2 = (p2[sel] >= utg_lens[u2[sel]] // 2).astype(np.int64)
    cls: dict = {}
    for a, b, h1, h2 in zip(u1[sel], u2[sel], half1, half2):
        if a < b:
            k, c = (int(a), int(b)), int(h1 + 2 * h2)
        else:
            k, c = (int(b), int(a)), int(h2 + 2 * h1)
        v = cls.get(k)
        if v is None:
            v = cls[k] = [0, 0, 0, 0]
        v[c] += 1
    for k, v in cls.items():
        m[k] = 2 * max(v)
    return m


def hic_benchmark_eval(hits4: np.ndarray, hap_of: np.ndarray,
                       homolog: dict, out) -> Tuple[int, int]:
    """Hi-C phasing-signal benchmark, gated on trio + Hi-C inputs
    together (~hic_benchmark/evaluate_bench_idx, hic.cpp:18383,18286;
    call gate Overlaps.cpp:39621): trio labels are the ground truth —
    every positioned PE hit scores (insert distance, is_trans) where
    is_trans=1 means the ends land on opposite-haplotype unitigs.
    Distance: same unitig |p1-p2|; cross-hap hits between PAIRED
    homolog unitigs use the homolog-aligned coordinates (the bench_idx
    link distances); anything else has no defined distance and only
    counts toward the cis/trans totals.  Lines print distance-sorted
    (the radix_sort_hc64 dump).  Returns (n_cis, n_trans)."""
    recs = []
    trans = [0, 0]
    for u1, p1, u2, p2 in np.asarray(hits4, np.int64):
        h1, h2 = int(hap_of[u1]), int(hap_of[u2])
        if h1 == 0 or h2 == 0:
            continue                      # unlabeled (hom/ambiguous)
        if u1 == u2:
            trans[0] += 1
            recs.append((abs(int(p2) - int(p1)) << 1))
            continue
        it = int(h1 != h2)
        trans[it] += 1
        if it and homolog.get(int(u1)) == int(u2):
            recs.append((abs(int(p2) - int(p1)) << 1) | 1)
    recs.sort()
    for r in recs:
        out.write(f"{r >> 1}\t{r & 1}\n")
    log("hic_benchmark",
        f"{trans[0]} cis + {trans[1]} trans labeled hits, "
        f"trans rate {trans[1] / max(trans[0] + trans[1], 1):.4f}")
    return trans[0], trans[1]


def combine_phase_weights(trans_links: dict, hic_links: dict,
                          hic_scale: float = 1.0, min_evidence: int = 2
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edges for mc_solve: w > 0 different hap (trans), w < 0 same hap
    (Hi-C), following the reference's weighting rounds (hic.cpp:17082).
    Both inputs are sparse: trans {a: {b: count}}, hic {(a, b): count}."""
    from hifiasm_tpu_torch.graph.purge import sym_link_edges

    pairs = dict(sym_link_edges(trans_links))
    for k in hic_links:
        pairs.setdefault(k, 0)
    ex, ey, ew = [], [], []
    for (a, b) in sorted(pairs):
        t = pairs[(a, b)]
        h = hic_links.get((a, b), 0)
        if t + h < min_evidence:
            continue
        ex.append(a)
        ey.append(b)
        ew.append(float(t) - hic_scale * float(h))
    return (np.array(ex, np.int64), np.array(ey, np.int64),
            np.array(ew, np.float64))


def map_hic_pairs_pos(index: UnitigIndex, pairs, k: int = HIC_K
                      ) -> np.ndarray:
    """[n, 4] (u1, p1, u2, p2) for PE pairs where both ends placed
    uniquely (positions are unitig coordinates)."""
    out = []
    for r1, r2 in pairs:
        u1, p1 = index.map_read_pos(r1, k)
        u2, p2 = index.map_read_pos(r2, k)
        if u1 >= 0 and u2 >= 0:
            out.append((u1, p1, u2, p2))
    hits = np.array(out, np.int64).reshape(-1, 4)
    log("map_hic_pairs_pos", f"{len(hits)} positioned PE hits")
    return hits


def dedup_pe_hits(hits4: np.ndarray) -> np.ndarray:
    """PCR/optical duplicate removal (~the dedup_hits pass of
    hic.cpp:17016): PE hits with identical (u1, p1, u2, p2) coordinates
    are one molecule — keep a single copy (order-normalized)."""
    if len(hits4) == 0:
        return hits4
    a = hits4.copy()
    swap = (a[:, 0] > a[:, 2]) | ((a[:, 0] == a[:, 2]) &
                                  (a[:, 1] > a[:, 3]))
    a[swap] = a[swap][:, [2, 3, 0, 1]]
    order = np.lexsort((a[:, 3], a[:, 2], a[:, 1], a[:, 0]))
    a = a[order]
    keep = np.ones(len(a), bool)
    keep[1:] = (a[1:] != a[:-1]).any(axis=1)
    out = a[keep]
    log("dedup_pe_hits", f"{len(hits4)} -> {len(out)} PE hits after dedup")
    return out


def hic_phase_loop(n: int, trans_links: dict, hic_links: dict,
                   n_weight: int = 3, hic_scale: float = 1.0,
                   min_evidence: int = 2, seed: int = 11,
                   n_perturb: int = 1000, f_perturb: float = 0.1
                   ) -> np.ndarray:
    """The n_weight renew->solve->label loop (hic.cpp:17082-17116).

    Round 0 solves the combined trans/Hi-C weights from scratch.  Later
    rounds RENEW the Hi-C weights against the current labels before
    re-solving (~renew_kv_u_trans + get_trans_rate_function_advance,
    hic.cpp:16003): the reference calibrates a noise-rate model from the
    current phasing and re-weights every link with it.  Here each Hi-C
    link is scaled by the leave-one-out consistency of its two endpoints
    — the fraction of each node's OTHER labeled Hi-C evidence that
    agrees with the current labels — so a noise contact that contradicts
    the rest of its endpoints' evidence decays to zero instead of
    locking in a wrong label.  The solver warm-starts from the previous
    round's spins.  Returns spins in {-1, +1}."""
    from hifiasm_tpu_torch.graph.purge import sym_link_edges
    from hifiasm_tpu_torch.phasing.mc_solve import mc_solve

    pairs = dict(sym_link_edges(trans_links))
    for key in hic_links:
        pairs.setdefault(key, 0)
    # per-link cumulative damping: once a noise link is calibrated away
    # it stays away (the reference refits its rate model each round from
    # the labels; monotone damping is the stable discrete analog)
    scale = {key: 1.0 for key in hic_links}
    s = None
    for rnd in range(max(n_weight, 1)):
        if s is not None:
            # consistency tables over EFFECTIVE evidence incl. the trans
            # links (trans = different-hap evidence)
            cons = np.zeros(n, np.float64)
            tot = np.zeros(n, np.float64)
            for (a, b), h in hic_links.items():
                he = h * scale[(a, b)]
                if s[a] == 0 or s[b] == 0 or he <= 0:
                    continue
                tot[a] += he
                tot[b] += he
                if s[a] == s[b]:
                    cons[a] += he
                    cons[b] += he
            for (a, b), t in pairs.items():
                if t <= 0 or s[a] == 0 or s[b] == 0:
                    continue
                tot[a] += t
                tot[b] += t
                if s[a] != s[b]:
                    cons[a] += t
                    cons[b] += t

            def rest_cons(u, h_ab):
                t_o = tot[u] - h_ab
                if t_o <= 0:
                    return 1.0             # no other evidence: neutral
                return max(cons[u] - h_ab, 0.0) / t_o

            for (a, b), h in hic_links.items():
                he = h * scale[(a, b)]
                if he <= 0 or s[a] == 0 or s[b] == 0 or s[a] != s[b]:
                    continue               # only AGREEING links calibrate
                scale[(a, b)] *= rest_cons(a, he) * rest_cons(b, he)
        ex, ey, ew = [], [], []
        for (a, b) in sorted(pairs):
            t = float(pairs[(a, b)])
            h = float(hic_links.get((a, b), 0))
            if t + h < min_evidence:
                continue
            ex.append(a)
            ey.append(b)
            ew.append(t - hic_scale * h * scale.get((a, b), 1.0))
        if not ex:
            return np.zeros(n, np.int8)
        if s is None and n > 64:
            # big tangles: round 0 solves block-coarsened first (~the
            # mb_* path of mc_solve, rcut.cpp:641) — blocks are the
            # connected components of the trans-overlap set
            from hifiasm_tpu_torch.phasing.mc_solve import mc_solve_blocks
            tb = [(a, b) for (a, b), t in sorted(pairs.items()) if t > 0]
            s = mc_solve_blocks(
                n, np.array(ex, np.int64), np.array(ey, np.int64),
                np.array(ew, np.float64),
                np.array([a for a, _ in tb], np.int64),
                np.array([b for _, b in tb], np.int64),
                n_perturb=n_perturb, f_perturb=f_perturb, seed=seed)
        else:
            s = mc_solve(n, np.array(ex, np.int64),
                         np.array(ey, np.int64),
                         np.array(ew, np.float64), n_perturb=n_perturb,
                         f_perturb=f_perturb, seed=seed, init_s=s)
    return s


def detect_switch_misjoins(utg_lens: np.ndarray, hits4: np.ndarray,
                           misjoin_len: int = 500_000,
                           min_hits: int = 5) -> dict:
    """Misjoin (switch-error) detection (~update_switch_unitig,
    hic.cpp:17051): a unitig whose left segment contacts partner v1 and
    whose right segment contacts a different partner v2 — with v1 and v2
    barely contacting each other — is a haplotype misjoin. Returns
    {uid: break_position}. ``misjoin_len`` 0 disables; only unitigs of
    >= misjoin_len are examined (the reference's 500 kb default)."""
    breaks: dict = {}
    if misjoin_len <= 0 or len(hits4) == 0:
        return breaks
    # sparse inter-unitig contact counts (a dense [n, n] matrix would be
    # quadratic in unitig count at genome scale)
    sel = hits4[hits4[:, 0] != hits4[:, 2]]
    inter: dict = {}
    for a, b in zip(sel[:, 0], sel[:, 2]):
        k = (int(a), int(b)) if a < b else (int(b), int(a))
        inter[k] = inter.get(k, 0) + 1

    def inter_of(a, b):
        return inter.get((a, b) if a < b else (b, a), 0)
    for u in np.flatnonzero(utg_lens >= misjoin_len):
        # contacts of u: (position on u, partner)
        a = hits4[(hits4[:, 0] == u) & (hits4[:, 2] != u)][:, [1, 2]]
        b = hits4[(hits4[:, 2] == u) & (hits4[:, 0] != u)][:, [3, 0]]
        c = np.concatenate([a, b]) if len(a) or len(b) else \
            np.zeros((0, 2), np.int64)
        if len(c) < 2 * min_hits:
            continue
        part, cnt = np.unique(c[:, 1], return_counts=True)
        top = part[np.argsort(-cnt)[:2]]
        if len(top) < 2:
            continue
        v1, v2 = int(top[0]), int(top[1])
        p1 = np.sort(c[c[:, 1] == v1][:, 0])
        p2 = np.sort(c[c[:, 1] == v2][:, 0])
        if len(p1) < min_hits or len(p2) < min_hits:
            continue
        # the partners must be spatially separated on u...
        if p1.max() < p2.min():
            lo, hi = int(p1.max()), int(p2.min())
        elif p2.max() < p1.min():
            lo, hi = int(p2.max()), int(p1.min())
        else:
            continue
        # ...and (different haplotype) barely contact each other
        if inter_of(v1, v2) * 4 >= min(inter_of(int(u), v1),
                                       inter_of(int(u), v2)):
            continue
        breaks[int(u)] = (lo + hi) // 2
    if breaks:
        log("detect_switch_misjoins", f"{len(breaks)} misjoined unitigs")
    return breaks


def resolve_tangles_hic(ug, hits4: np.ndarray, max_w_occ: int = 4,
                        chain_cap: int = 5) -> int:
    """Hi-C-guided tangle resolution (~resolve_tangles_hic +
    resolve_bubble_chain_by_hic, hic.cpp:16259/:13990): at every unitig
    end with >= 2 outgoing arcs, score each branch by the normalized
    Hi-C contact weight between the source unitig and the branch's
    downstream chain (walked up to ``chain_cap`` unitigs); when the best
    branch has real support (> ``max_w_occ`` raw hits, the reference's
    cutoff) the competing arcs are dropped (with their mirrors).

    Simplification vs the reference: the source context is the branching
    unitig itself rather than the whole upstream bubble chain, and the
    walk is over unitig arcs rather than the bubble-chain graph.
    Returns the number of arcs cut."""
    n = len(ug)
    if n == 0 or len(hits4) == 0 or len(ug.a_src) == 0:
        return 0
    h = np.asarray(hits4, np.int64)
    u1, u2 = h[:, 0], h[:, 2]
    inter = u1 != u2
    lo = np.minimum(u1[inter], u2[inter])
    hi = np.maximum(u1[inter], u2[inter])
    key, cnt = np.unique(lo * np.int64(n) + hi, return_counts=True)
    contacts = dict(zip(key.tolist(), cnt.tolist()))
    tot = np.bincount(np.concatenate([u1, u2]), minlength=n).astype(
        np.int64)

    def occ_of(a: int, b: int) -> int:
        if a == b:
            return 0
        a2, b2 = (a, b) if a < b else (b, a)
        return contacts.get(a2 * n + b2, 0)

    # per-end outgoing arc lists
    out_of = {}
    for i in range(len(ug.a_src)):
        out_of.setdefault(int(ug.a_src[i]), []).append(i)

    def walk(d: int):
        """Unitig ids along the single-path chain entered via end d."""
        chain = []
        cur = d
        seen = set()
        for _ in range(chain_cap):
            uid = cur >> 1
            if uid in seen:
                break
            seen.add(uid)
            chain.append(uid)
            nxt = out_of.get((uid << 1) | (cur & 1), [])
            live = [i for i in nxt if not_cut[i] ]
            if len(live) != 1:
                break
            cur = int(ug.a_dst[live[0]])
        return chain

    not_cut = np.ones(len(ug.a_src), bool)
    arc_key = {}
    for i in range(len(ug.a_src)):
        arc_key[(int(ug.a_src[i]), int(ug.a_dst[i]))] = i
    n_cut = 0
    for e in sorted(out_of):
        idxs = [i for i in out_of[e] if not_cut[i]]
        if len(idxs) < 2:
            continue
        src_u = e >> 1
        best_i, best_w, best_occ = -1, -1.0, 0
        ws = []
        for i in idxs:
            chain = walk(int(ug.a_dst[i]))
            occ = sum(occ_of(src_u, c) for c in chain)
            denom = max(min(int(tot[src_u]),
                            max(int(tot[c]) for c in chain)
                            if chain else 1), 1)
            w = occ / denom
            ws.append((w, occ, i))
            if w > best_w:
                best_i, best_w, best_occ = i, w, occ
        if best_occ <= max_w_occ:
            continue
        for w, occ, i in ws:
            if i == best_i:
                continue
            not_cut[i] = False
            n_cut += 1
            m = arc_key.get((int(ug.a_dst[i]) ^ 1, int(ug.a_src[i]) ^ 1))
            if m is not None and not_cut[m]:
                not_cut[m] = False
                n_cut += 1
    if n_cut:
        keep = np.flatnonzero(not_cut)
        ug.a_src = ug.a_src[keep]
        ug.a_dst = ug.a_dst[keep]
        ug.a_ol = ug.a_ol[keep]
        log("resolve_tangles_hic", f"cut {n_cut} tangle arcs")
    return n_cut


def _seq_kmers_batch(mat: np.ndarray, k: int):
    """Canonical k-mer hashes for a [N, L] padded code matrix (pad = 4).

    Vectorized (incremental rolling pack over the L axis) equivalent of
    per-read ``_seq_kmers(..., with_pos=True)``: returns ``(ok, ends,
    h)`` where ``ok`` is the [N, L-k+1] validity mask, ``ends`` the
    k-mer end positions and ``h`` the [N, L-k+1] hash plane (junk where
    ``~ok``)."""
    N, L = mat.shape
    if L < k:
        return (np.zeros((N, 0), bool), np.zeros(0, np.int64),
                np.zeros((N, 0), np.uint64))
    mask = np.uint64((1 << (2 * k)) - 1)
    valid = mat < 4
    # transpose: the rolling loop reads/writes contiguous [N] rows
    cT = np.ascontiguousarray(np.where(valid, mat, 0).astype(np.uint64).T)
    fwdT = np.empty((L, N), np.uint64)
    rcT = np.empty((L, N), np.uint64)
    f = np.zeros(N, np.uint64)
    r = np.zeros(N, np.uint64)
    hi = np.uint64(2 * (k - 1))
    two = np.uint64(2)
    three = np.uint64(3)
    for j in range(L):
        f = ((f << two) | cT[j]) & mask
        r = (r >> two) | ((three - cT[j]) << hi)
        fwdT[j] = f
        rcT[j] = r
    canon = np.minimum(fwdT, rcT).T[:, k - 1:]
    # all-valid windows: no N/pad inside the k-mer
    inv = (~valid).astype(np.int64)
    cs = np.concatenate([np.zeros((N, 1), np.int64),
                         np.cumsum(inv, axis=1)], axis=1)
    ok = (cs[:, k:] - cs[:, :-k]) == 0
    h = yak_hash64_masked(canon.reshape(-1), mask).reshape(canon.shape)
    ends = np.arange(k - 1, L, dtype=np.int64)
    return ok, ends, h


def _vote_place_batch(index: UnitigIndex, mat: np.ndarray, k: int,
                      min_frac: float = 0.7):
    """Vectorized ``map_read_pos`` over a padded read matrix.

    Returns ``(uid[N], pos[N], cands)``: uid/pos follow map_read_pos
    semantics exactly (majority >= min_frac of matched k-mers, >=2
    votes when more than one matched, lowest uid on count ties,
    position from the first matching k-mer in scan order).  ``cands``
    is a [N, 2, 3] (uid, implied_start, votes) plane of the top-2 vote
    candidates (-1-filled) for the seed-extend rescue of reads the
    vote could not place."""
    N = mat.shape[0]
    uid_out = np.full(N, -1, np.int64)
    pos_out = np.full(N, -1, np.int64)
    cands = np.full((N, 2, 3), -1, np.int64)
    cands[:, :, 2] = 0
    if len(index.hashes) == 0 or N == 0:
        return uid_out, pos_out, cands
    if index.pos is not None:
        from hifiasm_tpu_torch.native import hic_map_native
        got = hic_map_native(mat, k, index.hashes, index.uid, index.pos,
                             index.pref16(), min_frac)
        if got is not None:
            return got
    ok, ends, h = _seq_kmers_batch(mat, k)
    if h.size == 0:
        return uid_out, pos_out, cands
    rid2, end2 = np.nonzero(ok)
    hh = h[rid2, end2]
    # probe in SORTED query order: sequential access into the index
    # array beats 12M random binary searches by ~4x (cache locality)
    qorder = np.argsort(hh, kind="stable")
    idx = np.empty(len(hh), np.int64)
    idx[qorder] = np.searchsorted(index.hashes, hh[qorder])
    idx = np.minimum(idx, len(index.hashes) - 1)
    hit = index.hashes[idx] == hh
    rid_m = rid2[hit]
    kend_m = ends[end2[hit]]
    hit_idx = idx[hit]
    uid_m = index.uid[hit_idx].astype(np.int64)
    if len(rid_m) == 0:
        return uid_out, pos_out, cands
    # per-(read, uid) vote counts
    order = np.lexsort((uid_m, rid_m))
    rs, us = rid_m[order], uid_m[order]
    new = np.ones(len(rs), bool)
    new[1:] = (rs[1:] != rs[:-1]) | (us[1:] != us[:-1])
    grp = np.cumsum(new) - 1
    g_rid = rs[new]
    g_uid = us[new]
    g_cnt = np.bincount(grp)
    tot = np.bincount(rid_m, minlength=N)
    # rank groups per read: by count desc, uid asc (the argmax order)
    sel = np.lexsort((g_uid, -g_cnt, g_rid))
    gr = g_rid[sel]
    first = np.ones(len(sel), bool)
    first[1:] = gr[1:] != gr[:-1]
    second = np.zeros(len(sel), bool)
    second[1:] = first[:-1] & (gr[1:] == gr[:-1])
    win_rid = gr[first]
    win_uid = g_uid[sel][first]
    win_cnt = g_cnt[sel][first]
    n_hit = tot[win_rid]
    placed = (win_cnt >= n_hit * min_frac) & \
        ((n_hit <= 1) | (win_cnt >= 2))
    uid_out[win_rid[placed]] = win_uid[placed]

    def _first_kmer_of(cand_of):
        """Per read, the first (scan-order) matched k-mer whose uid is
        that read's candidate: returns (rids, utg_pos, kmer_end)."""
        mine = uid_m == cand_of[rid_m]
        rr = rid_m[mine]
        r_first, i_first = np.unique(rr, return_index=True)
        src = np.flatnonzero(mine)[i_first]
        return r_first, index.pos[hit_idx[src]], kend_m[src]

    if index.pos is not None:
        win_of = np.full(N, -2, np.int64)
        win_of[win_rid] = win_uid
        r1, upos1, kend1 = _first_kmer_of(win_of)
        ok1 = uid_out[r1] >= 0
        pos_out[r1[ok1]] = upos1[ok1]
        cands[r1, 0, 0] = win_of[r1]
        cands[r1, 0, 1] = upos1 - kend1
        cands[win_rid, 0, 2] = win_cnt
        sec_rid = gr[second]
        sec_of = np.full(N, -2, np.int64)
        sec_of[sec_rid] = g_uid[sel][second]
        r2, upos2, kend2 = _first_kmer_of(sec_of)
        cands[r2, 1, 0] = sec_of[r2]
        cands[r2, 1, 1] = upos2 - kend2
        cands[sec_rid, 1, 2] = g_cnt[sel][second]
    return uid_out, pos_out, cands


def pack_rescue_rows(mat: np.ndarray, rr: np.ndarray, cand_col: int,
                     cands: np.ndarray, utg_seqs: List[np.ndarray],
                     e: int):
    """Host packing of the seed-extend rescue, as the JAX package packs
    it: row j holds read ``rr[j]``'s bases (X) and the unitig segment
    around its ``cand_col`` candidate placement, ``e`` bases either side
    (Y; clamped at the unitig's ends, so ylen may fall short of
    xlen + 2e).  Returns (X [n, XL], xl, Y [n, XL + 2e], yl, rl) with XL
    the longest read of the batch."""
    rl = (mat[rr] < 4).sum(axis=1).astype(np.int64)
    XL = max(int(rl.max()), 1)
    X = np.full((len(rr), XL), 4, np.uint8)
    Y = np.full((len(rr), XL + 2 * e), 4, np.uint8)
    xl = np.zeros(len(rr), np.int64)
    yl = np.zeros(len(rr), np.int64)
    for j, i in enumerate(rr):
        r = mat[i][mat[i] < 4]
        useq = utg_seqs[int(cands[i, cand_col, 0])]
        y0 = max(int(cands[i, cand_col, 1]) - e, 0)
        yseg = useq[y0:int(cands[i, cand_col, 1]) + len(r) + e]
        X[j, :len(r)] = r
        Y[j, :len(yseg)] = yseg
        xl[j] = len(r)
        yl[j] = len(yseg)
    return X, xl, Y, yl, rl


def rescue_align(X: np.ndarray, xl: np.ndarray, Y: np.ndarray,
                 yl: np.ndarray, e: int, device="cuda") -> np.ndarray:
    """err of the banded forward scan for the packed rescue rows, by K2
    on ``device`` (the kernel for cuda, its plain version for cpu):
    ``banded_batch_np(X, xl, Y, yl, e, traceback=False).err``, -1 past
    ``e`` errors.  int64 [n] on the host."""
    import torch

    from hifiasm_tpu_torch.ops.banded_fwd import banded_forward

    dev = resolve_device(device)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        X, xl.astype(np.int32), Y, yl.astype(np.int32))]
    res = banded_forward(t[0], t[1], t[2], t[3], e)
    return res.err.cpu().numpy().astype(np.int64)


def map_hic_pairs_pos_batch(index: UnitigIndex, pairs,
                            utg_seqs: Optional[List[np.ndarray]] = None,
                            k: int = HIC_K, batch: int = 65536,
                            rescue_band: int = 8,
                            rescue_err: float = 0.06,
                            device="cuda") -> np.ndarray:
    """Vectorized PE mapping: [n, 4] (u1, p1, u2, p2) hits where both
    ends placed (~hic_short_align, hic.cpp:17016, whose worker maps PE
    batches in parallel — here one numpy batch replaces the thread
    pool).  Bit-identical with per-read ``map_read_pos`` on the vote
    path; when ``utg_seqs`` is given, ends the vote could NOT place
    (typically a haplotype-split vote: an error at a het site flips a
    k-mer into the sister haplotype's unique set) are seed-extend
    rescued — the top-2 candidates' implied placements are banded-
    aligned (K2 on ``device``, ``rescue_align``) and the strictly-better
    one is accepted when its edit rate is <= ``rescue_err``.  This is
    the mismatch-tolerant half of the reference's short aligner that
    k-mer votes alone lose at real Hi-C error rates."""
    dev = resolve_device(device)
    out = []
    n_rescued = 0
    buf: list = []

    def _align_cands(mat, rows, cand_col, cands):
        """Banded edit distance of each row's read vs its cand_col
        candidate placement; rows with no such candidate get a huge
        sentinel."""
        big = np.full(len(rows), 1 << 30, np.int64)
        have = cands[rows, cand_col, 0] >= 0
        rr = rows[have]
        if not len(rr):
            return big
        e = rescue_band
        t0 = time.time()
        X, xl, Y, yl, rl = pack_rescue_rows(mat, rr, cand_col, cands,
                                            utg_seqs, e)
        t1 = time.time()
        res_err = rescue_align(X, xl, Y, yl, e, dev)
        STATS["pack_s"] += t1 - t0
        STATS["k2_s"] += time.time() - t1
        STATS["rescue_rows"] += len(rr)
        err = big.copy()
        lim = np.ceil(rl * rescue_err).astype(np.int64)
        ok = res_err <= lim
        err[np.flatnonzero(have)[ok]] = res_err[ok]
        return err

    def _flush():
        nonlocal n_rescued
        if not buf:
            return
        L = max(len(r) for rr in buf for r in rr)
        Nn = len(buf)
        mat = np.full((2 * Nn, L), 4, np.uint8)
        for i, (r1, r2) in enumerate(buf):
            mat[2 * i, :len(r1)] = r1
            mat[2 * i + 1, :len(r2)] = r2
        t0 = time.time()
        uid, pos, cands = _vote_place_batch(index, mat, k)
        STATS["vote_s"] += time.time() - t0
        if utg_seqs is not None:
            miss = np.flatnonzero((uid < 0) & (cands[:, 0, 0] >= 0))
            if len(miss):
                e1 = _align_cands(mat, miss, 0, cands)
                e2 = _align_cands(mat, miss, 1, cands)
                big = 1 << 30
                pick = np.where(e1 <= e2, 0, 1)
                best = np.minimum(e1, e2)
                other = np.maximum(e1, e2)
                # accept when aligned under the error cap AND strictly
                # better than the runner-up (haplotype-decisive)
                good = (best < big) & ((other == big) | (best < other))
                acc = miss[good]
                pk = pick[good]
                uid[acc] = cands[acc, pk, 0]
                pos[acc] = np.maximum(cands[acc, pk, 1], 0) + k - 1
                n_rescued += int(good.sum())
        u1, p1 = uid[0::2], pos[0::2]
        u2, p2 = uid[1::2], pos[1::2]
        both = (u1 >= 0) & (u2 >= 0)
        out.append(np.stack([u1[both], p1[both], u2[both], p2[both]],
                            axis=1))
        STATS["pairs"] += Nn
        buf.clear()

    for r1, r2 in pairs:
        buf.append((np.asarray(r1, np.uint8), np.asarray(r2, np.uint8)))
        if len(buf) >= batch:
            _flush()
    _flush()
    hits = (np.concatenate(out, axis=0) if out
            else np.zeros((0, 4), np.int64)).astype(np.int64)
    STATS["hits"] += len(hits)
    STATS["rescued"] += n_rescued
    log("map_hic_pairs_pos", f"{len(hits)} positioned PE hits "
        f"(batched; {n_rescued} ends seed-extend rescued)")
    return hits
