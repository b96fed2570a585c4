"""Consensus on the host: applying the column decisions, and the DAG
pass over ambiguity clusters.

Re-expresses the tail of ``wcns_gen`` (ecovlp.cpp:2293): DeviceEC
(ec/device_ec.py) decides every column on the device (substitution,
deletion, insertion-after, with confirmed het sites never corrected) and
``consensus_apply`` builds the corrected read from those decisions.
Columns that the vote cannot decide group into ambiguity clusters
(``_ambiguity_clusters``); each cluster is resolved by the strings the
cis overlaps' tracebacks imply over it (``dag_cluster_consensus``: exact
plurality, else a star MSA onto the plurality backbone), which stands in
for the reference's DAG consensus (Merge_DAGCon, Correct.cpp:5031).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hifiasm_tpu_torch.ec.window_align import OverlapTracebacks

MAX_INS_TRACK = 8


@dataclass
class ConsensusResult:
    seq: np.ndarray          # corrected codes
    n_corrected: int         # number of edit operations applied
    # length-changing edits as (pos, delta) int64 arrays: original
    # coordinates >= pos shift by the cumulative delta.  The coordinate
    # trace that lets overlap records survive correction without a
    # realign pass (~the reference's scc edit traces consumed by
    # adjust_exact_match, ecovlp.cpp:3521)
    edits: tuple = (np.zeros(0, np.int64), np.zeros(0, np.int64))


def _edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein on tiny cluster ranges (tens of bases)."""
    prev = np.arange(len(b) + 1, dtype=np.int64)
    for i in range(1, len(a) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        for j in range(1, len(b) + 1):
            cur[j] = min(sub[j - 1], prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return int(prev[-1])


def consensus_apply(q: np.ndarray, pass_sub: np.ndarray,
                    pass_ins: np.ndarray, winner: np.ndarray,
                    ins_base: np.ndarray, ins_len: np.ndarray,
                    repl=None) -> ConsensusResult:
    """Assemble the corrected sequence from per-column decisions (made on
    the device) and the DAG pass's cluster replacements ``repl``, a list
    of (start, end, replacement); column edits inside a replaced range
    are suppressed."""
    pass_sub = pass_sub.copy()
    pass_ins = pass_ins.copy()
    repl = sorted(repl) if repl else []
    for s, e, _ in repl:
        pass_sub[s:e] = False
        pass_ins[s:e] = False

    change = np.flatnonzero(pass_sub | pass_ins)
    if len(change) == 0 and not repl:
        return ConsensusResult(q.copy(), 0)
    parts = []
    n_edits = 0
    prev = 0
    ci, ri = 0, 0
    ed_pos, ed_delta = [], []
    while ci < len(change) or ri < len(repl):
        if ri < len(repl) and (ci >= len(change)
                               or repl[ri][0] <= change[ci]):
            s, e, r = repl[ri]
            ri += 1
            parts.append(q[prev:s])
            parts.append(np.asarray(r, np.uint8))
            n_edits += _edit_distance(np.clip(q[s:e], 0, 3),
                                      np.asarray(r, np.uint8))
            if len(r) != e - s:
                ed_pos.append(e)
                ed_delta.append(len(r) - (e - s))
            prev = e
            continue
        p = change[ci]
        ci += 1
        parts.append(q[prev:p])
        if pass_sub[p]:
            w = int(winner[p])
            if w != 4:                       # substitution
                parts.append(np.array([w], np.uint8))
            else:                            # deletion of the query base
                ed_pos.append(p + 1)
                ed_delta.append(-1)
            n_edits += 1
        else:
            parts.append(q[p:p + 1])
        if pass_ins[p]:
            parts.append(np.full(int(ins_len[p]), ins_base[p], np.uint8))
            n_edits += int(ins_len[p])
            ed_pos.append(p + 1)
            ed_delta.append(int(ins_len[p]))
        prev = p + 1
    parts.append(q[prev:])
    return ConsensusResult(np.concatenate(parts).astype(np.uint8), n_edits,
                           (np.asarray(ed_pos, np.int64),
                            np.asarray(ed_delta, np.int64)))


DAG_CLUSTER_GAP = 8               # max spacing joining ambiguous columns


def _ambiguity_clusters(amb: np.ndarray, gap: int = DAG_CLUSTER_GAP,
                        min_size: int = 1):
    """Group ambiguous columns within ``gap`` bp; singletons are left to
    the (conservative) column vote. Returns [(start, end)) ranges."""
    pos = np.flatnonzero(amb)
    if len(pos) < min_size:
        return []
    breaks = np.flatnonzero(np.diff(pos) > gap)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [len(pos) - 1]])
    return [(int(pos[s]), int(pos[e]) + 1)
            for s, e in zip(starts, ends) if e - s + 1 >= min_size]


def _implied_string(tb: np.ndarray, ic: np.ndarray, ib: np.ndarray) -> bytes:
    """The subsequence an overlap's traceback implies for a query range."""
    parts = []
    for v, c, b in zip(tb, ic, ib):
        if v <= 3:
            parts.append(int(v))
        # v == 4: query base deleted in the target
        if c > 0:
            parts.extend([int(b) if b <= 3 else 3] * int(min(c, MAX_INS_TRACK)))
    return bytes(parts)


MSA_MAX_BACKBONE = 64
MSA_MAX_VOTER = 128
# a cluster is voted on by at least OCC_TOT strings, and a string or a
# column wins with more than OCC_EXACT of them
OCC_TOT = 3
OCC_EXACT = 0.500001


def _ins_bundle_walk(ins_i: dict, n_voters: int, occ_exact: float
                     ) -> bytes:
    """Partial-order bundle walk over an insertion-vote dict
    {string: count}: emit the longest prefix every additional symbol of
    which keeps support above ``occ_exact * n_voters``.

    This is the Merge_DAGCon bundle merge (Correct.cpp:5031) for
    competing/NESTED insertion bundles: homopolymer-length noise yields
    voters like {'A': 3, 'AA': 3, 'AAA': 2} whose exact-string counts
    all miss plurality, while the shared first symbol carries weight 8
    and the second 5 — the graph path, not the string identity, is what
    the voters agree on.  Deterministic: symbol ties pick the smallest
    symbol (matching the column rule); the native mirror walks the same
    order."""
    out = bytearray()
    while True:
        pfx = bytes(out)
        k = len(pfx)
        wt: dict = {}
        for s, c in ins_i.items():
            if len(s) > k and s[:k] == pfx:
                wt[s[k]] = wt.get(s[k], 0) + c
        if not wt:
            break
        mx = max(wt.values())
        if not (mx > occ_exact * n_voters):
            break
        out.append(min(b for b, c in wt.items() if c == mx))
    return bytes(out)


def _star_msa_consensus(strs, backbone: bytes, occ_exact: float):
    """Column-wise consensus after realigning every voter string onto
    the plurality backbone (the Merge_DAGCon role, Correct.cpp:5031 /
    POA.cpp: the reference accumulates voters in a partial-order graph
    and walks the heaviest bundle; the star alignment onto the plurality
    backbone is the rank-1 version of that graph).  Used when no EXACT
    string reaches plurality — voters carrying one residual error each
    still agree column by column.  Deterministic: edit-DP traceback
    prefers diagonal > up > left; column ties prefer the smallest
    symbol; insertion ties the smallest string."""
    n = len(strs)
    B = len(backbone)
    if B == 0 or B > MSA_MAX_BACKBONE:
        return None
    bb = np.frombuffer(backbone, np.uint8)
    sub = np.zeros((B, 5), np.int64)            # base 0..3, 4 = deleted
    ins: list = [dict() for _ in range(B + 1)]  # before backbone pos i
    # backbone homopolymer runs, for the deletion-bundle
    # canonicalization below (~the same-base node merging of
    # Merge_DAGCon, Correct.cpp:4700,4806): per VOTER, count symbols
    # emitted inside each run — placement-invariant, so voters whose
    # private errors shift the DP's in-run deletion column still agree
    # on the emitted run LENGTH
    run_id = np.concatenate([[0], np.cumsum(bb[1:] != bb[:-1])]) \
        if B else np.zeros(0, np.int64)
    n_runs = int(run_id[-1]) + 1 if B else 0
    run_len = np.bincount(run_id, minlength=n_runs)
    run_sup: list = [dict() for _ in range(n_runs)]  # L_v -> #voters

    def _run_vote(lv):
        for r in range(n_runs):
            k = int(lv[r])
            run_sup[r][k] = run_sup[r].get(k, 0) + 1

    for s in strs:
        if len(s) > MSA_MAX_VOTER:
            return None
        if s == backbone:
            sub[np.arange(B), bb] += 1
            _run_vote(run_len)
            continue
        sv = np.frombuffer(s, np.uint8)
        m = len(sv)
        dp = np.zeros((B + 1, m + 1), np.int64)
        dp[0, :] = np.arange(m + 1)
        dp[:, 0] = np.arange(B + 1)
        for i in range(1, B + 1):
            ne = (sv != bb[i - 1]).astype(np.int64)
            row = dp[i]
            prev = dp[i - 1]
            for j in range(1, m + 1):
                d = prev[j - 1] + ne[j - 1]
                u = prev[j] + 1
                l_ = row[j - 1] + 1
                row[j] = d if d <= u and d <= l_ else \
                    (u if u <= l_ else l_)
        i, j = B, m

        def _flush(pend, at):
            if pend:
                key = bytes(reversed(pend))
                ins[at][key] = ins[at].get(key, 0) + 1
            return []

        pend: list = []                   # reversed insertion collector
        lv = np.zeros(n_runs, np.int64)
        while i > 0 or j > 0:
            if i > 0 and j > 0 and \
                    dp[i][j] == dp[i - 1][j - 1] + (sv[j - 1] != bb[i - 1]):
                pend = _flush(pend, i)
                sub[i - 1][sv[j - 1]] += 1
                lv[run_id[i - 1]] += 1
                i -= 1
                j -= 1
            elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
                pend = _flush(pend, i)
                sub[i - 1][4] += 1
                i -= 1
            else:
                pend.append(int(sv[j - 1]))
                j -= 1
        _flush(pend, 0)
        _run_vote(lv)
    # deletion-bundle canonicalization per homopolymer run: a run is
    # canonicalized when nothing but its own base (or deletion) wins any
    # of its columns and no insertion lands strictly inside it; the kept
    # length walks down from the backbone length, deleting the k-th
    # symbol only when the voters emitting < k symbols clear the same
    # occ threshold a column deletion needs.  Voters whose private
    # errors shifted their in-run deletion to a different column agree
    # here even though the per-column 'del' votes are spread too thin.
    run_start = np.concatenate([[0], np.cumsum(run_len)[:-1]]) \
        if n_runs else np.zeros(0, np.int64)
    canon = np.zeros(n_runs, bool)
    keep_len = np.zeros(n_runs, np.int64)
    for r in range(n_runs):
        R = int(run_len[r])
        if R < 2:
            continue
        i0 = int(run_start[r])
        if any(ins[i] for i in range(i0 + 1, i0 + R)):
            continue
        b_r = int(bb[i0])
        ok = True
        for i in range(i0, i0 + R):
            col = sub[i]
            winner = int(np.argmax(col))
            if winner not in (b_r, 4) and col[winner] > occ_exact * n:
                ok = False
                break
        if not ok:
            continue
        sup = run_sup[r]
        kept = 0
        for k in range(1, R + 1):
            ge_k = sum(c for L, c in sup.items() if L >= k)
            if not ((n - ge_k) > occ_exact * n):
                kept += 1
        canon[r] = True
        keep_len[r] = kept
    out = []
    for i in range(B + 1):
        if ins[i]:
            out.extend(_ins_bundle_walk(ins[i], n, occ_exact))
        if i < B:
            r = int(run_id[i])
            if canon[r]:
                if i == int(run_start[r]):
                    out.extend([int(bb[i])] * int(keep_len[r]))
                continue
            col = sub[i]
            winner = int(np.argmax(col))      # ties -> smallest symbol
            if col[winner] > occ_exact * n:
                if winner != 4:
                    out.append(winner)
            else:
                out.append(int(bb[i]))
    return bytes(out)


def cluster_range(q: np.ndarray, cs: int, ce: int):
    """The query range [cs, ce) whose strings vote on a cluster: the
    cluster with a small context so flanking agreement anchors the
    strings, then extended to homopolymer-run boundaries (capped): an
    indel's placement within a run is alignment-ambiguous, so voters that
    put the extra/missing base at the run's far end only agree with the
    rest if the strings span the WHOLE run (the POA bundle spans it by
    construction, Correct.cpp:5031)."""
    cs = max(0, cs - 2)
    ce = min(len(q), ce + 2)
    ext = 0
    while cs > 0 and q[cs - 1] == q[cs] and ext < 12:
        cs -= 1
        ext += 1
    ext = 0
    while ce < len(q) and q[ce] == q[ce - 1] and ext < 12:
        ce += 1
        ext += 1
    return cs, ce


def dag_cluster_consensus(q: np.ndarray, tbs: OverlapTracebacks,
                          cis_idx: np.ndarray, clusters,
                          het_sites=None, occ_tot: int = OCC_TOT,
                          occ_exact: float = OCC_EXACT):
    """Sequence-level consensus over ambiguous clusters (~the reference's
    DAG consensus, Merge_DAGCon Correct.cpp:5031 / POA.cpp): each cis
    overlap votes with the exact subsequence its traceback implies for
    the cluster; the plurality string wins under the same occ thresholds
    as the column vote.  When no exact string reaches plurality, voters
    REALIGN onto the plurality backbone and vote column-wise
    (_star_msa_consensus) — resolving clusters where every voter carries
    its own residual error.  Returns [(start, end, replacement)]."""
    repl = []
    het = set(int(h) for h in het_sites) if het_sites is not None else set()
    for cs, ce in clusters:
        cs, ce = cluster_range(q, cs, ce)
        if any(p in het for p in range(cs, ce)):
            continue                      # never rewrite het evidence
        counts = {}
        strs = []
        for o in cis_idx:
            xs = int(tbs.x_s[o])
            n = int(tbs.off[o + 1] - tbs.off[o])
            if xs > cs or xs + n < ce:
                continue
            lo, hi = cs - xs, ce - xs
            tb = tbs.view(o, "tb")[lo:hi]
            if (tb > 4).any():
                continue                  # window not aligned here
            key = _implied_string(tb, tbs.view(o, "ins_cnt")[lo:hi],
                                  tbs.view(o, "ins_base")[lo:hi])
            counts[key] = counts.get(key, 0) + 1
            strs.append(key)
        qkey = np.clip(q[cs:ce], 0, 3).astype(np.uint8).tobytes()
        counts[qkey] = counts.get(qkey, 0) + 1
        strs.append(qkey)
        n_voters = len(strs)
        if n_voters < occ_tot:
            continue
        maxc = max(counts.values())
        best = min(s for s, c in counts.items() if c == maxc)
        if counts[best] > occ_exact * n_voters:
            if best != qkey:
                repl.append((cs, ce, np.frombuffer(best, np.uint8)))
            continue
        cons = _star_msa_consensus(sorted(strs), best, occ_exact)
        if cons is not None and len(cons) and cons != qkey:
            repl.append((cs, ce, np.frombuffer(cons, np.uint8)))
    return repl
