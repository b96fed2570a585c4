"""Ultralong ONT integration — the "double graph" (inter.cpp).

Re-expresses the core of ``ul_load``/``scall_ul_pipeline``
(inter.cpp:21693, :19992): ultralong reads are mapped to the HiFi unitig
graph with a k=19/w=19 HPC minimizer index (``ul_map_lchain``
anchor.cpp:2287), linear chains per unitig are stitched into a PATH of
unitigs through the graph (``gl_chain_refine_advance`` graph-DP), and each
UL read becomes a vector of oriented unitig intervals (``uc_block_t``,
Process_Read.h:169-175).  The paths then (a) deposit ``ou`` coverage on
arcs, protecting them in cleaning (Overlaps.h:195), and (b) bridge unitig
pairs that UL reads traverse but the HiFi graph does not connect
(``rescue_src_ul``/``gradually_renew_g``, Overlaps.cpp:39190,39297).

The port of hifiasm_tpu/ul.py.  Its two base-level checks, the per-chain
WINDOW_UL screen and the graph DP's junction check, score on K2
(``ul_band_err`` -> ops/banded_fwd.banded_forward) on the caller's
device: the kernel for ``cuda``, its plain version for ``cpu``; both
give the err of ``banded_batch_np(..., traceback=False)``, which the
JAX package calls on the host, one chain or one junction at a time.
Here the screen windows of every candidate chain of every read of a
mapping pass go to K2 together (chunks of ``MAX_ROWS``), and the
junction rows of one DP row go together, one call per band width.
Each row's err depends on that row alone, so the paths are the JAX
package's.  Everything else is a host copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from hifiasm_tpu_torch.device import resolve_device
from hifiasm_tpu_torch.graph.tovlp import _reach_starts, _utg_adj
from hifiasm_tpu_torch.graph.unitig import UnitigGraph
from hifiasm_tpu_torch.index.pos_table import build_position_table
from hifiasm_tpu_torch.ops.chain import ChainParams
from hifiasm_tpu_torch.overlap.anchors import chain_many, collect_anchors
from hifiasm_tpu_torch.ops.sketch import sketch_read
from hifiasm_tpu_torch.utils import trace
from hifiasm_tpu_torch.utils.logging import log

UL_K = 19
UL_W = 19
WINDOW_UL = 75          # Hash_Table.h:26
UL_ERR_RATE = 0.2
SCREEN_E = max(2, int(WINDOW_UL * UL_ERR_RATE))
MAX_ROWS = 65536        # rows of one K2 call

# counters and wall seconds since the last reset, over every mapping pass
# (``ul_align`` and the re-map of ``ul_realign_renewed``): reads, mapped
# reads and blocks per pass; screen and junction rows and K2 calls;
# chain_s is sketch + anchors + linear chains, pack_s the host packing of
# both checks' rows, k2_s their K2 calls (upload, kernel, fetch), dp_s
# the graph DP without its junction packing and K2, and correct_s,
# refine_s, renew_s (renewal and the drop ladder) and fill_s the host
# stages after mapping
STATS = trace.register("ul", {
    "passes": 0, "reads": 0, "mapped": 0, "blocks": 0, "screen_rows": 0,
    "screen_launches": 0, "junction_rows": 0, "junction_launches": 0,
    "chain_s": 0.0, "pack_s": 0.0, "k2_s": 0.0, "dp_s": 0.0,
    "correct_s": 0.0, "refine_s": 0.0, "renew_s": 0.0, "fill_s": 0.0})


def ul_band_err(X: np.ndarray, xl: np.ndarray, Y: np.ndarray,
                yl: np.ndarray, e: int, device="cuda") -> np.ndarray:
    """err of the banded forward scan for packed rows, by K2 on
    ``device`` (the kernel for cuda, its plain version for cpu):
    ``banded_batch_np(X, xl, Y, yl, e, traceback=False).err``, -1 past
    ``e`` errors.  int64 [n] on the host.  The UL checks call it as a
    module global, so a caller can watch their batches."""
    from hifiasm_tpu_torch.ops.banded_fwd import banded_err_np

    return banded_err_np(X, xl, Y, yl, e, device)


def _score_rows(rows, e: int, device, kind: str) -> np.ndarray:
    """err of each (x, y, ylen) row at band ``e``: rows padded with code
    4 to the longest x (y to that + 2e), sent to ``ul_band_err`` in
    chunks of at most MAX_ROWS; ``kind`` names the STATS counters."""
    out = []
    for c0 in range(0, len(rows), MAX_ROWS):
        part = rows[c0:c0 + MAX_ROWS]
        with trace.span(None, STATS, "pack_s"):
            XL = max(len(x) for x, _, _ in part)
            X = np.full((len(part), XL), 4, np.uint8)
            Y = np.full((len(part), XL + 2 * e), 4, np.uint8)
            xl = np.zeros(len(part), np.int64)
            yl = np.zeros(len(part), np.int64)
            for j, (x, y, m) in enumerate(part):
                X[j, :len(x)] = x
                Y[j, :len(y)] = y
                xl[j], yl[j] = len(x), m
        with trace.span(None, STATS, "k2_s"):
            out.append(ul_band_err(X, xl, Y, yl, e, device))
        STATS[f"{kind}_rows"] += len(part)
        STATS[f"{kind}_launches"] += 1
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _screen_rows(ul: np.ndarray, tgt: np.ndarray, hit_self, hit_t,
                 max_windows: int = 8):
    """The (x, y, ylen) rows of a UL block's spot check (~the
    WINDOW_UL=75 verification of scall_ul_pipeline, inter.cpp:19992):
    short windows anchored at chain hits, the target starting e bases
    before the hit (code 4 where that lies before the unitig's start).
    Windows under 20 bp, or with no target base, are left out."""
    n = len(hit_self)
    if n == 0:
        return []
    sel = np.linspace(0, n - 1, min(max_windows, n)).astype(np.int64)
    e = SCREEN_E
    rows = []
    for h in sel:
        q0 = int(hit_self[h])
        t0 = int(hit_t[h])
        xw = ul[q0:q0 + WINDOW_UL]
        if len(xw) < 20:
            continue
        y0 = t0 - e
        seg = np.full(len(xw) + 2 * e, 4, np.uint8)
        s_lo, s_hi = max(0, y0), min(len(tgt), y0 + len(xw) + 2 * e)
        if s_hi <= s_lo:
            continue
        seg[s_lo - y0:s_hi - y0] = tgt[s_lo:s_hi]
        rows.append((xw, seg, s_hi - y0))
    return rows


def _screen_pass(err: np.ndarray, min_pass: float) -> bool:
    """A block passes when at least ``min_pass`` of its kept windows
    align within the band; a block with no window fails."""
    return len(err) > 0 and float((err >= 0).mean()) >= min_pass


def _screen_chains(items, utg_seqs, device) -> List[np.ndarray]:
    """Window errs of many chains in one packed K2 pass: ``items`` holds
    (ul, ov, o) triples; returns each chain's err array (empty when it
    has no window).  Reverse-strand targets are complemented once per
    unitig."""
    from hifiasm_tpu_torch.io.readstore import revcomp_codes

    rc: Dict[int, np.ndarray] = {}
    rows, cuts = [], [0]
    for ul, ov, o in items:
        uid = int(ov.y_id[o])
        tgt = utg_seqs[uid]
        if ov.rev[o]:
            if uid not in rc:
                rc[uid] = revcomp_codes(tgt)
            tgt = rc[uid]
        h0 = ov.hit_start[o]
        rows += _screen_rows(ul, tgt, ov.hit_self[h0:h0 + ov.n_hits[o]],
                             ov.hit_t[h0:h0 + ov.n_hits[o]])
        cuts.append(len(rows))
    err = _score_rows(rows, SCREEN_E, device, "screen")
    return [err[a:b] for a, b in zip(cuts, cuts[1:])]


@dataclass
class ULPath:
    """One UL read's traversal: oriented unitigs in read order."""

    blocks: List[Tuple[int, int, int, int]]  # (uid, rev, q_start, q_end)


@dataclass
class ULStore:
    """HPC-compressed UL read store (~``all_ul_t``, Process_Read.h:169 /
    inter.cpp's HPC UL pipeline): ONT error is dominated by homopolymer
    length noise, so mapping runs in compressed space and coordinates
    convert back to raw via the per-run ``raw_end`` maps."""

    hpc: List[np.ndarray]        # compressed codes per read
    raw_end: List[np.ndarray]    # raw index of each run's LAST base
    run_len: List[np.ndarray]
    raw_len: List[int]

    @classmethod
    def build(cls, raw_reads: List[np.ndarray]) -> "ULStore":
        from hifiasm_tpu_torch.io.readstore import hpc_compress

        hpc, ends, runs, lens = [], [], [], []
        for r in raw_reads:
            c, e, rl = hpc_compress(r)
            hpc.append(c)
            ends.append(e)
            runs.append(rl)
            lens.append(len(r))
        return cls(hpc, ends, runs, lens)

    def raw_start(self, i: int, p: int) -> int:
        """Raw coordinate of compressed position p's run START."""
        e, rl = self.raw_end[i], self.run_len[i]
        if len(e) == 0:
            return 0
        p = min(max(p, 0), len(e) - 1)
        return int(e[p] - rl[p] + 1)

    def raw_stop(self, i: int, p: int) -> int:
        """Raw coordinate one past compressed position p's run end."""
        e = self.raw_end[i]
        if len(e) == 0:
            return 0
        p = min(max(p, 0), len(e) - 1)
        return int(e[p] + 1)


def _splice_junction(utg_seqs, utg_lens, vj: int, re_j: int, vi: int,
                     rs_i: int, mids: List[int], ols: List[int]
                     ) -> np.ndarray:
    """Oriented target sequence from position re_j on vj to rs_i on vi,
    walking the arc path (mids = intermediate vertices, ols = per-hop
    overlaps into each next vertex)."""
    from hifiasm_tpu_torch.io.readstore import revcomp_codes

    def seq_of(v):
        s = utg_seqs[v >> 1]
        return revcomp_codes(s) if (v & 1) else s

    parts = [seq_of(vj)[re_j:]]
    path = mids + [vi]
    for idx, (v, ol) in enumerate(zip(path, ols)):
        s = seq_of(v)
        # last hop: run a margin past rs_i so junction windows that
        # extend into vi have target sequence to align against
        end = len(s) if idx < len(path) - 1 else min(len(s), rs_i + 200)
        if ol < end:
            parts.append(s[ol:end])
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def graph_chain_paths(ov, ug: UnitigGraph, utg_seqs, utg_lens, ul,
                      min_chain_score: int = 8, bw: int = 400,
                      diff: float = UL_ERR_RATE, ol_tol: int = 400,
                      device="cuda") -> List[Tuple[int, int, int, int]]:
    """Graph-chaining DP over per-unitig linear chains
    (~gl_chain_graph / gl_chain_refine_advance, inter.cpp:5785, :4334).

    Chains sort by query end; each chain may extend a predecessor whose
    read gap is consistent with a bounded shortest path through the
    unitig graph (the junction distance check of hc_target_len +
    hc_shortest_k); junction-crossing transitions are verified at base
    level on the spliced target.  The best-scoring chain backtracks into
    one path of oriented unitigs, inserting anchor-less junction unitigs
    the path traverses.  The junction checks a DP row may need score on
    K2 on ``device`` before its accept loop, one call per band width."""
    sel = np.flatnonzero(ov.score >= min_chain_score)
    if len(sel) == 0:
        return []
    k2_0 = STATS["pack_s"] + STATS["k2_s"]
    with trace.span(None) as dp:
        order = sel[np.lexsort((ov.x_s[sel], ov.x_e[sel]))]
        n = len(order)
        v = (ov.y_id[order].astype(np.int64) << 1) | ov.rev[order]
        qs = ov.x_s[order].astype(np.int64)
        qe = ov.x_e[order].astype(np.int64)
        rs = ov.y_s[order].astype(np.int64)
        re_ = ov.y_e[order].astype(np.int64)
        sc = ov.score[order].astype(np.int64)

        adj = _utg_adj(ug)
        f = sc.copy()
        par = np.full(n, -1, np.int64)
        trans_mid: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {}
        reach_cache: Dict[Tuple[int, int], dict] = {}
        verify_cache: Dict[Tuple[int, int], bool] = {}

        def _junction_row(j: int, i: int, mids, ols):
            """(x, y, ylen, e) of the base-level spot check across the
            junction j -> i, or None when it fails without an alignment: a
            fixed 140 bp window starting just before the jump
            (WINDOW_UL-style budget; the band must fit the uint64 Myers
            lane, so e <= 31)."""
            lo = max(int(qe[j]) - 40, 0)
            hi = min(lo + 140, len(ul))
            x = ul[lo:hi]
            if len(x) < 20:
                return None
            e = min(31, max(8, int(len(x) * diff)))
            # target starts e bases BEFORE x's expected position (the
            # engine's band convention, see _screen_rows)
            tgt = _splice_junction(
                utg_seqs, utg_lens, int(v[j]),
                max(int(re_[j]) - (int(qe[j]) - lo) - e, 0), int(v[i]),
                int(rs[i]), mids, ols)
            if len(tgt) == 0:
                return None
            m = min(len(tgt), len(x) + 2 * e)
            return x, tgt[:m], m, e

        def _check_junctions(i: int, cands) -> None:
            """Fill verify_cache for every junction the accept loop of row
            ``i`` may test: the candidates before the first one it takes
            without a check (a bridge or a same-unitig step)."""
            by_e: Dict[int, list] = {}
            for _, j, mids, ols, is_bridge in cands:
                if is_bridge or v[j] == v[i]:
                    break
                if (j, i) in verify_cache:
                    continue
                row = _junction_row(j, i, mids, ols)
                if row is None:
                    verify_cache[(j, i)] = False
                else:
                    by_e.setdefault(row[3], []).append(((j, i), row[:3]))
            for e, items in by_e.items():
                err = _score_rows([r for _, r in items], e, device, "junction")
                for (key, _), ev in zip(items, err.tolist()):
                    verify_cache[key] = ev >= 0

        # scale bounds (~the max_skip/max_dist cuts of the reference's
        # linear chaining, inter.cpp:5785): predecessors further back than
        # MAX_QGAP on the read can never chain (bridges cap at 50 kb), and
        # at most MAX_CANDS surviving predecessors are examined per chain —
        # these turn the O(n^2) DP into O(n * K) at genome-scale UL depth
        MAX_QGAP = 100_000
        MAX_CANDS = 64
        for i in range(n):
            # vectorized predecessor prefilter over the qgap-bounded window
            # (qe is sorted ascending, so the window is a searchsorted cut)
            lo = int(np.searchsorted(qe[:i], qs[i] - MAX_QGAP, side="left"))
            jj = np.arange(lo, i)
            pre = (qs[jj] < qs[i]) & (qe[jj] <= qe[i]) & \
                (qs[i] - qe[jj] >= -ol_tol)
            jwin = jj[pre][::-1][:MAX_CANDS]
            cands = []
            for j in jwin.tolist():
                qgap = int(qs[i] - qe[j])
                mids: List[int] = []
                ols: List[int] = []
                if v[j] == v[i]:
                    gdist = int(rs[i] - re_[j])
                    if gdist < -ol_tol:
                        continue
                else:
                    tail = int(utg_lens[int(v[j]) >> 1] - re_[j])
                    cap = int(max(qgap, 0) * (1.0 + diff)) + bw
                    # quantize the BFS cap so the reach cache hits across
                    # nearby qgaps; exactness is restored by the ds <= cap
                    # check below
                    cap_q = 1 << max(int(cap).bit_length(), 8)
                    ck = (int(v[j]), cap_q)
                    if ck not in reach_cache:
                        reach_cache[ck] = _reach_starts(adj, utg_lens,
                                                        int(v[j]), cap_q)
                    reach = reach_cache[ck]
                    if int(v[i]) not in reach or \
                            reach[int(v[i])][0] > cap:
                        # graph-disconnected jump (the UL read evidences an
                        # adjacency the HiFi graph lacks): allow a penalized
                        # "bridge" transition — these consecutive blocks are
                        # exactly what ul_bridge_arcs/ul_fill_bridged consume
                        # (~the dead-end jumps of gl_chain, inter.cpp:5785)
                        if qgap > 50000:
                            continue
                        cand_sc = int(f[j] + sc[i]
                                      - max(8, qgap // 256))
                        if cand_sc > f[i]:
                            cands.append((cand_sc, j, [], [], True))
                        continue
                    ds, _ = reach[int(v[i])]
                    gdist = tail + ds + int(rs[i])
                    # reconstruct intermediate vertices (end to start)
                    mids_r = []
                    ols_r = []
                    cur = int(v[i])
                    while True:
                        dsc, prev = reach[cur]
                        nxt = int(v[j]) if prev == -1 else prev
                        # overlap into cur on the chosen hop
                        olv = 0
                        for w, o in adj.get(nxt, []):
                            if w == cur:
                                olv = o
                                break
                        ols_r.append(olv)
                        if prev == -1:
                            break
                        mids_r.append(prev)
                        cur = prev
                    mids = mids_r[::-1]
                    ols = ols_r[::-1]
                pen = abs(gdist - qgap)
                if pen > bw + diff * max(qgap, gdist, 0):
                    continue
                cand_sc = int(f[j] + sc[i] - pen // 32)
                if cand_sc > f[i]:
                    cands.append((cand_sc, j, mids, ols, False))
            cands.sort(key=lambda c: (-c[0], c[1]))
            _check_junctions(i, cands)
            for cand_sc, j, mids, ols, is_bridge in cands:
                if cand_sc <= f[i]:
                    break
                if not is_bridge and v[j] != v[i] and \
                        not verify_cache[(j, i)]:
                    continue
                f[i] = cand_sc
                par[i] = j
                trans_mid[(j, i)] = (mids, ols)
                break

        best = int(np.argmax(f))
        chain_idx = []
        cur = best
        while cur >= 0:
            chain_idx.append(cur)
            cur = int(par[cur])
        chain_idx.reverse()

        blocks: List[Tuple[int, int, int, int]] = []
        for a, b in zip([None] + chain_idx[:-1], chain_idx):
            if a is not None:
                mids, _ = trans_mid.get((a, b), ([], []))
                qgap = max(int(qs[b] - qe[a]), 0)
                for m_i, mv in enumerate(mids):
                    qm = int(qe[a]) + (qgap * (m_i + 1)) // (len(mids) + 1)
                    blocks.append((mv >> 1, mv & 1, qm, qm))
            blocks.append((int(v[b]) >> 1, int(v[b]) & 1, int(qs[b]),
                           int(qe[b])))
    # the DP's own seconds: its junction packing and K2 count apart
    STATS["dp_s"] += dp.s - (STATS["pack_s"] + STATS["k2_s"] - k2_0)
    return blocks


def _path_coverage(blocks, rlen: int) -> float:
    """Fraction of the read covered by the union of block q-intervals."""
    if not blocks or rlen <= 0:
        return 0.0
    iv = sorted((qs, qe) for _, _, qs, qe in blocks if qe > qs)
    cov, cur_s, cur_e = 0, -1, -1
    for s, e in iv:
        if s > cur_e:
            cov += max(cur_e - cur_s, 0)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    cov += max(cur_e - cur_s, 0)
    return cov / rlen


def graph_chain_refine(ul: np.ndarray, ov, ok_idx, rej_idx, low_idx,
                       ug: UnitigGraph, utg_seqs, utg_lens,
                       min_chain_score: int = 8, rounds: int = 3,
                       cov_bar: float = 0.7, device="cuda",
                       screen: Dict[int, np.ndarray] = None
                       ) -> List[Tuple[int, int, int, int]]:
    """Multi-round graph-chain refinement (~``gl_chain_refine_advance``
    / ``gl_chain_refine``, inter.cpp:4334, :5123): the reference runs
    the graph DP three times, each round widening the candidate set for
    read regions the current path leaves uncovered.

    Round 1 chains the strictly-verified candidates.  When path
    coverage stays under ``cov_bar`` (the ``ff_chain`` acceptance bar,
    inter.cpp:5123's 0.7 primary-coverage cut), round 2 RESCUES chains
    that failed the strict base-level screen, re-verifying them at a
    relaxed pass fraction (repeat-divergent copies fail 0.6 but clear
    0.35), and re-runs the whole DP so transitions through the rescued
    chains compete fairly.  Round 3 additionally admits low-score
    chains (>= half the score floor) under the same relaxed screen —
    the tangle-crossing fragments the quota-capped chainer down-ranks.

    ``screen`` maps a chain to its screen windows' err (``ul_align``
    passes the packed screen's): a rescue re-verifies the same windows,
    so it reads them there and scores only chains missing from it, in
    one K2 pass on ``device``.
    """
    screen = {} if screen is None else screen

    def _chains(idx):
        return ov.take(np.asarray(sorted(idx), np.int64))

    def _rescue(cands, min_pass):
        miss = [o for o in cands if o not in screen]
        if miss:
            screen.update(zip(miss, _screen_chains(
                [(ul, ov, o) for o in miss], utg_seqs, device)))
        return [o for o in cands if _screen_pass(screen[o], min_pass)]

    live = set(ok_idx)
    if not live and not rej_idx and not low_idx:
        return []
    blocks = graph_chain_paths(_chains(live), ug, utg_seqs, utg_lens,
                               ul, min_chain_score=min_chain_score,
                               device=device) if live else []
    pools = [(rej_idx, 0.35), (low_idx, 0.35)]
    for rnd in range(1, min(rounds, len(pools) + 1)):
        if _path_coverage(blocks, len(ul)) >= cov_bar:
            break
        pool, mp = pools[rnd - 1]
        fresh = _rescue([o for o in pool if o not in live], mp)
        if not fresh:
            continue
        live.update(fresh)
        blocks = graph_chain_paths(
            _chains(live), ug, utg_seqs, utg_lens, ul,
            min_chain_score=min_chain_score if rnd < 2 else
            max(min_chain_score // 2, 4), device=device)
    return blocks


def ul_refine_blocks(paths: List[ULPath], ul_reads: List[np.ndarray],
                     utg_seqs: List[np.ndarray], pad: int = 150,
                     bw: int = 32) -> int:
    """Base-precision refinement of UL block boundaries at junctions
    (~``ul_refine_alignment``, inter.cpp): an affine-gap extension
    (ops/affine, the ksw2 analog) re-derives the exact read coordinate
    where the previous unitig's tail ends / the next unitig's head
    begins, so gap extraction and fills cut precisely.  Mutates blocks
    in place; returns #boundaries moved."""
    from hifiasm_tpu_torch.io.readstore import revcomp_codes

    with trace.span("ul.refine", STATS, "refine_s"):
        from hifiasm_tpu_torch.ops.affine import affine_extend

        def _locate(read, lo, hi, pat, min_frac=0.6):
            """Best start of ``pat`` in read[lo:hi] by sliding match count;
            (-1, 0.0) when nothing clears min_frac."""
            lo = max(lo, 0)
            hi = min(hi, len(read))
            if hi - lo < len(pat) or len(pat) == 0:
                return -1, 0.0
            win = np.lib.stride_tricks.sliding_window_view(
                read[lo:hi], len(pat))
            score = (win == pat).sum(1)
            s = int(np.argmax(score))
            frac = float(score[s]) / len(pat)
            return (lo + s, frac) if frac >= min_frac else (-1, 0.0)

        n_ref = 0
        for p, ul in zip(paths, ul_reads):
            for bi in range(len(p.blocks) - 1):
                ua, ra, qs_a, qe_a = p.blocks[bi]
                ub, rb, qs_b, qe_b = p.blocks[bi + 1]
                if qs_b <= qe_a:          # overlapping blocks: no junction
                    continue
                ta = utg_seqs[ua]
                ta = revcomp_codes(ta) if ra else ta
                pd = min(pad, max(qe_a - qs_a, 0), len(ta))
                if pd >= 32:
                    tail = ta[len(ta) - pd:]
                    # coarse: correlation-locate the tail near the claimed
                    # end; fine: affine extension polishes indel drift
                    s, frac = _locate(ul, qe_a - 2 * pad,
                                      min(qe_a + 2 * pad, qs_b) + pd, tail)
                    if s >= 0:
                        q_end, t_end, sc = affine_extend(
                            ul[s: s + pd + bw], tail, bw=bw)
                        new_qe = s + q_end + (pd - t_end) \
                            if sc > 0 and t_end >= pd - 8 else s + pd
                        if qs_a < new_qe <= qs_b:
                            if new_qe != qe_a:
                                n_ref += 1
                            p.blocks[bi] = (ua, ra, qs_a, new_qe)
                            qe_a = new_qe
                tb = utg_seqs[ub]
                tb = revcomp_codes(tb) if rb else tb
                pd = min(pad, max(qe_b - qs_b, 0), len(tb))
                if pd >= 32:
                    head = tb[:pd]
                    s, frac = _locate(ul, max(qs_b - 2 * pad, qe_a) - pd,
                                      qs_b + 2 * pad, head)
                    if s >= 0 and qe_a <= s < qe_b:
                        if s != qs_b:
                            n_ref += 1
                        p.blocks[bi + 1] = (ub, rb, s, qe_b)
        if n_ref:
            log("ul_refine_blocks", f"refined {n_ref} block boundaries")
    return n_ref


def ul_align(utg_seqs: List[np.ndarray], ul_reads: List[np.ndarray],
             k: int = UL_K, w: int = UL_W, min_chain_score: int = 8,
             hom_cov: int = 20, ug: UnitigGraph = None,
             hpc: bool = False, refine_rounds: int = 3,
             device="cuda") -> List[ULPath]:
    """Map each UL read to a path of oriented unitigs.

    Linear chains per unitig come from the shared anchor/chain machinery.
    With ``ug`` given, chains feed the graph-chaining DP
    (graph_chain_paths ~ gl_chain_refine_advance, inter.cpp:4334): the
    best path may cross unitig junctions, verified at base level, and
    picks one allele through bubbles.  Without a graph the path is the
    q-sorted sequence of non-overlapping best chains.

    ``hpc=True`` maps in homopolymer-compressed space (~the ``all_ul_t``
    HPC UL store, Process_Read.h:169): ONT homopolymer-length noise
    vanishes under compression; block coordinates convert back to raw
    via the run maps.

    The screen windows of every candidate chain of every read go to K2
    on ``device`` in one packed pass (chunks of MAX_ROWS rows); with
    ``ug`` given the low-score chains are screened too, for the
    refinement rounds' rescue."""
    dev = resolve_device(device)
    if hpc:
        us = ULStore.build(ul_reads)
        ts = ULStore.build(utg_seqs)
        ug_c = ug
        if ug is not None and len(ug.a_src):
            # arc overlaps re-expressed in compressed coordinates (the
            # graph DP's distances/splices run in HPC space)
            ol_c = []
            for d, ol in zip(ug.a_dst, ug.a_ol):
                uid, rdir = int(d) >> 1, int(d) & 1
                ol = int(ol)
                re_, rl = ts.raw_end[uid], ts.run_len[uid]
                if ol <= 0 or len(re_) == 0:
                    ol_c.append(max(ol, 0))
                elif rdir == 0:
                    ol_c.append(int(np.searchsorted(re_, ol)))
                else:
                    starts = re_ - rl + 1
                    ol_c.append(len(re_) - int(np.searchsorted(
                        starts, ts.raw_len[uid] - ol)))
            ug_c = UnitigGraph(utgs=ug.utgs, a_src=ug.a_src,
                               a_dst=ug.a_dst,
                               a_ol=np.array(ol_c, np.int64))
        paths = ul_align(ts.hpc, us.hpc, k, w, min_chain_score,
                         hom_cov, ug_c, hpc=False,
                         refine_rounds=refine_rounds, device=dev)
        for i, p in enumerate(paths):
            p.blocks = [
                (u, r, us.raw_start(i, qs),
                 us.raw_stop(i, qe - 1) if qe > qs
                 else us.raw_start(i, qs))
                for (u, r, qs, qe) in p.blocks]
        return paths
    with trace.span("ul.chain", STATS, "chain_s"):
        pt, _, _, mzs = build_position_table(
            utg_seqs, k, w, ft=None, keep_min=1)
        utg_lens = np.array([len(s) for s in utg_seqs], np.int64)
        cp = ChainParams.for_k(k, is_accurate=False, bw_rate=0.1)
        paths = []
        n_utg = len(utg_seqs)
        reads = []
        for i, ul in enumerate(ul_reads):
            mz = sketch_read(ul, k, w, None)
            an = collect_anchors(mz, pt, n_utg + i, utg_lens, hom_cov)
            reads.append((n_utg + i, an, len(ul)))
        ovs = chain_many(reads, utg_lens, cp, max_n_chain=50)

    # base-level screening of every candidate chain (WINDOW_UL spot
    # checks, scall_ul_pipeline inter.cpp:19992), all reads packed into
    # one K2 pass; the rejected and low-score sets stay live for the
    # refinement rounds' rescue passes, which reuse these errs
    low_floor = max(min_chain_score // 2, 4)
    items, owner = [], []
    for r, ((rid, _, _), ov) in enumerate(zip(reads, ovs)):
        for o in range(len(ov)):
            if ov.score[o] >= min_chain_score or \
                    (ug is not None and ov.score[o] >= low_floor):
                items.append((ul_reads[rid - n_utg], ov, o))
                owner.append(r)
    screens: List[Dict[int, np.ndarray]] = [{} for _ in reads]
    for r, (_, _, o), err in zip(owner, items,
                                 _screen_chains(items, utg_seqs, dev)):
        screens[r][o] = err

    for r, ((rid, an, rlen), ov) in enumerate(zip(reads, ovs)):
        ul = ul_reads[rid - n_utg]
        ok_idx, rej_idx, low_idx = [], [], []
        for o in range(len(ov)):
            if ov.score[o] < min_chain_score:
                if ov.score[o] >= low_floor:
                    low_idx.append(o)
                continue
            if _screen_pass(screens[r][o], 0.6):
                ok_idx.append(o)
            else:
                rej_idx.append(o)
        if ug is not None:
            blocks = graph_chain_refine(
                ul, ov, ok_idx, rej_idx, low_idx, ug, utg_seqs,
                utg_lens, min_chain_score=min_chain_score,
                rounds=refine_rounds, device=dev, screen=screens[r])
            paths.append(ULPath(blocks))
            continue
        ovf = ov.take(np.array(ok_idx, np.int64)) if ok_idx else None
        if ovf is None:
            paths.append(ULPath([]))
            continue
        blocks = []
        order = np.argsort(ovf.x_s, kind="stable")
        last_end = -1
        for o in order:
            if int(ovf.x_s[o]) < last_end - 200:   # heavy overlap
                continue
            blocks.append((int(ovf.y_id[o]), int(ovf.rev[o]),
                           int(ovf.x_s[o]), int(ovf.x_e[o])))
            last_end = int(ovf.x_e[o])
        paths.append(ULPath(blocks))
    n_mapped = sum(1 for p in paths if p.blocks)
    STATS["passes"] += 1
    STATS["reads"] += len(ul_reads)
    STATS["mapped"] += n_mapped
    STATS["blocks"] += sum(len(p.blocks) for p in paths)
    log("ul_align", f"mapped {n_mapped}/{len(ul_reads)} UL reads, "
        f"{sum(len(p.blocks) for p in paths)} unitig blocks")
    return paths


def ul_arc_support(ug: UnitigGraph, paths: List[ULPath]
                   ) -> Dict[Tuple[int, int], int]:
    """Count UL traversals per ordered unitig-end pair (the ``ou`` field)."""
    sup: Dict[Tuple[int, int], int] = {}
    for p in paths:
        for (ua, ra, _, _), (ub, rb, _, _) in zip(p.blocks, p.blocks[1:]):
            src = ua << 1 | ra
            dst = ub << 1 | rb
            sup[(src, dst)] = sup.get((src, dst), 0) + 1
            # complement direction
            csrc = dst ^ 1
            cdst = src ^ 1
            sup[(csrc, cdst)] = sup.get((csrc, cdst), 0) + 1
    return sup


def ul_bridge_arcs(ug: UnitigGraph, paths: List[ULPath],
                   min_support: int = 2) -> int:
    """Add arcs for UL-supported adjacencies missing from the HiFi graph
    (~rescue_src_ul / gradually_renew_g). Returns #arcs added."""
    sup = ul_arc_support(ug, paths)
    have = {(int(s), int(d)) for s, d in zip(ug.a_src, ug.a_dst)}
    add_s, add_d = [], []
    for (s, d), c in sup.items():
        if c >= min_support and (s, d) not in have:
            add_s.append(s)
            add_d.append(d)
    if add_s:
        ug.a_src = np.concatenate([ug.a_src,
                                   np.array(add_s, np.uint32)])
        ug.a_dst = np.concatenate([ug.a_dst,
                                   np.array(add_d, np.uint32)])
        ug.a_ol = np.concatenate([ug.a_ol, np.zeros(len(add_s), np.int64)])
    log("ul_bridge_arcs", f"added {len(add_s)} UL-supported bridge arcs")
    return len(add_s)


def integer_correction(paths: List[ULPath], min_occ: int = 3,
                       rounds: int = 3) -> int:
    """UL-vs-UL correction in unitig-ID ("integer") space
    (~integer_correction, gfa_ut.cpp:7622): a path block contradicted by
    every other UL read traversing the same flanks is a chimeric/misplaced
    mapping; replace it with the majority block.

    Votes are oriented triples (prev, cur, next) over all paths in both
    orientations; a block is rewritten when its own triple is unique and
    >= min_occ other reads agree on an alternative. Runs up to ``rounds``
    passes (the reference's 3 integer-correction rounds); returns the
    number of corrected blocks.
    """
    def tri_votes():
        cnt: Dict[Tuple[int, int, int], int] = {}
        for p in paths:
            vs = [u << 1 | r for (u, r, _, _) in p.blocks]
            for a, b, c in zip(vs, vs[1:], vs[2:]):
                cnt[(a, b, c)] = cnt.get((a, b, c), 0) + 1
                cnt[(c ^ 1, b ^ 1, a ^ 1)] = \
                    cnt.get((c ^ 1, b ^ 1, a ^ 1), 0) + 1
        return cnt

    n_fix = 0
    for _ in range(rounds):
        cnt = tri_votes()
        changed = 0
        for p in paths:
            if len(p.blocks) < 3:
                continue
            vs = [u << 1 | r for (u, r, _, _) in p.blocks]
            for i in range(1, len(vs) - 1):
                a, x, c = vs[i - 1], vs[i], vs[i + 1]
                if cnt.get((a, x, c), 0) != 1:
                    continue              # own vote only -> suspicious
                best_b, best_c = -1, 0
                for (aa, b, cc), k in cnt.items():
                    if aa == a and cc == c and b != x and k > best_c:
                        best_b, best_c = b, k
                if best_c >= min_occ:
                    _, _, qs, qe = p.blocks[i]
                    p.blocks[i] = (best_b >> 1, best_b & 1, qs, qe)
                    vs[i] = best_b
                    changed += 1
        n_fix += changed
        if changed == 0:
            break
    log("integer_correction", f"rewrote {n_fix} UL path blocks")
    return n_fix


def ul_path_drop_ladder(ug: UnitigGraph, paths: List[ULPath],
                        r_min: float = 0.2, r_max: float = 0.6,
                        rounds: int = 3) -> int:
    """UL-support drop-ratio ladder (--path-min/--path-max, ~the path
    drop rates of ul_clean_gfa): at each source end, arcs whose UL
    traversal support falls below ratio x the best-supported sibling
    are cut with their mirrors; the ratio sweeps r_min -> r_max.
    Returns total #arcs dropped."""
    with trace.span("ul.renew", STATS, "renew_s"):
        n_drop_tot = 0
        for step in range(max(rounds, 1)):
            r = r_min + (r_max - r_min) * step / max(rounds - 1, 1)
            sup = ul_arc_support(ug, paths)
            src = ug.a_src.astype(np.int64)
            dst = ug.a_dst.astype(np.int64)
            if len(src) == 0:
                break
            arc_sup = np.array([sup.get((int(s), int(d)), 0)
                                for s, d in zip(src, dst)], np.int64)
            best = {}
            for s, c in zip(src, arc_sup):
                best[int(s)] = max(best.get(int(s), 0), int(c))
            drop = np.array(
                [0 < c < best.get(int(s), 0) and c < r * best.get(int(s), 0)
                 for s, c in zip(src, arc_sup)], bool)
            comp = {(int(d) ^ 1, int(s) ^ 1)
                    for s, d in zip(src[drop], dst[drop])}
            drop |= np.array([(int(s), int(d)) in comp
                              for s, d in zip(src, dst)], bool)
            if not drop.any():
                continue
            keep = ~drop
            ug.a_src = ug.a_src[keep]
            ug.a_dst = ug.a_dst[keep]
            ug.a_ol = ug.a_ol[keep]
            n_drop_tot += int(drop.sum())
        if n_drop_tot:
            log("ul_path_drop_ladder", f"dropped {n_drop_tot} weak UL arcs")
    return n_drop_tot


def ul_gap_sequences(paths: List[ULPath], ul_reads: List[np.ndarray]
                     ) -> Dict[Tuple[int, int], np.ndarray]:
    """Per bridged unitig-end pair, the UL-derived gap sequence
    (~the UL sequence fill of rescue_src_ul joins, Overlaps.cpp:39190).

    For every consecutive block pair (a, b) of every UL path the read
    bases between a's end and b's start ARE the junction sequence in
    src->dst orientation.  Among the supporting reads the representative
    is the lower-median-length candidate (deterministic tie-break on the
    raw bytes) — UL base error is handled downstream by polishing, the
    structural length is what matters for the join."""
    cands: Dict[Tuple[int, int], List[np.ndarray]] = {}
    for p, ul in zip(paths, ul_reads):
        for (ua, ra, _, qe_a), (ub, rb, qs_b, _) in zip(p.blocks,
                                                        p.blocks[1:]):
            key = (ua << 1 | ra, ub << 1 | rb)
            seq = ul[qe_a:qs_b] if qs_b > qe_a else \
                np.zeros(0, np.uint8)
            cands.setdefault(key, []).append(seq)
    out: Dict[Tuple[int, int], np.ndarray] = {}
    for key, lst in cands.items():
        lst.sort(key=lambda s: (len(s), s.tobytes()))
        rep = lst[(len(lst) - 1) // 2]
        out[key] = rep
        ckey = (key[1] ^ 1, key[0] ^ 1)
        if ckey not in cands:
            from hifiasm_tpu_torch.io.readstore import revcomp_codes
            out[ckey] = revcomp_codes(rep)
    return out


def ul_fill_bridged(ug: UnitigGraph, store, cov, paths: List[ULPath],
                    ul_reads: List[np.ndarray], min_support: int = 2
                    ) -> List[Tuple[int, int]]:
    """Join mutually-unique bridged (ol=0) unitig pairs, inserting the
    UL gap sequence as a pseudo-read on the merged path (so GFA A-lines
    and FASTA both carry the filled sequence).  Returns
    [(new_rid, support)] for the appended gap reads (support = #UL
    traversals of the joined junction); callers extend any per-read
    coverage arrays with these.

    ~the UL-bridge consumption of gradually_renew_g (Overlaps.cpp:39297)
    combined with the post-join merge; the reference re-runs ma_ug_gen
    at the read level, we merge at the unitig level with the UL segment
    carrying the novel (HiFi-uncovered) junction bases."""
    from hifiasm_tpu_torch.graph.unitig import Unitig, flip_unitig

    with trace.span("ul.fill", STATS, "fill_s"):
        gaps = ul_gap_sequences(paths, ul_reads)
        sup = ul_arc_support(ug, paths)
        new_reads: List[Tuple[int, int]] = []
        n_join = 0
        while True:
            n = len(ug.utgs)
            if n == 0 or len(ug.a_src) == 0:
                break
            deg = np.bincount(ug.a_src.astype(np.int64), minlength=2 * n)
            src = ug.a_src.astype(np.int64)
            dst = ug.a_dst.astype(np.int64)
            pick = -1
            for k in range(len(src)):
                s, d, ol = int(src[k]), int(dst[k]), int(ug.a_ol[k])
                if ol != 0:
                    continue                  # only bridged arcs
                if (s >> 1) == (d >> 1):
                    continue
                if deg[s] != 1 or deg[d ^ 1] != 1:
                    continue                  # not mutually unique
                if ug.utgs[s >> 1].circ or ug.utgs[d >> 1].circ:
                    continue
                if (s, d) not in gaps or sup.get((s, d), 0) < min_support:
                    continue
                pick = k
                break
            if pick < 0:
                break
            s, d = int(src[pick]), int(dst[pick])
            ua, da = s >> 1, s & 1
            ub, db = d >> 1, d & 1
            a = ug.utgs[ua] if da == 0 else flip_unitig(ug.utgs[ua], cov)
            b = ug.utgs[ub] if db == 0 else flip_unitig(ug.utgs[ub], cov)
            gseq = gaps[(s, d)]
            mid_vs = np.zeros(0, np.uint32)
            mid_nl = np.zeros(0, np.int64)
            if len(gseq):
                rid = store.append_read(f"ulg{len(new_reads) + 1:06d}", gseq)
                cov.s = np.append(cov.s, 0)
                cov.e = np.append(cov.e, len(gseq))
                cov.del_ = np.append(cov.del_, np.uint8(0))
                new_reads.append((rid, int(sup.get((s, d), 0))))
                mid_vs = np.array([rid << 1], np.uint32)
                mid_nl = np.array([len(gseq)], np.int64)
            merged = Unitig(
                vs=np.concatenate([a.vs, mid_vs, b.vs]).astype(np.uint32),
                node_len=np.concatenate([a.node_len, mid_nl, b.node_len]),
                len=int(a.node_len.sum() + mid_nl.sum() + b.node_len.sum()),
                circ=False, start=int(a.vs[0]), end=int(b.vs[-1]) ^ 1)
            keep = np.ones(len(src), bool)
            keep[pick] = False
            comp = (src == (d ^ 1)) & (dst == (s ^ 1))
            keep[comp] = False
            src2, dst2, ol2 = src[keep], dst[keep], ug.a_ol[keep]
            out = np.where(src2 == (ua << 1 | (1 ^ da)), ua << 1 | 1, src2)
            src2 = np.where(out == (ub << 1 | db), ua << 1, out)
            dst2_ = np.where(dst2 == (ua << 1 | (0 ^ da)), ua << 1, dst2)
            dst2 = np.where(dst2_ == (ub << 1 | (1 ^ db)), ua << 1 | 1, dst2_)
            ug.utgs[ua] = merged
            drop = np.zeros(n, bool)
            drop[ub] = True
            remap_id = np.cumsum(~drop) - 1
            ug.utgs = [u for i, u in enumerate(ug.utgs) if not drop[i]]
            keep2 = ~drop[src2 >> 1] & ~drop[dst2 >> 1]
            src2, dst2, ol2 = src2[keep2], dst2[keep2], ol2[keep2]
            ug.a_src = ((remap_id[src2 >> 1] << 1) | (src2 & 1)).astype(
                np.uint32)
            ug.a_dst = ((remap_id[dst2 >> 1] << 1) | (dst2 & 1)).astype(
                np.uint32)
            ug.a_ol = ol2
            # remap the support/gap keys into the merged id space: vertices
            # of ua/ub collapse onto the merged unitig's outer ends
            def _remap_v(v: int) -> int:
                if v == (ua << 1 | (1 ^ da)):
                    return (ua << 1 | 1)
                if v == (ub << 1 | db):
                    return (ua << 1)
                if v == (ua << 1 | (0 ^ da)):
                    return (ua << 1)
                if v == (ub << 1 | (1 ^ db)):
                    return (ua << 1 | 1)
                return v
            def _remap_pair_dict(dd):
                nd = {}
                for (x, y), val in dd.items():
                    x2, y2 = _remap_v(int(x)), _remap_v(int(y))
                    x2 = (remap_id[x2 >> 1] << 1) | (x2 & 1)
                    y2 = (remap_id[y2 >> 1] << 1) | (y2 & 1)
                    if (x2 >> 1) < len(ug.utgs) and (y2 >> 1) < len(ug.utgs):
                        nd[(int(x2), int(y2))] = val
                return nd
            gaps = _remap_pair_dict(gaps)
            sup = _remap_pair_dict(sup)
            n_join += 1
        if n_join:
            log("ul_fill_bridged",
                f"joined {n_join} bridged unitig pairs "
                f"({len(new_reads)} UL gap segments inserted)")
    return new_reads


def ul_renew_graph(ug: UnitigGraph, paths: List[ULPath],
                   rounds: int = 3, min_support: int = 2,
                   drop_contradicted: int = 3) -> None:
    """Iterative UL-guided graph renewal (~gradually_renew_g,
    Overlaps.cpp:39297 + the ``ou`` gate in cleaning): per round, bridge
    UL-supported missing adjacencies, then drop arcs with zero UL support
    whose source end has a >= drop_contradicted-supported alternative
    (UL coverage contradicts the HiFi arc)."""
    with trace.span("ul.renew", STATS, "renew_s"):
        for _ in range(rounds):
            added = ul_bridge_arcs(ug, paths, min_support)
            sup = ul_arc_support(ug, paths)
            src = ug.a_src.astype(np.int64)
            dst = ug.a_dst.astype(np.int64)
            arc_sup = np.array([sup.get((int(s), int(d)), 0)
                                for s, d in zip(src, dst)], np.int64)
            # strongest UL support per source end
            best = {}
            for s, c in zip(src, arc_sup):
                best[int(s)] = max(best.get(int(s), 0), int(c))
            drop = np.array([c == 0 and
                             best.get(int(s), 0) >= drop_contradicted
                             for s, c in zip(src, arc_sup)], bool)
            # keep symmetry: a contradicted arc takes its complement with it
            # (the complement's source end may never be traversed by UL)
            comp = {(int(d) ^ 1, int(s) ^ 1) for s, d
                    in zip(src[drop], dst[drop])}
            drop |= np.array([(int(s), int(d)) in comp
                              for s, d in zip(src, dst)], bool)
            if drop.any():
                keep = ~drop
                ug.a_src = ug.a_src[keep]
                ug.a_dst = ug.a_dst[keep]
                ug.a_ol = ug.a_ol[keep]
                log("ul_renew_graph",
                    f"dropped {int(drop.sum())} UL-contradicted arcs")
            if added == 0 and not drop.any():
                break


def ul_realign_renewed(ug: UnitigGraph, utg_seqs: List[np.ndarray],
                       paths: List[ULPath], ul_reads: List[np.ndarray],
                       hpc: bool = True, device="cuda") -> int:
    """Re-map UL reads against the RENEWED graph and keep the better
    path per read (~the reference's iterative re-alignment after
    gradually_renew_g: ul_align/ul_resolve run again on the renewed/
    final graph, inter.cpp:20527,20559, driven from Overlaps.cpp:39297).

    The unitig sequences are unchanged — what changed are the ARCS
    (bridged adjacencies added, UL-contradicted arcs dropped), and the
    graph-chain DP's junction decisions depend on them: a read that
    previously split at a missing adjacency can now thread through it
    with base-level splice verification.  A read's re-mapped path
    replaces the old one only when it covers at least as many query
    bases (monotone, deterministic).  Returns #reads whose path
    improved.  The re-map's checks score on K2 on ``device``."""
    new_paths = ul_align(utg_seqs, ul_reads, ug=ug, hpc=hpc, device=device)

    def _cov(p: ULPath) -> int:
        return sum(max(int(qe) - int(qs), 0) for _, _, qs, qe in p.blocks)

    n_better = 0
    for i, np_ in enumerate(new_paths):
        oldc, newc = _cov(paths[i]), _cov(np_)
        if newc >= oldc:
            if newc > oldc or len(np_.blocks) < len(paths[i].blocks):
                n_better += 1
            paths[i].blocks = np_.blocks
    log("ul_realign_renewed",
        f"re-mapped {len(ul_reads)} UL reads against the renewed graph; "
        f"{n_better} paths improved")
    return n_better


def ul_catalog(paths: List[ULPath], min_anchor: int = 2,
               max_mm_run: int = 1, min_ident: float = 0.75
               ) -> Dict[int, list]:
    """UL-vs-UL overlap catalog in unitig-ID ("integer") space
    (~ul_resolve's UL<->UL overlap derivation, gfa_ut.cpp:4192 feeding
    the correction rounds at :7622).

    Each pair of paths sharing an oriented unitig is aligned as two
    block strings: seed at the shared block, extend both ways allowing
    isolated mismatches (a mis-mapped block) but stopping after
    ``max_mm_run`` consecutive misses.  Overlaps with >= ``min_anchor``
    matching blocks enter the catalog.

    Returns {pid: [(qid, q_dir, p_lo, p_hi, q_at_p_lo, n_match)]}:
    partner qid aligns blocks p_lo..p_hi (inclusive) of pid, with qid's
    block index at p_lo being q_at_p_lo (stepping +1 along p when
    q_dir=0, -1 when q_dir=1 i.e. qid traversed reverse-complement)."""
    vs_of = [np.array([(u << 1) | r for (u, r, _, _) in p.blocks],
                      np.int64) for p in paths]
    # inverted index: oriented uid -> [(pid, block idx)]
    occ: Dict[int, list] = {}
    for pid, vs in enumerate(vs_of):
        for bi, v in enumerate(vs.tolist()):
            occ.setdefault(v >> 1, []).append((pid, bi))

    def _extend(vp, vq, pi, qi, qdir):
        """Matched block count + p-range of the seeded co-linear run."""
        step = 1 if qdir == 0 else -1
        flip = 0 if qdir == 0 else 1
        n_match = 1
        lo = hi = pi
        # right
        i, j, mm = pi + 1, qi + step, 0
        while 0 <= j < len(vq) and i < len(vp) and mm <= max_mm_run:
            if vp[i] == (vq[j] ^ flip):
                n_match += 1
                hi = i
                mm = 0
            else:
                mm += 1
            i += 1
            j += step
        # left
        i, j, mm = pi - 1, qi - step, 0
        while 0 <= j < len(vq) and i >= 0 and mm <= max_mm_run:
            if vp[i] == (vq[j] ^ flip):
                n_match += 1
                lo = i
                mm = 0
            else:
                mm += 1
            i -= 1
            j -= step
        return n_match, lo, hi

    cat: Dict[int, list] = {p: [] for p in range(len(paths))}
    seen: set = set()
    for pid, vs in enumerate(vs_of):
        for bi, v in enumerate(vs.tolist()):
            for qid, qj in occ.get(v >> 1, []):
                if qid == pid:
                    continue
                vq = vs_of[qid]
                qdir = 0 if vq[qj] == v else 1
                if vq[qj] != v and vq[qj] != (v ^ 1):
                    continue
                key = (pid, qid, bi - (qj if qdir == 0 else -qj), qdir)
                if key in seen:        # same diagonal already derived
                    continue
                seen.add(key)
                nm, lo, hi = _extend(vs, vq, bi, qj, qdir)
                span = hi - lo + 1
                # overlap identity gate: a read crossing a DIFFERENT
                # genomic copy of a shared repeat matches only the
                # repeat blocks (low identity) and must not become a
                # correction partner
                if nm < min_anchor or nm < min_ident * span:
                    continue
                q_at_lo = qj + (lo - bi) * (1 if qdir == 0 else -1)
                cat[pid].append((qid, qdir, lo, hi, q_at_lo, nm))
    for pid in cat:
        cat[pid].sort()
    n_ov = sum(len(v) for v in cat.values())
    log("ul_catalog", f"{n_ov} UL-vs-UL integer overlaps over "
        f"{len(paths)} paths")
    return cat


def catalog_correction(paths: List[ULPath], min_occ: int = 3,
                       rounds: int = 3, min_anchor: int = 2) -> int:
    """UL path correction over the UL-vs-UL catalog
    (~the integer-correction rounds of gfa_ut.cpp:7622 run over REAL
    UL<->UL overlaps instead of context-free triples).

    A block is rewritten only when catalog-ALIGNED partners (reads
    whose block strings overlap this read's at high integer-space
    identity) vote >= min_occ for one alternative and none supports the
    current block.  Repeat-crossing reads keep their path:
    reads from a different genomic copy of the repeat do not align
    across the full flank context, so their votes never reach the
    block — the failure mode of the triple vote."""
    with trace.span("ul.correct", STATS, "correct_s"):
        n_fix = 0
        for _ in range(max(rounds, 1)):
            cat = ul_catalog(paths, min_anchor=min_anchor)
            vs_of = [[(u << 1) | r for (u, r, _, _) in p.blocks]
                     for p in paths]
            changed = 0
            for pid, p in enumerate(paths):
                vs = vs_of[pid]
                if len(vs) < 3 or not cat.get(pid):
                    continue
                for i in range(1, len(vs) - 1):
                    votes: Dict[int, int] = {}
                    for qid, qdir, lo, hi, q_at_lo, nm in cat[pid]:
                        if not (lo <= i <= hi):
                            continue
                        # require the partner to MATCH on both flanks of i
                        qi = q_at_lo + (i - lo) * (1 if qdir == 0 else -1)
                        vq = vs_of[qid]
                        okl = okr = False
                        if qdir == 0:
                            if 0 <= qi - 1 < len(vq):
                                okl = vq[qi - 1] == vs[i - 1]
                            if 0 <= qi + 1 < len(vq):
                                okr = vq[qi + 1] == vs[i + 1]
                        else:
                            if 0 <= qi + 1 < len(vq):
                                okl = (vq[qi + 1] ^ 1) == vs[i - 1]
                            if 0 <= qi - 1 < len(vq):
                                okr = (vq[qi - 1] ^ 1) == vs[i + 1]
                        if not (okl and okr) or not (0 <= qi < len(vq)):
                            continue
                        b = vq[qi] if qdir == 0 else (vq[qi] ^ 1)
                        votes[b] = votes.get(b, 0) + 1
                    own = votes.get(vs[i], 0)
                    if own > 0:
                        continue
                    alts = sorted(votes.items(),
                                  key=lambda kv: (-kv[1], kv[0]))
                    if alts and alts[0][1] >= min_occ:
                        b = alts[0][0]
                        _, _, qs, qe = p.blocks[i]
                        p.blocks[i] = (b >> 1, b & 1, qs, qe)
                        vs[i] = b
                        changed += 1
            n_fix += changed
            if changed == 0:
                break
        log("catalog_correction", f"rewrote {n_fix} UL path blocks")
    return n_fix
