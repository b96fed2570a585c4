"""Spin-glass max-cut phasing solver.

Re-expresses rcut.cpp's ``mc_solve`` (:3710) / ``mc_solve_core_adv``
(:3453): nodes are unitigs, spin s in {-1,+1} is the haplotype, and an
edge weight w > 0 says the two nodes belong to DIFFERENT haplotypes
(inter-hap trans evidence), w < 0 to the same (e.g. Hi-C attraction after
sign convention).  The solver maximizes sum_e -w_e * s_x * s_y per
connected component: greedy strongest-edge-first init (``mc_init_spin``
:1537), local sweeps flipping any node whose weighted neighbour field
disagrees (``mc_optimize_local`` :1700), and ``n_perturb`` random restarts
flipping each spin with prob ``f_perturb`` keeping the best solution
(``mc_perturb`` :1759; defaults n_perturb=10000, f_perturb=0.1, seed=11,
CommandLines.cpp:325-328).

Deterministic for a fixed seed (numpy Generator; the reference uses
kr_splitmix64 — same contract, different stream).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from hifiasm_tpu_torch.utils.logging import log


@dataclass
class McGraph:
    """Symmetric weighted graph in CSR (both directions stored)."""

    n: int
    adj_start: np.ndarray
    adj_node: np.ndarray
    adj_w: np.ndarray

    @classmethod
    def from_edges(cls, n: int, x: np.ndarray, y: np.ndarray,
                   w: np.ndarray) -> "McGraph":
        x = np.asarray(x, np.int64)
        y = np.asarray(y, np.int64)
        w = np.asarray(w, np.float64)
        src = np.concatenate([x, y])
        dst = np.concatenate([y, x])
        ww = np.concatenate([w, w])
        order = np.argsort(src, kind="stable")
        src, dst, ww = src[order], dst[order], ww[order]
        start = np.zeros(n + 1, np.int64)
        cnt = np.bincount(src, minlength=n)
        start[1:] = np.cumsum(cnt)
        return cls(n, start, dst, ww)

    def neighbors(self, k: int):
        s, e = self.adj_start[k], self.adj_start[k + 1]
        return self.adj_node[s:e], self.adj_w[s:e]


def _components(g: McGraph) -> np.ndarray:
    comp = np.full(g.n, -1, np.int64)
    c = 0
    for seed in range(g.n):
        if comp[seed] >= 0:
            continue
        stack = [seed]
        comp[seed] = c
        while stack:
            k = stack.pop()
            nb, _ = g.neighbors(k)
            for t in nb:
                if comp[t] < 0:
                    comp[t] = c
                    stack.append(int(t))
        c += 1
    return comp


def _score(g: McGraph, s: np.ndarray, nodes: np.ndarray) -> float:
    tot = 0.0
    for k in nodes:
        nb, w = g.neighbors(int(k))
        tot += float(-(w * s[nb] * s[k]).sum())
    return tot / 2.0


def _field(g: McGraph, s: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    f = np.zeros(g.n)
    for k in nodes:
        nb, w = g.neighbors(int(k))
        f[k] = float((w * s[nb]).sum())
    return f


def _local_opt(g: McGraph, s: np.ndarray, nodes: np.ndarray,
               rng: np.random.Generator, max_iter: int = 1000) -> None:
    """Sequential best-response sweeps until no flip (~mc_optimize_local)."""
    f = _field(g, s, nodes)
    for _ in range(max_iter):
        order = rng.permutation(nodes)
        n_flip = 0
        for k in order:
            k = int(k)
            # maximizing -w*s_k*s_j: prefer s_k = -sign(field)
            if f[k] == 0:
                continue
            want = -1 if f[k] > 0 else 1
            if s[k] != want:
                nb, w = g.neighbors(k)
                f[nb] += w * (want - s[k])
                s[k] = want
                n_flip += 1
        if n_flip == 0:
            break


def _init_spins(g: McGraph, s: np.ndarray, nodes: np.ndarray,
                rng: np.random.Generator) -> None:
    """Strongest-edge-first propagation (~mc_init_spin, rcut.cpp:1537)."""
    edges = []
    for k in nodes:
        nb, w = g.neighbors(int(k))
        for t, wt in zip(nb, w):
            if int(k) < int(t):
                edges.append((abs(wt), int(k), int(t), wt))
    edges.sort(key=lambda e: -e[0])
    for _, n1, n2, w in edges:
        if s[n1] == 0 and s[n2] == 0:
            s[n1] = 1 if rng.integers(0, 2) else -1
            s[n2] = -s[n1] if w > 0 else s[n1]
        elif s[n1] == 0:
            s[n1] = -s[n2] if w > 0 else s[n2]
        elif s[n2] == 0:
            s[n2] = -s[n1] if w > 0 else s[n1]
    for k in nodes:
        if s[k] == 0:
            s[k] = 1


def mc_solve_k(n: int, ex: np.ndarray, ey: np.ndarray, ew: np.ndarray,
               k_hap: int, n_perturb: int = 1000, f_perturb: float = 0.1,
               seed: int = 11, max_sweeps: int = 200) -> np.ndarray:
    """Polyploid generalization (~mc_solve_general/mcg_node_t,
    rcut.cpp:4586): labels 0..k-1 minimizing same-label positive weight
    (w > 0: different haplotype evidence; w < 0: same)."""
    g = McGraph.from_edges(n, ex, ey, ew)
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k_hap, n)

    def cost_of(k, l):
        nb, w = g.neighbors(int(k))
        return float(w[lab[nb] == l].sum())

    def sweep():
        changed = 0
        for k in rng.permutation(n):
            costs = [cost_of(k, l) for l in range(k_hap)]
            best = int(np.argmin(costs))
            if best != lab[k] and costs[best] < costs[lab[k]]:
                lab[k] = best
                changed += 1
        return changed

    for _ in range(max_sweeps):
        if sweep() == 0:
            break
    best_lab = lab.copy()
    best_sc = sum(cost_of(k, lab[k]) for k in range(n))
    for _ in range(n_perturb):
        flip = rng.random(n) < f_perturb
        lab[flip] = rng.integers(0, k_hap, int(flip.sum()))
        for _ in range(max_sweeps):
            if sweep() == 0:
                break
        sc = sum(cost_of(k, lab[k]) for k in range(n))
        if sc < best_sc:
            best_sc = sc
            best_lab = lab.copy()
        else:
            lab[:] = best_lab
    log("mc_solve_k", f"{n} nodes into {k_hap} haplotype groups")
    return best_lab


def mc_solve_blocks(n: int, ex: np.ndarray, ey: np.ndarray,
                    ew: np.ndarray, bx: np.ndarray, by: np.ndarray,
                    n_perturb: int = 10000, f_perturb: float = 0.1,
                    seed: int = 11) -> np.ndarray:
    """Block-coarsened max-cut (~the ``mb_*`` machinery, rcut.cpp:611-
    1841 ``init_mb_g_t``/``mb_optimize_local``/``mb_perturb``).

    ``(bx, by)`` are block-DEFINING edges (the reference groups nodes by
    connectivity of the raw ``kv_u_trans`` set, ``mb_nodes_core``
    rcut.cpp:362): connected nodes flip as one block.  The weighted
    graph ``(ex, ey, ew)`` is collapsed onto blocks (inter-block weights
    summed), solved at block level, and the block spins warm-start a
    node-level refinement — the coarse flips escape local optima that
    defeat single-node sweeps on large tangles.
    """
    blk = np.arange(n, dtype=np.int64)

    def find(a):
        while blk[a] != a:
            blk[a] = blk[blk[a]]
            a = blk[a]
        return a

    for a, b in zip(np.asarray(bx, np.int64), np.asarray(by, np.int64)):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            blk[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(i) for i in range(n)], np.int64)
    uniq, blk_of = np.unique(roots, return_inverse=True)
    nb = len(uniq)
    # collapse weights onto block pairs (intra-block edges drop out of
    # the coarse solve; they return in the node-level refinement)
    ex = np.asarray(ex, np.int64)
    ey = np.asarray(ey, np.int64)
    ew = np.asarray(ew, np.float64)
    bxe, bye = blk_of[ex], blk_of[ey]
    inter = bxe != bye
    if inter.any():
        lo = np.minimum(bxe[inter], bye[inter])
        hi = np.maximum(bxe[inter], bye[inter])
        key = lo * nb + hi
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        w_s = ew[inter][order]
        new = np.empty(len(key_s), bool)
        if len(key_s):
            new[0] = True
            np.not_equal(key_s[1:], key_s[:-1], out=new[1:])
        starts = np.flatnonzero(new)
        wsum = np.add.reduceat(w_s, starts) if len(starts) else \
            np.zeros(0)
        kk = key_s[starts] if len(starts) else np.zeros(0, np.int64)
        s_blk = mc_solve(nb, kk // nb, kk % nb, wsum,
                         n_perturb=n_perturb, f_perturb=f_perturb,
                         seed=seed)
    else:
        s_blk = np.ones(nb, np.int8)
    init = s_blk[blk_of].astype(np.int8)
    # node-level refinement from the block warm start
    return mc_solve(n, ex, ey, ew, n_perturb=n_perturb,
                    f_perturb=f_perturb, seed=seed, init_s=init)


def mc_solve(n: int, ex: np.ndarray, ey: np.ndarray, ew: np.ndarray,
             n_perturb: int = 10000, f_perturb: float = 0.1,
             seed: int = 11, max_sweeps: int = 1000,
             init_s: np.ndarray = None) -> np.ndarray:
    """Solve spins for a weighted graph; returns s in {-1,+1} (~mc_solve).

    ``init_s``: warm-start labels from a previous round (the reference's
    renew->solve->label loop passes s->s back with init=0,
    hic.cpp:17090); components whose labels are all set skip the
    strongest-edge-first re-init and refine from the prior state."""
    g = McGraph.from_edges(n, ex, ey, ew)
    s = np.zeros(n, np.int8)
    rng = np.random.default_rng(seed)
    comp = _components(g)
    for c in range(int(comp.max()) + 1 if n else 0):
        nodes = np.flatnonzero(comp == c)
        if len(nodes) == 1:
            s[nodes] = 1
            continue
        if init_s is not None and (init_s[nodes] != 0).all():
            s[nodes] = init_s[nodes]
        else:
            _init_spins(g, s, nodes, rng)
        _local_opt(g, s, nodes, rng, max_sweeps)
        best = s[nodes].copy()
        best_sc = _score(g, s, nodes)
        # perturbation restarts, scaled down for small components
        n_pert = min(n_perturb, 20 * len(nodes) + 50)
        for _ in range(n_pert):
            flip = rng.random(len(nodes)) < f_perturb
            s[nodes[flip]] = -s[nodes[flip]]
            _local_opt(g, s, nodes, rng, max_sweeps)
            sc = _score(g, s, nodes)
            if sc > best_sc:
                best_sc = sc
                best = s[nodes].copy()
            else:
                s[nodes] = best
        s[nodes] = best
    log("mc_solve", f"phased {n} nodes, "
        f"{int((s == 1).sum())}/{int((s == -1).sum())} split")
    return s
