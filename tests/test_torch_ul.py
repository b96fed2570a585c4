"""The port's ultralong integration (hifiasm_tpu_torch.ul, ops/affine and
the ``--ul`` branch of assemble) against the JAX package's, on the CPU.

The port scores the UL screen windows and junction checks with K2's
plain version (``ul.ul_band_err`` -> ops/banded_fwd.banded_forward on
CPU tensors) where the JAX package calls ``banded_batch_np`` one chain
or one junction at a time; paths, arcs and every output byte must be
identical.  The JAX package runs its device-EC path (align_engine="jax",
mesh_devices=1) with the port's sequence memo
(tests/test_torch_hic.py ``jax_assemble``)."""

import shutil

import numpy as np
import pytest

import hifiasm_tpu.ul as J
import hifiasm_tpu_torch.ul as U
from hifiasm_tpu.graph.sg import CoverageCut as JCov
from hifiasm_tpu.graph.unitig import Unitig as JUnitig
from hifiasm_tpu.graph.unitig import UnitigGraph as JGraph
from hifiasm_tpu.io.binfiles import checkpoint_paths
from hifiasm_tpu.io.readstore import ReadStore as JStore
from hifiasm_tpu.io.readstore import revcomp_codes
from hifiasm_tpu.ops.banded_batch import banded_batch_np
from hifiasm_tpu_torch.assemble import assemble
from hifiasm_tpu_torch.graph.sg import CoverageCut
from hifiasm_tpu_torch.graph.unitig import Unitig, UnitigGraph
from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.utils import trace
from tests.synth import inject_errors, make_genome, sample_reads
from tests.test_torch_hic import _assert_same, _jcfg, _port_cfg, jax_assemble

NT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _graphs(n_utg, arcs):
    """The same unitig graph in both packages: ``arcs`` [(src_vtx,
    dst_vtx, ol)] with their complements; unitigs without reads."""
    full = []
    for s, d, ol in arcs:
        full += [(s, d, ol), (d ^ 1, s ^ 1, ol)]
    out = []
    for U_, G_ in ((JUnitig, JGraph), (Unitig, UnitigGraph)):
        out.append(G_(
            utgs=[U_(vs=np.zeros(0, np.uint32), node_len=np.zeros(0, np.int64),
                     len=n, circ=False, start=0, end=0) for n in n_utg],
            a_src=np.array([a[0] for a in full], np.uint32),
            a_dst=np.array([a[1] for a in full], np.uint32),
            a_ol=np.array([a[2] for a in full], np.int64)))
    return out


def _arcs(ug):
    return list(zip(ug.a_src.tolist(), ug.a_dst.tolist(), ug.a_ol.tolist()))


def _hpc_noise(rng, s, dup=0.08, sub=0.02):
    """ONT-like noise: run-stretching duplications and substitutions."""
    d = np.flatnonzero(rng.random(len(s)) < dup)
    s = np.insert(s, d, s[d])
    m = rng.random(len(s)) < sub
    s[m] = (s[m] + rng.integers(1, 4, int(m.sum()))) & 3
    return s


# ---- ul_align paths: the JAX package's gold scenarios ------------------


def _three(rng):
    g = make_genome(rng, 30000)
    ul = inject_errors(rng, g[5000:27000].copy(), 0.05)
    return [g[:10000], g[10000:20000], g[20000:]], [ul], None, {}


def _three_rc(rng):
    utgs, uls, _, _ = _three(rng)
    return utgs, [revcomp_codes(uls[0])], None, {}


def _bridging(rng):
    g = make_genome(rng, 24000)
    uls = [inject_errors(rng, g[4000:20000].copy(), 0.05) for _ in range(3)]
    return [g[:8000], g[8000:16000], g[16000:]], uls, None, {}


def _hpc(rng):
    g = make_genome(rng, 24000)
    ul = _hpc_noise(rng, g[2000:22000].copy())
    return [g[:8000], g[8000:16000], g[16000:]], [ul], None, {"hpc": True}


def _hpc_graph(rng):
    """HPC mapping on a graph whose arcs overlap by 500 bp: the arc
    overlaps move into compressed space and the junctions splice there."""
    g = make_genome(rng, 30000)
    utgs = [g[:10500], g[10000:20500], g[20000:]]
    uls = [_hpc_noise(rng, g[3000:27000].copy()) for _ in range(2)]
    uls.append(revcomp_codes(uls[0]))
    return utgs, uls, ([len(u) for u in utgs],
                       [(0, 2, 500), (2, 4, 500)]), {"hpc": True}


def _diverged_repeat(rng, rounds):
    A, R, B = (make_genome(rng, 1500) for _ in range(3))
    Rp = R.copy()
    for t0 in range(75, 1500 - 75, 150):
        seg = slice(t0, t0 + 75)
        m = rng.random(75) < 0.5
        Rp[seg] = np.where(
            m, (Rp[seg] + rng.integers(1, 4, 75).astype(np.uint8)) % 4,
            Rp[seg])
    ul = np.concatenate([A, Rp, B])
    return [A, R, B], [ul], ([1500] * 3, []), {"refine_rounds": rounds}


def _bubble(rng, n_reads=1):
    u0 = make_genome(rng, 6000)
    a = make_genome(rng, 3000)
    b = a.copy()
    snp = rng.choice(len(b), max(len(b) // 200, 8), replace=False)
    b[snp] = (b[snp] + 1 + rng.integers(0, 3, len(snp))) % 4
    u2 = make_genome(rng, 6000)
    utgs = [u0, a, b, u2]
    uls = [inject_errors(rng, np.concatenate([u0[2000:], a, u2[:2500]]).copy(),
                         0.05) for _ in range(n_reads)]
    return utgs, uls, ([len(u) for u in utgs],
                       [(0, 2, 0), (2, 6, 0), (0, 4, 0), (4, 6, 0)]), {}


def _junction_unitig(rng):
    u0 = make_genome(rng, 6000)
    mid = make_genome(rng, 90)
    u2 = make_genome(rng, 6000)
    ul = inject_errors(rng, np.concatenate([u0[1500:], mid, u2[:3000]]).copy(),
                       0.04)
    return [u0, mid, u2], [ul], ([6000, 90, 6000], [(0, 2, 0), (2, 4, 0)]), {}


def _realign(rng):
    u0, u2, decoy = (make_genome(rng, n) for n in (6000, 6000, 3000))
    uls = [inject_errors(rng, np.concatenate([u0[1500:], u2[:3000]]).copy(),
                         0.04) for _ in range(4)]
    return [u0, u2, decoy], uls, ([6000, 6000, 3000], [(0, 4, 0)]), {}


SCENARIOS = {
    "three_unitigs": _three, "three_unitigs_rc": _three_rc,
    "bridging": _bridging, "hpc_noise": _hpc, "hpc_graph": _hpc_graph,
    "refine_rounds_1": lambda r: _diverged_repeat(r, 1),
    "refine_rounds_3": lambda r: _diverged_repeat(r, 3),
    "bubble_allele": _bubble, "junction_unitig": _junction_unitig,
    "renew_false_allele": lambda r: _bubble(r, 4), "realign": _realign,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ul_align_paths_match_jax(name):
    rng = np.random.default_rng(sorted(SCENARIOS).index(name) + 31)
    utgs, uls, graph, kw = SCENARIOS[name](rng)
    jg = tg = None
    if graph is not None:
        jg, tg = _graphs(*graph)
    trace.reset()
    jp = J.ul_align(utgs, uls, ug=jg, **kw)
    tp = U.ul_align(utgs, uls, ug=tg, device="cpu", **kw)
    assert [p.blocks for p in tp] == [p.blocks for p in jp]
    assert any(p.blocks for p in tp)
    assert U.STATS["screen_launches"] == 1, U.STATS
    if name in ("bubble_allele", "junction_unitig", "hpc_graph"):
        assert U.STATS["junction_rows"] > 0, U.STATS
    if name == "bridging":
        assert J.ul_arc_support(jg, jp) == U.ul_arc_support(tg, tp)
    if name in ("renew_false_allele", "realign"):
        J.ul_renew_graph(jg, jp, min_support=2, drop_contradicted=3)
        U.ul_renew_graph(tg, tp, min_support=2, drop_contradicted=3)
        assert _arcs(tg) == _arcs(jg)
    if name == "realign":
        nj = J.ul_realign_renewed(jg, utgs, jp, uls, hpc=False)
        nt = U.ul_realign_renewed(tg, utgs, tp, uls, hpc=False,
                                  device="cpu")
        assert nt == nj
        assert [p.blocks for p in tp] == [p.blocks for p in jp]
        J.ul_renew_graph(jg, jp, min_support=2, drop_contradicted=3)
        U.ul_renew_graph(tg, tp, min_support=2, drop_contradicted=3)
        assert _arcs(tg) == _arcs(jg)


def test_packed_screen_split_matches_per_chain(monkeypatch):
    """ul_align's packed screen gives every read the ok/rej/low split of
    the JAX package's per-chain ``_verify_block`` loop, in one
    ``ul_band_err`` call for the whole pass; the refinement rounds'
    rescue reuses its errs and calls nothing more."""
    rng = np.random.default_rng(3)
    utgs, uls, graph, kw = _diverged_repeat(rng, 3)
    more = _bubble(rng, 3)
    utgs = utgs + more[0]
    uls = uls + more[1]
    _, tg = _graphs([len(u) for u in utgs], [])
    seen, calls = [], []
    orig_refine, orig_err = U.graph_chain_refine, U.ul_band_err

    def refine(ul, ov, ok_idx, rej_idx, low_idx, *a, **k):
        seen.append((ul, ov, list(ok_idx), list(rej_idx), list(low_idx)))
        return orig_refine(ul, ov, ok_idx, rej_idx, low_idx, *a, **k)

    def band_err(X, *a, **k):
        calls.append(len(X))
        return orig_err(X, *a, **k)

    monkeypatch.setattr(U, "graph_chain_refine", refine)
    monkeypatch.setattr(U, "ul_band_err", band_err)
    trace.reset()
    U.ul_align(utgs, uls, ug=tg, device="cpu")
    assert U.STATS["screen_launches"] == 1
    assert calls[0] == U.STATS["screen_rows"]
    assert len(calls) == 1 + U.STATS["junction_launches"]
    n_chains = 0
    for ul, ov, ok, rej, low in seen:
        want = ([], [], [])
        for o in range(len(ov)):
            if ov.score[o] < 8:
                if ov.score[o] >= 4:
                    want[2].append(o)
                continue
            tgt = utgs[int(ov.y_id[o])]
            tgt = revcomp_codes(tgt) if ov.rev[o] else tgt
            h = slice(ov.hit_start[o], ov.hit_start[o] + ov.n_hits[o])
            ok_j = J._verify_block(ul, tgt, ov.hit_self[h], ov.hit_t[h])
            want[0 if ok_j else 1].append(o)
        assert (ok, rej, low) == want
        n_chains += len(ov)
    assert sum(len(s[3]) for s in seen) > 0      # a rescue pool was live
    assert n_chains > 1


# ---- the pure host functions ------------------------------------------


def _random_paths(rng, n=24, n_utg=9):
    """Block strings from a few base walks, some with a mutated block,
    reversed copies among them."""
    base = [list(rng.integers(0, n_utg, int(rng.integers(3, 8))))
            for _ in range(3)]
    out = []
    for i in range(n):
        walk = list(base[i % 3])
        if rng.random() < 0.3:
            walk[int(rng.integers(1, len(walk) - 1))] = int(
                rng.integers(0, n_utg))
        rev = [int(r) for r in rng.integers(0, 2, len(walk))]
        blocks = [(int(u), r, 100 * k, 100 * k + 90)
                  for k, (u, r) in enumerate(zip(walk, rev))]
        if rng.random() < 0.3:
            blocks = [(u, 1 - r, qs, qe) for u, r, qs, qe in blocks[::-1]]
        out.append(blocks)
    return out


def _paths(mod, blocks):
    return [mod.ULPath(list(b)) for b in blocks]


def _random_graph(rng, n_utg=9, n_arcs=14):
    arcs = {(int(s), int(d)) for s, d in rng.integers(0, 2 * n_utg,
                                                       (n_arcs, 2))}
    return _graphs([1000] * n_utg, [(s, d, 0) for s, d in sorted(arcs)])


def _gapfill_fixture(mod_store, mod_cov, mod_unitig, mod_graph, rng_seed):
    rng = np.random.default_rng(rng_seed)
    g = make_genome(rng, 250)
    r0, r1, gap = g[:100], g[150:250], g[100:150]
    store = mod_store.from_arrays(["r0", "r1"], [r0.copy(), r1.copy()])
    cov = mod_cov.full(store.lens)
    ug = mod_graph(
        utgs=[mod_unitig(np.array([0 << 1], np.uint32),
                         np.array([100], np.int64), 100, False, 0, 1),
              mod_unitig(np.array([1 << 1], np.uint32),
                         np.array([100], np.int64), 100, False, 2, 3)])
    ug.a_src = np.array([0 << 1 | 0, 1 << 1 | 1], np.uint32)
    ug.a_dst = np.array([1 << 1 | 0, 0 << 1 | 1], np.uint32)
    ug.a_ol = np.zeros(2, np.int64)
    ul = np.concatenate([r0, gap, r1])
    blocks = [[(0, 0, 0, 100), (1, 0, 150, 250)] for _ in range(3)]
    return store, cov, ug, blocks, [ul] * 3


def _check_integer_correction(rng):
    for blocks in (_random_paths(rng), _random_paths(rng, 40, 5)):
        jp, tp = _paths(J, blocks), _paths(U, blocks)
        assert U.integer_correction(tp) == J.integer_correction(jp)
        assert [p.blocks for p in tp] == [p.blocks for p in jp]


def _check_catalog_correction(rng):
    for blocks in (_random_paths(rng), _random_paths(rng, 40, 5)):
        jp, tp = _paths(J, blocks), _paths(U, blocks)
        assert U.catalog_correction(tp, min_occ=3) == \
            J.catalog_correction(jp, min_occ=3)
        assert [p.blocks for p in tp] == [p.blocks for p in jp]


def _check_ul_catalog(rng):
    blocks = _random_paths(rng, 30, 6)
    assert U.ul_catalog(_paths(U, blocks)) == J.ul_catalog(_paths(J, blocks))


def _check_ul_renew_graph(rng):
    for _ in range(3):
        jg, tg = _random_graph(rng)
        blocks = _random_paths(rng)
        J.ul_renew_graph(jg, _paths(J, blocks))
        U.ul_renew_graph(tg, _paths(U, blocks))
        assert _arcs(tg) == _arcs(jg)


def _check_ul_path_drop_ladder(rng):
    for _ in range(3):
        jg, tg = _random_graph(rng, n_arcs=30)
        blocks = _random_paths(rng, 40)
        assert U.ul_path_drop_ladder(tg, _paths(U, blocks)) == \
            J.ul_path_drop_ladder(jg, _paths(J, blocks))
        assert _arcs(tg) == _arcs(jg)


def _check_ul_refine_blocks(rng):
    g = make_genome(rng, 2000)
    utgs = [g[:900], g[1100:]]
    blocks = [[(0, 0, 0, 840), (1, 0, 1160, 2000)],
              [(0, 0, 0, 930), (1, 0, 1080, 2000)]]
    reads = [g.copy(), inject_errors(rng, g.copy(), 0.03)]
    # reverse-strand junctions: the read of the other strand
    blocks.append([(1, 1, 0, 880), (0, 1, 1120, 2000)])
    reads.append(revcomp_codes(g))
    jp, tp = _paths(J, blocks), _paths(U, blocks)
    assert U.ul_refine_blocks(tp, reads, utgs) == \
        J.ul_refine_blocks(jp, reads, utgs)
    assert [p.blocks for p in tp] == [p.blocks for p in jp]


def _check_ul_gap_sequences(rng):
    _, _, _, blocks, uls = _gapfill_fixture(JStore, JCov, JUnitig, JGraph, 5)
    blocks = blocks + [[(1, 1, 0, 100), (0, 1, 140, 250)]]
    uls = uls + [revcomp_codes(uls[0])]
    want = J.ul_gap_sequences(_paths(J, blocks), uls)
    got = U.ul_gap_sequences(_paths(U, blocks), uls)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _check_ul_fill_bridged(rng):
    out = []
    for mods in ((JStore, JCov, JUnitig, JGraph, J),
                 (ReadStore, CoverageCut, Unitig, UnitigGraph, U)):
        store, cov, ug, blocks, uls = _gapfill_fixture(*mods[:4], 5)
        new = mods[4].ul_fill_bridged(ug, store, cov,
                                      _paths(mods[4], blocks), uls)
        out.append((new, [(u.vs.tolist(), u.node_len.tolist(), u.len,
                           u.circ, u.start, u.end) for u in ug.utgs],
                    _arcs(ug), list(store.names),
                    [store.get_codes(i).tolist() for i in range(store.n_reads)],
                    cov.s.tolist(), cov.e.tolist(), cov.del_.tolist()))
    assert out[1] == out[0]
    assert len(out[1][0]) == 1 and len(out[1][1]) == 1


HOST = {"integer_correction": _check_integer_correction,
        "catalog_correction": _check_catalog_correction,
        "ul_catalog": _check_ul_catalog,
        "ul_renew_graph": _check_ul_renew_graph,
        "ul_path_drop_ladder": _check_ul_path_drop_ladder,
        "ul_refine_blocks": _check_ul_refine_blocks,
        "ul_gap_sequences": _check_ul_gap_sequences,
        "ul_fill_bridged": _check_ul_fill_bridged}


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_function_matches_jax(name):
    HOST[name](np.random.default_rng(sorted(HOST).index(name) + 7))


def test_catalog_keeps_repeat_crossing_read():
    """The JAX package's catalog scenario: a read of the repeat's second
    copy keeps its block, a mis-mapped block is fixed, in both."""
    G, C, Y, D, H, E, R, F, X = range(9)

    def walks(ws):
        return [[(u, 0, 100 * i, 100 * i + 90) for i, u in enumerate(w)]
                for w in ws]

    for ws in ([[G, C, Y, D, H]] * 4 + [[E, C, R, D, F]],
               [[E, C, R, D, F]] * 3 + [[E, C, X, D, F]]):
        jp, tp = _paths(J, walks(ws)), _paths(U, walks(ws))
        assert U.catalog_correction(tp, min_occ=3) == \
            J.catalog_correction(jp, min_occ=3)
        assert [p.blocks for p in tp] == [p.blocks for p in jp]


# ---- affine extension ------------------------------------------------------


def _affine_pairs(rng):
    pairs = [(np.zeros(0, np.uint8), np.zeros(4, np.uint8)),
             (np.zeros(4, np.uint8), np.zeros(0, np.uint8)),
             (np.zeros(0, np.uint8), np.zeros(0, np.uint8))]
    for _ in range(30):
        n = int(rng.integers(5, 80))
        x = rng.integers(0, 4, n).astype(np.uint8)
        y = x.copy()
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, len(y)))
            y[p] = (y[p] + 1) & 3
        if rng.random() < 0.5 and len(y) > 10:
            p = int(rng.integers(2, len(y) - 4))
            y = np.concatenate([y[:p], y[p + int(rng.integers(1, 3)):]])
        pairs.append((x, y))
    for _ in range(10):                       # unrelated pairs
        pairs.append((rng.integers(0, 4, int(rng.integers(1, 60))).astype(
            np.uint8), rng.integers(0, 4, int(rng.integers(1, 60))).astype(
            np.uint8)))
    return pairs


@pytest.mark.parametrize("bw", [4, 16, 32])
def test_affine_extend_matches_jax(bw):
    from hifiasm_tpu.ops.affine import affine_extend, affine_extend_scalar
    from hifiasm_tpu_torch.ops import affine as A

    for x, y in _affine_pairs(np.random.default_rng(bw)):
        want = affine_extend(x, y, bw=bw)
        assert A.affine_extend(x, y, bw=bw) == want
        assert A.affine_extend_scalar(x, y, bw=bw) == \
            affine_extend_scalar(x, y, bw=bw)


# ---- K2's plain version on the UL rows --------------------------------


def _screen_edge_rows(rng):
    """Screen rows as ``_screen_rows`` makes them: hits at a unitig's
    start (y begins with code-4 padding inside ylen), at its end (ylen
    short of xlen + 2e), x cut short at a read's end, x holding code 4
    (an N), diverged and unrelated windows."""
    tgt = make_genome(rng, 3000)
    rows = []
    for k in range(60):
        kind = k % 6
        t0 = [int(rng.integers(0, 15)), int(rng.integers(2930, 2990)),
              int(rng.integers(100, 2800))][min(kind, 2)]
        ul = tgt[max(t0 - 10, 0):t0 + 200].copy()
        q0 = t0 - max(t0 - 10, 0)
        if kind == 2:
            ul = ul[:q0 + int(rng.integers(20, 75))]   # read end
        elif kind == 3:
            ul[rng.random(len(ul)) < 0.05] = 4          # Ns
        elif kind == 4:
            ul = inject_errors(rng, ul, 0.2)
        elif kind == 5:
            ul = rng.integers(0, 4, len(ul)).astype(np.uint8)
        rows += U._screen_rows(ul, tgt, np.array([q0]), np.array([t0]))
    return rows, U.SCREEN_E


def _junction_edge_rows(rng, e):
    """Junction rows as ``graph_chain_paths`` makes them at band ``e``:
    the target from e bases before x's position, cut at
    ``min(len(tgt), len(x) + 2e)`` (short at a unitig's end), x of 20 to
    140 bp with Ns and errors, spliced through an unrelated unitig."""
    g = make_genome(rng, 4000)
    other = make_genome(rng, 400)
    rows = []
    for k in range(48):
        lx = [140, 140, 75, 20, 139, 64][k % 6]
        p = int(rng.integers(e, 3800 - lx))
        x = g[p:p + lx].copy()
        if k % 4 == 1:
            x[rng.random(lx) < 0.05] = 4
        if k % 3 == 2:
            x = inject_errors(rng, x, 0.12)[:140]
        tgt = g[p - e:]
        if k % 5 == 3:                          # unitig ends in the window
            tgt = g[p - e:p + int(rng.integers(1, lx))]
        elif k % 5 == 4:                        # splice into another unitig
            tgt = np.concatenate([g[p - e:p + lx // 2], other])
        m = min(len(tgt), len(x) + 2 * e)
        rows.append((x, tgt[:m], m))
    return rows, e


@pytest.mark.parametrize("site,e", [("screen", 15)] +
                         [("junction", e) for e in range(8, 32)])
def test_k2_plain_matches_banded_batch_np_on_ul_rows(site, e, monkeypatch):
    """K2's plain version, through ``ul_band_err`` on CPU tensors, gives
    ``banded_batch_np``'s err on every row, packed to the batch's XL or
    alone at its own length (the JAX package's shapes)."""
    rng = np.random.default_rng(100 + e)
    rows, e = _screen_edge_rows(rng) if site == "screen" else \
        _junction_edge_rows(rng, e)
    calls, orig = [], U.ul_band_err
    monkeypatch.setattr(U, "ul_band_err",
                        lambda *a: calls.append(a) or orig(*a))
    got = U._score_rows(rows, e, "cpu", site)
    X, xl, Y, yl, _, _ = calls[0]
    assert len(calls) == 1 and X.shape[1] == max(len(r[0]) for r in rows)
    np.testing.assert_array_equal(
        got, banded_batch_np(X, xl, Y, yl, e, traceback=False).err)
    for (x, y, m), g in zip(rows, got):
        yb = np.full((1, len(x) + 2 * e), 4, np.uint8)
        yb[0, :len(y)] = y
        one = banded_batch_np(x[None, :].copy(), np.array([len(x)]), yb,
                              np.array([m]), e, traceback=False).err[0]
        assert g == one
    assert (got >= 0).any() and (got < 0).any()
    assert (yl < xl + 2 * e).any() and (X == 4).any()
    if site == "screen":
        assert (xl < 75).any() and (Y[:, 0] == 4).any()


# ---- end to end ------------------------------------------------------------


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">u{i}\n{NT[s].tobytes().decode()}\n")


def _scenario(name, d):
    """tests/test_ul_assembly.py:19 (``spanning``: three 5% error UL reads
    over a 20 kb genome) and tests/test_ul_gapfill.py:68 (``gapfill``:
    HiFi coverage with a 3 kb hole that three UL reads span)."""
    rng = np.random.default_rng(11)
    if name == "spanning":
        g = make_genome(rng, 20000)
        reads, _, _ = sample_reads(rng, g, depth=12, read_len=2000,
                                   err_rate=0.002)
        uls = [inject_errors(rng, g[1000:19000].copy(), 0.05)
               for _ in range(3)]
    else:
        g = make_genome(rng, 30000)
        left, _, _ = sample_reads(rng, g[:14000], depth=14, read_len=2500,
                                  err_rate=0.002)
        right, _, _ = sample_reads(rng, g[17000:], depth=14, read_len=2500,
                                   err_rate=0.002)
        reads = left + right
        uls = [g[10000:21000].copy() for _ in range(3)]
    _write_fasta(d / f"{name}_ul.fa", uls)
    return [f"r{i}" for i in range(len(reads))], reads, \
        {"ul_reads": [str(d / f"{name}_ul.fa")], "ul_min_base": 1000}


@pytest.fixture(scope="module")
def ul_runs(tmp_path_factory):
    """Both scenarios assembled by both packages from the reads."""
    d = tmp_path_factory.mktemp("torch_ul")
    out = {}
    for name in ("spanning", "gapfill"):
        names, reads, kw = _scenario(name, d)
        jax_assemble(JStore.from_arrays(names, reads),
                     _jcfg(str(d / f"{name}_jax"), **kw))
        trace.reset()
        res = assemble(ReadStore.from_arrays(names, reads),
                       _port_cfg(str(d / f"{name}_port"), **kw),
                       device="cpu")
        out[name] = (names, reads, kw, res, dict(U.STATS))
    return d, out


@pytest.mark.parametrize("name", ["spanning", "gapfill"])
def test_ul_assembly_matches_jax(ul_runs, name):
    d, out = ul_runs
    _, _, _, res, st = out[name]
    _assert_same(d, f"{name}_jax", f"{name}_port",
                 must=("bp.p_ctg.gfa", "bp.p_utg.gfa", "bp.r_utg.gfa",
                       "p_ctg.fa"))
    assert st["passes"] == 2 and st["mapped"] > 0, st
    assert st["screen_launches"] == 2, st
    assert res.stage_s["ul"] > 0 and "clean_unitig" in res.stage_s
    if name == "gapfill":
        assert any(n.startswith("ulg") for n in res.store.names)


def test_resume_from_jax_ul_cache(ul_runs):
    """The port resumes from the EC checkpoint and the ``.ul.aln.bin``
    that the JAX package wrote: it maps only once (the re-map after
    renewal; the cached paths replace the first pass) and writes the
    JAX package's bytes."""
    d, out = ul_runs
    names, _, kw, _, _ = out["spanning"]
    src = str(d / "spanning_jax")
    dst = str(d / "resume_port")
    for a, b in zip(checkpoint_paths(src), checkpoint_paths(dst)):
        shutil.copyfile(a, b)
    shutil.copyfile(f"{src}.ul.aln.bin", f"{dst}.ul.aln.bin")
    trace.reset()
    res = assemble(ReadStore.from_arrays(["x"], [np.zeros(10, np.uint8)]),
                   _port_cfg(dst, ignore_bin=False, **kw), device="cpu")
    assert res.store.n_reads == len(names)
    assert U.STATS["passes"] == 1, U.STATS
    _assert_same(d, "spanning_jax", "resume_port", must=("bp.p_ctg.gfa",))


def test_cli_ul_matches_jax(ul_runs):
    from hifiasm_tpu_torch.cli import main

    d, out = ul_runs
    names, reads, kw, _, _ = out["gapfill"]
    fa = d / "gapfill_reads.fa"
    with open(fa, "w") as f:
        for n, r in zip(names, reads):
            f.write(f">{n}\n{NT[r].tobytes().decode()}\n")
    assert main([str(fa), "-o", str(d / "cli_port"), "-r", "1", "-i",
                 "--ul", kw["ul_reads"][0], "--ul-cut", "1000",
                 "--device", "cpu"]) == 0
    _assert_same(d, "gapfill_jax", "cli_port", must=("bp.p_ctg.gfa",))
