"""The port's Hi-C branch (hifiasm_tpu_torch.phasing.hic and .horder, the
``hic.*`` outputs of assemble) against the JAX package's, on the CPU.

The port's seed-extend rescue runs K2's plain version
(ops/banded_fwd.banded_forward on CPU tensors) where the JAX package
calls ``banded_batch_np``; the PE hits, the misjoin breaks, the tangle
cuts, the link matrix, the scaffolds and every ``hic.*`` output must be
identical.  The JAX package runs its device-EC path (align_engine="jax",
mesh_devices=1); the variants (trio + Hi-C ``bench.tsv``, ``--n-hap 3``,
``--dual-scaf``) resume both packages from the JAX package's EC
checkpoint of the same reads.

The JAX package's output-phase sequence memo (``graph/gfa.py`` ``_useq``)
keys on ``id(u)`` alone: a unitig that ``ug_post_join`` makes after
freeing another can take the freed one's id and be written with its
sequence, so in about one run in ten its hap contigs change with the
allocator's addresses.  The port's memo holds each unitig it keys, and
``jax_assemble`` below runs the reference with that memo, so that both
write what the reference writes when no id is reused."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

import hifiasm_tpu.graph.gfa as jax_gfa
from hifiasm_tpu.assemble import assemble as _jax_assemble
from hifiasm_tpu.config import HifiasmConfig as JConfig
from hifiasm_tpu.graph.unitig import unitig_seq as jax_unitig_seq
from hifiasm_tpu.io.binfiles import checkpoint_paths
from hifiasm_tpu.io.readstore import ReadStore as JStore
from hifiasm_tpu_torch.assemble import assemble
from hifiasm_tpu_torch.convert import config_from_reference
from hifiasm_tpu_torch.io.readstore import ReadStore
from tests.synth import inject_errors, make_genome, sample_reads

NT = np.frombuffer(b"ACGT", dtype=np.uint8)
L = 16000


def _held_useq(u, store, cov, seq_cache):
    """The JAX package's ``_useq`` with the port's memo: an entry holds
    its unitig."""
    if seq_cache is None:
        return jax_unitig_seq(u, store, cov)
    hit = seq_cache.get(id(u))
    if hit is None:
        hit = seq_cache[id(u)] = (u, jax_unitig_seq(u, store, cov))
    return hit[1]


def jax_assemble(store, cfg):
    """The JAX package's assemble, its sequence memo holding its
    unitigs (see the module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gfa, "_useq", _held_useq)
        return _jax_assemble(store, cfg)


def test_seq_memo_serves_no_freed_unitig(monkeypatch):
    """Unitigs made and dropped one after another, as ``ug_post_join``
    does: CPython hands a freed unitig's address to a later one, and a
    memo keyed on ``id(u)`` alone then serves the freed one's sequence.
    The port's memo must give each unitig its own."""
    import hifiasm_tpu_torch.graph.gfa as G
    from hifiasm_tpu_torch.graph.unitig import Unitig

    monkeypatch.setattr(G, "unitig_seq", lambda u, store, cov: u.vs.copy())
    memo = {}
    for i in range(200):
        u = Unitig(vs=np.array([i], np.uint32), node_len=np.ones(1, np.int64),
                   len=1, circ=False, start=0, end=0)
        assert int(G._useq(u, None, None, memo)[0]) == i


def _write_fastq(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            txt = NT[np.clip(s, 0, 3)].tobytes().decode()
            f.write(f"@p{i}\n{txt}\n+\n{'I' * len(txt)}\n")


def _jcfg(pfx, **kw):
    kw = {"n_rounds_ec": 1, "ignore_bin": True, **kw}
    return JConfig(output_prefix=pfx, align_engine="jax", mesh_devices=1,
                   **kw)


def _port_cfg(pfx, **kw):
    return config_from_reference(dataclasses.asdict(_jcfg(pfx, **kw)))


def _outputs(d, tag):
    """Every file the run with prefix ``tag`` wrote, but its caches."""
    return sorted(f[len(tag) + 1:] for f in os.listdir(d)
                  if f.startswith(tag + ".") and not f.endswith(".bin")
                  and not f.endswith(".npz"))


def _assert_same(d, ta, tb, must=()):
    fa, fb = _outputs(d, ta), _outputs(d, tb)
    assert fa == fb
    for suf in must:
        assert suf in fa, f"{ta}.{suf} was not written"
    for suf in fa:
        with open(d / f"{ta}.{suf}", "rb") as a, \
                open(d / f"{tb}.{suf}", "rb") as b:
            assert a.read() == b.read(), f"{suf} differs"


def _pairs(rng, haps, n, err):
    """Both 150 bp mates from one haplotype, uniform positions, errors
    injected at ``err``."""
    p1, p2 = [], []
    for hap in haps:
        for _ in range(n):
            a = int(rng.integers(0, L - 150))
            b = int(rng.integers(0, L - 150))
            p1.append(inject_errors(rng, hap[a:a + 150].copy(), err))
            p2.append(inject_errors(rng, hap[b:b + 150].copy(), err))
    return p1, p2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_hic")
    rng = np.random.default_rng(11)
    h1, h2 = make_genome(rng, L, het_rate=0.002)
    r1, _, _ = sample_reads(rng, h1, depth=13, read_len=2000,
                            err_rate=0.002)
    r2, _, _ = sample_reads(rng, h2, depth=13, read_len=2000,
                            err_rate=0.002)
    reads = r1 + r2
    names = [f"r{i}" for i in range(len(reads))]
    p1, p2 = _pairs(rng, (h1, h2), 800, 0.02)
    _write_fastq(d / "hic_1.fq", p1)
    _write_fastq(d / "hic_2.fq", p2)
    (d / "pat.txt").write_text("".join(f"{n}\n" for n in names[:len(r1)]))
    (d / "mat.txt").write_text("".join(f"{n}\n" for n in names[len(r1):]))
    hic = {"hic_reads_1": [str(d / "hic_1.fq")],
           "hic_reads_2": [str(d / "hic_2.fq")]}
    return d, names, reads, hic, (h1, h2)


@pytest.fixture(scope="module")
def runs(data):
    """The Hi-C assembly by both packages from the reads (EC included)."""
    import hifiasm_tpu_torch.phasing.hic as H

    d, names, reads, hic, _ = data
    jax_assemble(JStore.from_arrays(names, reads),
                 _jcfg(str(d / "jax"), **hic))
    for k in H.STATS:
        H.STATS[k] = 0
    res = assemble(ReadStore.from_arrays(names, reads),
                   _port_cfg(str(d / "port"), **hic), device="cpu")
    return res, dict(H.STATS)


def _resumed(data, tag, **kw):
    """Both packages resumed from the JAX package's EC checkpoint with
    the options ``kw``; returns the two prefixes' tags."""
    d, names, _, _, _ = data
    stub = [np.zeros(10, np.uint8)]
    for pkg in ("jax", "port"):
        p = str(d / f"{tag}_{pkg}")
        for src, dst in zip(checkpoint_paths(str(d / "jax")),
                            checkpoint_paths(p)):
            shutil.copyfile(src, dst)
        if pkg == "jax":
            jax_assemble(JStore.from_arrays(["x"], stub),
                         _jcfg(p, ignore_bin=False, **kw))
        else:
            res = assemble(ReadStore.from_arrays(["x"], stub),
                           _port_cfg(p, ignore_bin=False, **kw),
                           device="cpu")
            assert res.store.n_reads == len(names)
    return f"{tag}_jax", f"{tag}_port"


def test_hic_outputs_match_jax(data, runs):
    d = data[0]
    _, st = runs
    assert st["rescue_rows"] > 0, st            # K2's plain version ran
    _assert_same(d, "jax", "port",
                 must=("hic.p_ctg.gfa", "hic.hap1.p_ctg.gfa",
                       "hic.hap2.p_ctg.gfa", "hic.hap1.scaf.fa",
                       "hic.hap2.scaf.fa", "hic.r_utg.gfa"))


def test_hic_stage_walls(runs):
    res, _ = runs
    assert res.stage_s["hic_map"] > 0 and res.stage_s["phase"] > 0
    assert "scaffold" in res.stage_s


def test_trio_plus_hic_bench_matches_jax(data, runs):
    d, _, _, hic, _ = data
    ta, tb = _resumed(data, "bench", fn_bin_list_pat=str(d / "pat.txt"),
                      fn_bin_list_mat=str(d / "mat.txt"), **hic)
    _assert_same(d, ta, tb, must=("bench.tsv", "hic.hap1.scaf.fa"))
    assert (d / f"{tb}.bench.tsv").stat().st_size > 0


def test_polyploid_matches_jax(data, runs):
    d, _, _, hic, _ = data
    ta, tb = _resumed(data, "poly", polyploidy=3, **hic)
    _assert_same(d, ta, tb, must=("hic.hap1.p_ctg.gfa", "hic.hap2.p_ctg.gfa",
                                  "hic.hap3.p_ctg.gfa"))


def test_dual_scaf_matches_jax(data, runs):
    d = data[0]
    ta, tb = _resumed(data, "dual", dual_scaf=True)
    _assert_same(d, ta, tb, must=("bp.hap1.scaf.fa", "bp.hap2.scaf.fa"))


# ---- the Hi-C functions on their own ----------------------------------


def _het_unitigs(rng, n=20000):
    """Two haplotypes with a het site every 40 bp (so that every mate
    carries several), the second cut in two at 9,000."""
    h1 = make_genome(rng, n)
    h2 = h1.copy()
    snp = np.arange(200, n - 200, 40)
    h2[snp] = (h2[snp] + 1) % 4
    return [h1, h2[:9000], h2[9000:]], h1, h2, snp


@pytest.fixture(scope="module")
def mapped():
    """PE hits of both packages' batched mappers on mates whose one
    flipped het site splits the vote (the rescue's case, as in
    tests/test_hic.py), with sequencing errors, mates at the unitigs'
    ends, chimeric, all-N and short mates; small batches, so that XL
    differs between them."""
    from hifiasm_tpu.phasing import hic as JH
    import hifiasm_tpu_torch.phasing.hic as H

    rng = np.random.default_rng(5)
    useqs, h1, h2, snp = _het_unitigs(rng)
    n = len(h1)
    pairs = []
    for i in range(240):
        hap = i % 2
        src, oth = (h1, h2) if hap == 0 else (h2, h1)
        ends = []
        for _ in range(2):
            s0 = int(rng.integers(0, n - 150)) if i % 7 else \
                int(rng.choice([0, 3, 8990, 9005, n - 150]))
            r = src[s0:s0 + 150].copy()
            inside = snp[(snp >= s0 + 20) & (snp < s0 + 130)]
            if len(inside) >= 3:
                p = int(inside[len(inside) // 2]) - s0
                r[p] = oth[s0 + p]
            if i % 3 == 0:
                r = inject_errors(rng, r, 0.01)
            ends.append(r)
        pairs.append(tuple(ends))
    for _ in range(20):                   # chimeric mates
        a, b = (int(x) for x in rng.integers(0, n - 150, 2))
        pairs.append((np.concatenate([h1[a:a + 75], h2[b:b + 75]]),
                      h1[a:a + 150]))
    pairs.append((np.full(150, 4, np.uint8), pairs[0][1]))
    pairs.append((pairs[1][0][:40], pairs[1][1]))
    jh = JH.map_hic_pairs_pos_batch(JH.UnitigIndex.build(useqs), pairs,
                                    utg_seqs=useqs, batch=97)
    for k in H.STATS:
        H.STATS[k] = 0
    th = H.map_hic_pairs_pos_batch(H.UnitigIndex.build(useqs), pairs,
                                   utg_seqs=useqs, batch=97, device="cpu")
    return useqs, jh, th, dict(H.STATS)


def test_map_pairs_rescue_matches_jax(mapped):
    _, jh, th, st = mapped
    assert st["rescued"] > 0, st
    assert len(th) > 0
    np.testing.assert_array_equal(jh, th)


def _edge_rows(rng, e):
    """Rescue rows at the edges: y clamped at a unitig start (short
    yseg), ylen < xlen + 2e at a unitig end, xlen = 0, an unrelated y,
    and XL = 150 (not a multiple of K2's 64-row tile)."""
    XL = 150
    g = rng.integers(0, 4, 2000).astype(np.uint8)
    rows = []
    for k in range(40):
        xl = [150, 149, 0, 37, 150][k % 5]
        start = int(rng.integers(0, 1800))
        x = inject_errors(rng, g[start:start + xl], 0.03)[:XL]
        kind = k % 4
        if kind == 0:                     # candidate near the unitig start
            cand = int(rng.integers(-5, e))
            y = g[max(cand - e, 0):max(cand + len(x) + e, 0)]
        elif kind == 1:                   # unitig ends inside the window
            y = g[start - e:start + len(x) // 2] if start >= e else g[:20]
        elif kind == 2:
            y = rng.integers(0, 4, len(x) + 2 * e).astype(np.uint8)
        else:
            y = g[max(start - e, 0):start + len(x) + e]
        rows.append((x, y))
    X = np.full((len(rows), XL), 4, np.uint8)
    Y = np.full((len(rows), XL + 2 * e), 4, np.uint8)
    xl = np.zeros(len(rows), np.int64)
    yl = np.zeros(len(rows), np.int64)
    for j, (x, y) in enumerate(rows):
        X[j, :len(x)] = x
        Y[j, :len(y)] = y
        xl[j], yl[j] = len(x), len(y)
    return X, xl, Y, yl


@pytest.mark.parametrize("e", [8, 3])
def test_rescue_align_edge_rows(e):
    from hifiasm_tpu.ops.banded_batch import banded_batch_np
    from hifiasm_tpu_torch.phasing.hic import rescue_align

    X, xl, Y, yl = _edge_rows(np.random.default_rng(3 + e), e)
    want = banded_batch_np(X, xl, Y, yl, e, traceback=False).err
    got = rescue_align(X, xl, Y, yl, e, device="cpu")
    assert (yl < xl + 2 * e).any() and (xl == 0).any()
    assert (want >= 0).any() and (want < 0).any()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_pack_rescue_rows_clamps_at_unitig_start(mapped):
    """The packer's rows for candidates at a unitig's start: y starts at
    0 and falls short of xlen + 2e, as the JAX package packs them."""
    from hifiasm_tpu.ops.banded_batch import banded_batch_np
    from hifiasm_tpu_torch.phasing.hic import pack_rescue_rows, rescue_align

    useqs = mapped[0]
    e = 8
    reads = [useqs[0][s:s + 150] for s in (0, 3, 20)] + \
        [useqs[1][len(useqs[1]) - 150:]]
    mat = np.stack(reads)
    cands = np.full((4, 2, 3), -1, np.int64)
    cands[:, 0, 0] = [0, 0, 0, 1]
    cands[:, 0, 1] = [0, 3, 20, len(useqs[1]) - 150]
    X, xl, Y, yl, rl = pack_rescue_rows(mat, np.arange(4), 0, cands, useqs,
                                        e)
    assert list(yl) == [158, 161, 166, 158]
    got = rescue_align(X, xl, Y, yl, e, device="cpu")
    np.testing.assert_array_equal(
        got, banded_batch_np(X, xl, Y, yl, e, traceback=False).err)
    assert list(got) == [0, 0, 0, 0]


def _hits(rng, n_utg, n):
    u = rng.integers(0, n_utg, (n, 2))
    p = rng.integers(0, 20000, (n, 2))
    return np.stack([u[:, 0], p[:, 0], u[:, 1], p[:, 1]], 1).astype(np.int64)


def test_dedup_and_link_matrix_match_jax(mapped):
    from hifiasm_tpu.phasing import hic as JH
    import hifiasm_tpu_torch.phasing.hic as H

    _, jh, th, _ = mapped
    n = len(mapped[0])
    hits = np.concatenate([th, th[:20], _hits(np.random.default_rng(1), n,
                                                300)])
    jd, td = JH.dedup_pe_hits(hits), H.dedup_pe_hits(hits)
    np.testing.assert_array_equal(jd, td)
    lens = np.array([len(s) for s in mapped[0]], np.int64)
    for sc in (True, False):
        a = JH.hic_link_matrix(n, jd, utg_lens=lens, sc_weight=sc)
        b = H.hic_link_matrix(n, td, utg_lens=lens, sc_weight=sc)
        assert list(a.items()) == list(b.items())


def test_switch_misjoins_match_jax():
    from hifiasm_tpu.phasing import hic as JH
    import hifiasm_tpu_torch.phasing.hic as H

    rng = np.random.default_rng(2)
    lens = np.array([30000, 8000, 9000, 7000, 40000], np.int64)
    # unitig 0: its left half contacts 1, its right half 2; 1 and 2
    # barely touch (a switch error); unitig 4 is mixed throughout
    rows = [[0, int(rng.integers(0, 12000)), 1, int(rng.integers(0, 8000))]
            for _ in range(30)]
    rows += [[2, int(rng.integers(0, 9000)), 0,
              int(rng.integers(18000, 30000))] for _ in range(25)]
    rows += [[1, 10, 2, 20]]
    noise = _hits(rng, 2, 200)              # among unitigs 3 and 4
    noise[:, [0, 2]] += 3
    hits = np.concatenate([np.array(rows, np.int64), noise])
    for ml in (10000, 0, 500_000):
        a = JH.detect_switch_misjoins(lens, hits, misjoin_len=ml)
        b = H.detect_switch_misjoins(lens, hits, misjoin_len=ml)
        assert list(a.items()) == list(b.items())
    assert 0 in H.detect_switch_misjoins(lens, hits, misjoin_len=10000)


def _graphs(seed):
    """The same random unitig graph in both packages."""
    from hifiasm_tpu.graph import unitig as JU
    from hifiasm_tpu_torch.graph import unitig as TU

    rng = np.random.default_rng(seed)
    n = 12
    m = 40
    src = rng.integers(0, 2 * n, m).astype(np.uint32)
    dst = rng.integers(0, 2 * n, m).astype(np.uint32)
    # mirror every arc, as a unitig graph holds them
    a_src = np.concatenate([src, dst ^ 1]).astype(np.uint32)
    a_dst = np.concatenate([dst, src ^ 1]).astype(np.uint32)
    a_ol = rng.integers(100, 900, 2 * m).astype(np.int64)
    out = []
    for U in (JU, TU):
        utgs = []
        for i in range(n):
            vs = (np.arange(3 * i, 3 * i + 3, dtype=np.uint32) << 1)
            utgs.append(U.Unitig(vs=vs, node_len=np.full(3, 1000, np.int64),
                                 len=3000, circ=False, start=int(vs[0]),
                                 end=int(vs[-1]) ^ 1))
        g = U.UnitigGraph(utgs)
        g.a_src, g.a_dst, g.a_ol = a_src.copy(), a_dst.copy(), a_ol.copy()
        out.append(g)
    return out, rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_tangles_matches_jax(seed):
    from hifiasm_tpu.phasing import hic as JH
    import hifiasm_tpu_torch.phasing.hic as H

    (jg, tg), rng = _graphs(seed)
    hits = _hits(rng, 12, 600)
    # strong contacts along a few arcs, so that some branches win
    for s, t in zip(jg.a_src[:6], jg.a_dst[:6]):
        hits = np.concatenate([hits, np.tile(
            [[int(s) >> 1, 5, int(t) >> 1, 7]], (8, 1))])
    na = JH.resolve_tangles_hic(jg, hits)
    nb = H.resolve_tangles_hic(tg, hits)
    assert na == nb
    for f in ("a_src", "a_dst", "a_ol"):
        np.testing.assert_array_equal(getattr(jg, f), getattr(tg, f))
    if seed == 0:
        assert nb > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_iterative_scaffold_matches_jax(seed):
    from hifiasm_tpu.phasing import horder as JO
    import hifiasm_tpu_torch.phasing.horder as O

    rng = np.random.default_rng(seed)
    n = 9
    lens = rng.integers(5000, 60000, n).astype(np.int64)
    hits = []
    # a chain 0-1-2-...: contacts near the facing ends, plus noise
    for a in range(n - 1):
        for _ in range(int(rng.integers(20, 60))):
            hits.append((a, int(lens[a]) - int(rng.integers(0, 3000)),
                         a + 1, int(rng.integers(0, 3000))))
    for _ in range(80):
        u, v = rng.integers(0, n, 2)
        hits.append((int(u), int(rng.integers(0, lens[u])), int(v),
                     int(rng.integers(0, lens[v]))))
    sa = JO.iterative_scaffold(n, lens, hits, rounds=3)
    sb = O.iterative_scaffold(n, lens, hits, rounds=3)
    assert [dataclasses.astuple(s) for s in sa] == \
        [dataclasses.astuple(s) for s in sb]
    pa = JO.scaffold_priors(sa, {i: n - 1 - i for i in range(n)})
    pb = O.scaffold_priors(sb, {i: n - 1 - i for i in range(n)})
    assert pa == pb
    seqs = [rng.integers(0, 4, int(x) // 100).astype(np.uint8) for x in lens]
    for a, b in zip(JO.scaffold_seqs(sa, seqs), O.scaffold_seqs(sb, seqs)):
        np.testing.assert_array_equal(a, b)
    sc = O.iterative_scaffold(n, lens, hits, rounds=3, prior=pb)
    sj = JO.iterative_scaffold(n, lens, hits, rounds=3, prior=pa)
    assert [dataclasses.astuple(s) for s in sj] == \
        [dataclasses.astuple(s) for s in sc]
