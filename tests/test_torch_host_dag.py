"""The host DAG pass of reads with an ambiguity cluster, on the CPU: its
traceback strings come from the columns of K1's window results that
DeviceEC gathers on the device (``DeviceEC._dag_gather``), not from
a host re-run of the read's anchors, chain DP, banded DP, phase and
votes.

- On a repeat-bearing HiFi store (tests/test_torch_assemble.py's
  ``repeat_runs`` genome) and on the ONT store of tests/test_torch_ont.py,
  with the host re-run's functions made to raise inside ``ec.consensus``,
  the corrected reads and ``bp.p_ctg.gfa`` equal the JAX package's, byte
  for byte, with the pass on one thread (``-t 1``) and on three
  (``-t 3``), every routed read served by the native host library.
- On every routed read of those assemblies, the native pass
  (``native.dag_reads_native``) equals the port's Python ``_host_dag``;
  on made-up reads it equals the JAX package's ``dag_cluster_consensus``
  (and so its ``_star_msa_consensus``) applied by ``consensus_apply``;
  and without the native library the Python path gives the same
  assembly.
- The tracebacks a read's gathered columns rebuild (pass-1 and retry
  windows, seam insertions) equal the JAX package's host alignment
  (``hifiasm_tpu.ec.window_align.align_overlaps``) over those columns,
  and every cis overlap implies the same strings over every cluster
  range."""

import numpy as np
import pytest

import hifiasm_tpu.ec.consensus as JC
import hifiasm_tpu_torch.ec.consensus as C
import hifiasm_tpu_torch.ec.device_ec as D
import hifiasm_tpu_torch.ec.pipeline as P
import hifiasm_tpu_torch.ec.window_align as WA
import hifiasm_tpu_torch.overlap.anchors as AN
from chip_smoke import ont_store
from hifiasm_tpu_torch import native
from hifiasm_tpu.assemble import assemble as jax_assemble
from hifiasm_tpu.config import HifiasmConfig as JConfig
from hifiasm_tpu.ec.window_align import align_overlaps as jax_align_overlaps
from hifiasm_tpu.io.readstore import ReadStore as JStore
from hifiasm_tpu_torch.assemble import assemble
from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.io.readstore import ReadStore, revcomp_codes
from hifiasm_tpu_torch.utils import trace
from tests.synth import make_genome, sample_reads

ONT = {"is_ont": True, "bf_shift": 37}


def _repeat_store():
    """tests/test_torch_assemble.py's ``repeat_runs`` reads."""
    rng = np.random.default_rng(7)
    g = make_genome(rng, 16000, repeat_frac=0.3)
    reads, _, _ = sample_reads(rng, g, depth=14, read_len=2200,
                               err_rate=0.004)
    return ReadStore.from_arrays([f"r{i}" for i in range(len(reads))],
                                 reads)


CASES = {"hifi_repeat": (_repeat_store, {}), "ont": (ont_store, ONT)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's one-round assembly of each case (its host
    re-run of the ambiguous reads is the oracle)."""
    d = tmp_path_factory.mktemp("host_dag_jax")
    out = {}
    for case, (make, kw) in CASES.items():
        s = make()
        reads = [s.get_codes(i).copy() for i in range(s.n_reads)]
        pj = str(d / case)
        jres = jax_assemble(
            JStore.from_arrays(list(s.names), reads),
            JConfig(output_prefix=pj, ignore_bin=True, align_engine="jax",
                    mesh_devices=1, n_rounds_ec=1, **kw))
        out[case] = (pj, jres)
    return out


def _forbid_host_rerun(mp, rounds):
    """The host re-run's functions raise while the host DAG pass runs;
    each round's pass appends to ``rounds`` its inputs, [(rid, codes,
    ReadECOut, consensus inputs)], and its results, {rid:
    ConsensusResult}."""
    state = {"on": False}

    def guard(mod, name):
        orig = getattr(mod, name)

        def f(*a, **kw):
            if state["on"]:
                raise AssertionError(f"{name} ran inside ec.consensus")
            return orig(*a, **kw)
        mp.setattr(mod, name, f)

    for mod, name in ((AN, "chain_many"), (AN, "collect_anchors_many")):
        guard(mod, name)
    orig = P._host_dags

    def host_dags(rids, outs, cns_in, store, cfg):
        reads = [(rid, store.get_codes(rid).copy(), outs[rid],
                  tuple(a.copy() for a in cns_in[rid])) for rid in rids]
        state["on"] = True
        try:
            res = orig(rids, outs, cns_in, store, cfg)
        finally:
            state["on"] = False
        rounds.append((reads, res))
        return res
    mp.setattr(P, "_host_dags", host_dags)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """``run(case, threads)``: the port's one-round assembly of a case,
    made once for the module, with the host re-run's functions made to
    raise inside ``ec.consensus``: (output prefix, result, pipeline
    counters, DeviceEC counters, the host DAG pass of each round)."""
    d = tmp_path_factory.mktemp("host_dag_port")
    done = {}

    def run(case, threads):
        if (case, threads) not in done:
            make, kw = CASES[case]
            pt = str(d / f"{case}_t{threads}")
            rounds = []
            with pytest.MonkeyPatch.context() as mp:
                _forbid_host_rerun(mp, rounds)
                trace.reset()
                res = assemble(make(), HifiasmConfig(
                    output_prefix=pt, ignore_bin=True, mesh_devices=1,
                    n_rounds_ec=1, threads=threads, **kw), device="cpu")
            done[(case, threads)] = (pt, res, dict(P.STATS),
                                     dict(D.STATS), rounds)
        return done[(case, threads)]
    return run


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_dag_from_gathered_columns_matches_jax(jax_runs, port_runs,
                                                    case, threads):
    pj, jres = jax_runs[case]
    pt, res, ps, ds, _ = port_runs(case, threads)
    assert ps["host_dag_reads"] > 0
    assert ps["host_dag_native_reads"] == ps["host_dag_reads"]
    assert ps["dag_clusters"] >= ps["host_dag_reads"]
    assert ps["host_dag_fallback_reads"] == 0
    assert ds["dag_gather_windows"] > 0
    assert ds["dag_gather_bytes"] > 0
    assert ds["dag_gather_s"] > 0
    for i in range(res.store.n_reads):
        np.testing.assert_array_equal(res.store.get_codes(i),
                                      jres.store.get_codes(i))
    with open(f"{pj}.bp.p_ctg.gfa", "rb") as f, \
            open(f"{pt}.bp.p_ctg.gfa", "rb") as g:
        want = f.read()
        assert want and g.read() == want


def _assert_same(got, want):
    """Two ConsensusResults are equal: codes, edit count, edit trace."""
    np.testing.assert_array_equal(got.seq, want.seq)
    assert got.seq.dtype == want.seq.dtype == np.uint8
    assert got.n_corrected == want.n_corrected
    for a, b in zip(got.edits, want.edits):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_dag_matches_python(port_runs, case, threads):
    """Every routed read of a case's one-thread assembly, through the
    native pass in one call a round on 1 and 4 threads: corrected codes,
    edit count, edit trace, clusters and served flag equal the port's
    Python ``_host_dag`` on the same inputs, and the result the assembly
    used."""
    *_, rounds = port_runs(case, 1)
    n_reads = n_edited = 0
    for reads, used in rounds:
        got = native.dag_reads_native(
            [(q, eco, cns) for _, q, eco, cns in reads], threads)
        assert len(got) == len(reads)
        for (rid, q, eco, cns), (cr, n_cl, served) in zip(reads, got):
            want, want_cl, want_served = P._host_dag(q, eco, cns)
            _assert_same(cr, want)
            _assert_same(cr, used[rid])
            assert (n_cl, served) == (want_cl, want_served)
            assert served and n_cl > 0
            n_reads += 1
            n_edited += cr.n_corrected > 0
    assert n_reads > 0 and n_edited > 0


def test_python_dag_path_without_native_library(port_runs, tmp_path,
                                                 monkeypatch):
    """With ``native.get_lib()`` returning None, the HiFi repeat store
    takes the Python DAG pass (no read served natively) and gives the
    native run's corrected reads and bp.p_ctg.gfa, byte for byte."""
    pt, res, ps, _, _ = port_runs("hifi_repeat", 3)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    make, kw = CASES["hifi_repeat"]
    p2 = str(tmp_path / "python")
    trace.reset()
    res2 = assemble(make(), HifiasmConfig(
        output_prefix=p2, ignore_bin=True, mesh_devices=1, n_rounds_ec=1,
        threads=3, **kw), device="cpu")
    assert P.STATS["host_dag_native_reads"] == 0
    assert P.STATS["host_dag_reads"] == ps["host_dag_reads"] > 0
    assert P.STATS["dag_clusters"] == ps["dag_clusters"]
    for i in range(res.store.n_reads):
        np.testing.assert_array_equal(res2.store.get_codes(i),
                                      res.store.get_codes(i))
    with open(f"{pt}.bp.p_ctg.gfa", "rb") as f, \
            open(f"{p2}.bp.p_ctg.gfa", "rb") as g:
        want = f.read()
        assert want and g.read() == want


def _voter(q, lo, hi, subs=(), dels=(), ins=(), unaligned=()):
    """One overlap's traceback columns over query columns [lo, hi): the
    query's bases with substitutions ((pos, base)), deletions (4),
    insertions ((pos, count, base)) after a column and unaligned
    columns (5)."""
    tb = q[lo:hi].copy()
    ic = np.zeros(hi - lo, np.uint8)
    ib = np.zeros(hi - lo, np.uint8)
    for p, b in subs:
        tb[p - lo] = b
    for p in dels:
        tb[p - lo] = 4
    for p, c, b in ins:
        ic[p - lo] = c
        ib[p - lo] = b
    for p in unaligned:
        tb[p - lo] = 5
    return lo, tb, ic, ib


def _made_up_read(q, voters, amb_cols, het=(), trans=(), seams=()):
    """(codes, ReadECOut, consensus inputs) of a read whose overlaps'
    gathered columns are ``voters`` (``_voter``) whole; overlaps in
    ``trans`` are trans (is_match 2); ``seams`` are (overlap, column,
    gap, base) rows.  The column decisions hold a substitution, a
    deletion and an insertion away from the clusters and one
    substitution on the first ambiguous column."""
    n_ov = len(voters)
    ov = AN.OverlapRegions(0)
    ov.y_id = np.arange(1, n_ov + 1, dtype=np.uint32)
    ov.rev = np.zeros(n_ov, np.uint8)
    ov.x_s = np.array([v[0] for v in voters], np.int64)
    ov.x_e = np.array([v[0] + len(v[1]) - 1 for v in voters], np.int64)
    ov.y_s, ov.y_e = ov.x_s.copy(), ov.x_e.copy()
    is_match = np.ones(n_ov, np.uint8)
    is_match[list(trans)] = 2
    spans = np.array([len(v[1]) for v in voters], np.int64)
    dag = WA.WindowColumns(
        np.arange(n_ov, dtype=np.int64), ov.x_s.copy(), spans,
        np.cumsum(spans) - spans, *(np.concatenate([v[k] for v in voters])
                                    for k in (1, 2, 3)),
        np.array(seams, np.int64).reshape(-1, 4))
    z = np.zeros(n_ov, np.int64)
    eco = D.ReadECOut(ov, is_match, z.astype(np.int32), z.astype(np.int32),
                      z, z, z, np.array(het, np.int64), dag)
    L = len(q)
    subw = np.full(L, 15, np.uint8)
    subw[3] = (q[3] + 1) % 4
    subw[L - 5] = 4
    subw[amb_cols[0]] = (q[amb_cols[0]] + 2) % 4
    ins_p = np.zeros(L, bool)
    ins_p[L - 10] = True
    ib_ = np.zeros(L, np.uint8)
    ib_[L - 10] = 2
    il = np.zeros(L, np.uint8)
    il[L - 10] = 2
    amb = np.zeros(L, bool)
    amb[list(amb_cols)] = True
    return q, eco, (subw, ins_p, ib_, il, amb)


def _made_up_cases():
    """{name: (read, whether the JAX package's star MSA runs, whether it
    gives up (None), the replaced ranges)}."""
    q = np.random.default_rng(11).integers(0, 4, 120).astype(np.uint8)
    q[57:64] = [0, 1, 2, 3, 0, 1, 2]        # no homopolymer by column 60
    L = len(q)
    b1 = (int(q[60]) + 1) % 4
    b2 = (int(q[60]) + 2) % 4
    full = (0, L)
    cases = {}
    # homopolymer-length noise: 'b', 'bb', 'bbb' after column 60, none of
    # them a plurality; the bundle walk keeps the shared prefix
    cases["nested_insertion_bundles"] = (_made_up_read(q, [
        _voter(q, *full, ins=[(60, c, b1)]) for c in (1, 1, 1, 2, 2, 2, 3, 3)
    ], [60]), True, False, 1)
    # two strings four votes each and a column tie, which no symbol
    # wins: the backbone, the smaller string, stands; a trans overlap
    # that would break the tie is not a voter
    cases["column_and_string_ties"] = (_made_up_read(q, [
        _voter(q, *full, subs=[(60, b)]) for b in (b1,) * 4 + (b2,) * 4
    ] + [_voter(q, *full, subs=[(60, b1)])], [60], trans=[8]),
        True, False, 1)
    # one cluster over columns 20-92: a 77-base backbone, over 64, with
    # every voter's string its own
    cases["backbone_over_64"] = (_made_up_read(q, [
        _voter(q, *full, subs=[(p, (int(q[p]) + 1) % 4)])
        for p in (25, 33, 41, 49, 57, 65)
    ], list(range(20, 93, 8))), True, True, 0)
    # one covering voter and the query: fewer than OCC_TOT strings
    cases["fewer_than_occ_tot"] = (_made_up_read(q, [
        _voter(q, *full, subs=[(60, b1)]), _voter(q, 0, 50),
        _voter(q, 70, L), _voter(q, 59, L, subs=[(60, b1)])
    ], [60]), False, False, 0)
    # two clusters, a het site inside the second: only the first is
    # rewritten
    cases["het_site_in_cluster"] = (_made_up_read(q, [
        _voter(q, *full, subs=[(30, (int(q[30]) + 1) % 4),
                               (80, (int(q[80]) + 1) % 4)])
        for _ in range(5)
    ], [30, 80], het=[81]), False, False, 1)
    # three voters unaligned (5) inside the range and one starting in
    # it are no voters; the other three carry the plurality
    cases["unaligned_columns"] = (_made_up_read(q, [
        _voter(q, *full, subs=[(60, b1)], unaligned=[61])
        for _ in range(3)
    ] + [_voter(q, *full, subs=[(60, b1)]) for _ in range(3)]
        + [_voter(q, 60, L, subs=[(60, b2)])], [60]), False, False, 1)
    # insertions of 11 bases, capped at MAX_INS_TRACK in the strings; a
    # seam saturates one at 255, another adds an insertion away from the
    # cluster, a third of another base is dropped
    cases["insertions_past_max_track"] = (_made_up_read(q, [
        _voter(q, *full, ins=[(60, 11, b1)]) for _ in range(5)
    ], [60], seams=[(0, 60, 250, b1), (1, 40, 2, 3), (2, 60, 3, b2)]),
        False, False, 1)
    return cases


MADE_UP = _made_up_cases()


@pytest.mark.parametrize("case", sorted(MADE_UP) + ["all_in_one_call"])
def test_native_star_msa_matches_jax(monkeypatch, case):
    """Made-up reads through the native pass (two threads): equal to the
    JAX package's ``dag_cluster_consensus``, whose star MSA is its
    Python ``_star_msa_consensus``, applied by the port's
    ``consensus_apply``, and to the port's ``_host_dag``; the JAX star MSA
    runs (and gives up over a backbone past 64) where the case needs it.
    ``all_in_one_call`` passes every case's read to one call."""
    msa = []
    orig = JC._star_msa_consensus

    def star(*a):
        out = orig(*a)
        msa.append(out)
        return out
    monkeypatch.setattr(JC, "_star_msa_consensus", star)
    names = sorted(MADE_UP) if case == "all_in_one_call" else [case]
    reads = [MADE_UP[n][0] for n in names]
    got = native.dag_reads_native(reads, 2)
    for name, (q, eco, cns), (cr, n_cl, served) in zip(names, reads, got):
        _, runs_msa, gives_up, n_repl = MADE_UP[name]
        subw, ins_p, ib_, il, amb = cns
        clusters = C._ambiguity_clusters(amb)
        del msa[:]
        repl = JC.dag_cluster_consensus(
            q, eco.dag.tracebacks(eco.ov), np.flatnonzero(eco.is_match == 1),
            clusters, eco.het_sites)
        assert len(repl) == n_repl
        assert bool(msa) == runs_msa
        assert (None in msa) == gives_up
        want = C.consensus_apply(q, subw != 15, ins_p, subw.astype(np.int64),
                                 ib_, il.astype(np.int64) + 1, repl=repl)
        _assert_same(cr, want)
        port, port_cl, port_served = P._host_dag(q, eco, cns)
        _assert_same(cr, port)
        assert (n_cl, served) == (port_cl, port_served) == \
            (len(clusters), True)


def _retry_seam_case():
    """One overlap of a 3,100-base read onto a read that is it with one
    base inserted after query column 1084, the seam between its windows 1
    [310, 1085) and 2 [1085, 1860); a misleading chain hit sends both
    windows 60 bases off, out of the band, so pass 1 rejects them and the
    retry round aligns them (window 1 chained from window 0's end, window
    2 from window 3's start); the inserted base is then the gap between
    windows 1 and 2, a seam insertion.  Returns (store, read_ovs)."""
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, 3100).astype(np.uint8)
    x = (int(q[1084]) + 1) % 4
    if x == q[1085]:
        x = (x + 1) % 4
    t = np.concatenate([q[:1085], [x], q[1085:],
                        rng.integers(0, 4, 99)]).astype(np.uint8)
    ov = AN.OverlapRegions(0)
    ov.y_id = np.array([1], np.uint32)
    ov.rev = np.array([0], np.uint8)
    ov.x_s = np.array([0], np.int64)
    ov.x_e = np.array([3099], np.int64)
    ov.y_s = np.array([0], np.int64)
    ov.y_e = np.array([3100], np.int64)
    ov.score = np.array([100], np.int64)
    ov.hit_self = np.array([100, 1300, 2000, 3000], np.int64)
    ov.hit_t = np.array([100, 1361, 2001, 3001], np.int64)
    ov.n_hits = np.array([4], np.int64)
    ov.hit_start = np.array([0], np.int64)
    ov.hit_span = np.full(4, 19, np.int64)
    store = ReadStore.from_arrays(["q", "t"], [q, t])
    return store, [(0, ov), (1, AN.OverlapRegions(0))]


def _every_column(mp):
    """Every column of every read counts as ambiguous, so each read's one
    cluster spans it whole."""
    def amb_plane(votes, ins_tot, het_u8, bank_rows, qlen_rows):
        pos = D.torch.arange(bank_rows.shape[1])[None, :]
        return pos < qlen_rows[:, None]
    mp.setattr(D, "amb_plane", amb_plane)


def _device_ec(case, mp):
    """(store, cfg, read_ovs) of a case, with overlaps whose hits are on
    the host (so that the JAX package's ``align_overlaps`` can re-run a
    read); then DeviceEC with the gather.  Returns those and (outs,
    cns_in, the gather's arguments)."""
    if case == "retry_seam":
        cfg = HifiasmConfig(mesh_devices=1)
        store, read_ovs = _retry_seam_case()
    else:
        cfg = HifiasmConfig(mesh_devices=1, **ONT)
        store = ont_store()
        codes = [store.get_codes(i) for i in range(store.n_reads)]
        pt, peak_hom, _, mzs = P._index(codes, cfg, None)
        hom_cov = peak_hom if peak_hom > 0 else cfg.hom_cov
        read_ovs = P._chain_all_reads(store, codes, mzs, pt, cfg, hom_cov)
    if case != "ont_clusters":
        _every_column(mp)
    seen = []
    orig = D.DeviceEC._dag_gather

    def gather(dec, *a):
        seen.append(a)
        return orig(dec, *a)
    mp.setattr(D.DeviceEC, "_dag_gather", gather)
    dec = D.DeviceEC(store, wl=cfg.ec_window, e_rate=cfg.max_ov_diff_ec,
                     device="cpu")
    outs, cns_in = dec.process(read_ovs)
    return store, cfg, read_ovs, outs, cns_in, seen


@pytest.mark.parametrize("case", ["ont_clusters", "ont_every_column",
                                  "retry_seam"])
def test_gathered_columns_rebuild_host_tracebacks(monkeypatch, case):
    """Each read's tracebacks rebuilt from its gathered K1 columns equal
    the JAX package's host alignment (``align_overlaps``) over those
    columns, seam insertions included, and every cis overlap implies the
    JAX package's string over every cluster range: the ONT store's own
    clusters; the ONT store with every column ambiguous (whole reads,
    seams among them); a read whose two retried windows meet at a seam
    insertion."""
    store, cfg, read_ovs, outs, cns_in, seen = _device_ec(case, monkeypatch)

    def get_target(tid, rev):
        codes = store.get_codes(tid)
        return revcomp_codes(codes) if rev else codes

    n_reads = n_strings = n_seams = 0
    built = {}
    for rid, ov in read_ovs:
        eco = outs[rid]
        if eco.dag is None:
            assert not C._ambiguity_clusters(cns_in[rid][4])
            continue
        n_reads += 1
        q = store.get_codes(rid)
        got = eco.dag.tracebacks(ov)
        want = jax_align_overlaps(q, ov, get_target,
                                  e_rate=cfg.max_ov_diff_ec,
                                  wl=cfg.ec_window)
        cols = WA._alloc_tracebacks(ov)
        WA.scatter_segments(cols, eco.dag.o, eco.dag.col, eco.dag.n,
                            eco.dag.src, *(np.ones_like(eco.dag.tb),) * 3)
        m = cols.tb == 1
        for f in ("tb", "ins_cnt", "ins_base"):
            np.testing.assert_array_equal(getattr(got, f)[m],
                                          getattr(want, f)[m], f)
        np.testing.assert_array_equal(got.tb[~m], 5)
        built[rid] = got, want
        n_seams += len(eco.dag.seams)
        ranges = [C.cluster_range(q, cs, ce)
                  for cs, ce in C._ambiguity_clusters(cns_in[rid][4])]
        if case == "retry_seam":
            ranges += [(1075, 1095), (300, 320), (1850, 1870)]
        for cs, ce in ranges:
            for o in np.flatnonzero(eco.is_match == 1):
                if ov.x_s[o] > cs or ov.x_e[o] + 1 < ce:
                    continue
                lo, hi = cs - int(ov.x_s[o]), ce - int(ov.x_s[o])
                tw = want.view(o, "tb")[lo:hi]
                assert (got.view(o, "tb")[lo:hi] > 4).any() == \
                    (tw > 4).any()
                if (tw > 4).any():
                    continue
                n_strings += 1
                assert C._implied_string(
                    tw, want.view(o, "ins_cnt")[lo:hi],
                    want.view(o, "ins_base")[lo:hi]) == C._implied_string(
                    got.view(o, "tb")[lo:hi], got.view(o, "ins_cnt")[lo:hi],
                    got.view(o, "ins_base")[lo:hi])
    assert n_reads > 0 and n_strings > 0
    if case == "ont_every_column":
        assert n_reads == len(read_ovs) and n_seams > 0
    if case == "retry_seam":
        # windows 1 and 2 took the retry, and their seam the insertion
        (*_, ok1, w_ok, ridx, _, _, _, _, _), = seen
        np.testing.assert_array_equal(np.flatnonzero(w_ok & ~ok1), [1, 2])
        assert n_seams == 1
        got, want = built[0]
        assert want.ins_cnt[1084] == 1 and got.ins_cnt[1084] == 1
        assert C._implied_string(got.tb[1075:1095], got.ins_cnt[1075:1095],
                                 got.ins_base[1075:1095]) == \
            store.get_codes(1)[1075:1096].tobytes()
