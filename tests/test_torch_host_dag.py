"""The host DAG pass of reads with an ambiguity cluster, on the CPU: its
traceback strings come from the columns of K1's window results that
DeviceEC gathers on the device (``DeviceEC._dag_gather``), not from
a host re-run of the read's anchors, chain DP, banded DP, phase and
votes.

- On a repeat-bearing HiFi store (tests/test_torch_assemble.py's
  ``repeat_runs`` genome) and on the ONT store of tests/test_torch_ont.py,
  with the host re-run's functions made to raise inside ``ec.consensus``,
  the corrected reads and ``bp.p_ctg.gfa`` equal the JAX package's, byte
  for byte, in one process (``-t 1``) and in three workers (``-t 3``).
- The tracebacks a read's gathered columns rebuild (pass-1 and retry
  windows, seam insertions) equal the JAX package's host alignment
  (``hifiasm_tpu.ec.window_align.align_overlaps``) over those columns,
  and every cis overlap implies the same strings over every cluster
  range."""

import numpy as np
import pytest

import hifiasm_tpu_torch.ec.consensus as C
import hifiasm_tpu_torch.ec.device_ec as D
import hifiasm_tpu_torch.ec.pipeline as P
import hifiasm_tpu_torch.ec.window_align as WA
import hifiasm_tpu_torch.overlap.anchors as AN
from chip_smoke import ont_store
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


def _forbid_host_rerun(mp):
    """The host re-run's functions raise while the host DAG pass runs
    (in this process or in the workers forked from it)."""
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

    def host_dags(*a, **kw):
        state["on"] = True
        try:
            return orig(*a, **kw)
        finally:
            state["on"] = False
    mp.setattr(P, "_host_dags", host_dags)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_dag_from_gathered_columns_matches_jax(jax_runs, tmp_path,
                                                    monkeypatch, case,
                                                    threads):
    make, kw = CASES[case]
    pj, jres = jax_runs[case]
    _forbid_host_rerun(monkeypatch)
    trace.reset()
    pt = str(tmp_path / "port")
    res = assemble(make(), HifiasmConfig(
        output_prefix=pt, ignore_bin=True, mesh_devices=1, n_rounds_ec=1,
        threads=threads, **kw), device="cpu")
    assert P.STATS["host_dag_reads"] > 0
    assert P.STATS["dag_clusters"] >= P.STATS["host_dag_reads"]
    assert P.STATS["host_dag_fallback_reads"] == 0
    assert D.STATS["dag_gather_windows"] > 0
    assert D.STATS["dag_gather_bytes"] > 0
    assert D.STATS["dag_gather_s"] > 0
    for i in range(res.store.n_reads):
        np.testing.assert_array_equal(res.store.get_codes(i),
                                      jres.store.get_codes(i))
    with open(f"{pj}.bp.p_ctg.gfa", "rb") as f, \
            open(f"{pt}.bp.p_ctg.gfa", "rb") as g:
        want = f.read()
        assert want and g.read() == want


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
