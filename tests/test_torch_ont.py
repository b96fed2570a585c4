"""The port's ONT mode (``--ont``: hifiasm's WINDOW_OHC of 375 bases in
EC, the el rescue of one-sided overlaps, the chemical-arc chimera cut)
against the JAX package on the CPU: a small repeat-bearing ONT store
(``chip_smoke.ont_store``: 20 kb with three copies of a 500-base repeat,
12x, 3 kb reads at ONT R10 errors, 5% chimeric, a store on which the el
rescue keeps records and the chemical-arc rule cuts reads) assembled
with the bloom filter on
(-f37) gives the same bp.p_ctg.gfa (and unitig graphs and contig FASTA)
and the same corrected reads, byte for byte, with the host DAG pass on
one thread or three (the native host library's OpenMP threads); K1's plain version at XL
375 equals ``banded_batch_np`` on ONT-error windows; and the counters
that the ONT path feeds are filled.  The CUDA side of the same contract
is ``python3 chip_smoke.py --ont`` on the card (phases 11 and 11b)."""

import numpy as np
import pytest
import torch

import hifiasm_tpu_torch.ec.device_ec as D
import hifiasm_tpu_torch.ec.pipeline as P
import hifiasm_tpu_torch.graph.sg as S
from chip_smoke import k1_ont_windows, ont_store
from hifiasm_tpu.assemble import assemble as jax_assemble
from hifiasm_tpu.config import HifiasmConfig as JConfig
from hifiasm_tpu.io.readstore import ReadStore as JStore
from hifiasm_tpu.ops.banded_batch import banded_batch_np
from hifiasm_tpu_torch.assemble import assemble
from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.ops.banded_tb import banded_tb_torch
from hifiasm_tpu_torch.utils import trace

OUTPUTS = ("bp.p_ctg.gfa", "bp.r_utg.gfa", "bp.p_utg.gfa", "p_ctg.fa")
# the ONT options of the benchmark's ont_r10 configuration; one EC round
# keeps the JAX package's run short
ONT = {"is_ont": True, "bf_shift": 37, "n_rounds_ec": 1}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ont")
    store = ont_store()
    reads = [store.get_codes(i).copy() for i in range(store.n_reads)]
    names = [f"r{i}" for i in range(store.n_reads)]
    pj = str(d / "jax")
    jres = jax_assemble(JStore.from_arrays(names, reads),
                        JConfig(output_prefix=pj, ignore_bin=True,
                                align_engine="jax", mesh_devices=1, **ONT))
    pt = str(d / "port")
    trace.reset()
    res = assemble(store, HifiasmConfig(output_prefix=pt, ignore_bin=True,
                                        mesh_devices=1, **ONT),
                   device="cpu")
    counters = {"D": dict(D.STATS), "S": dict(S.STATS), "P": dict(P.STATS),
                "stage": dict(res.stage_s)}
    return pj, pt, jres, res, counters


@pytest.mark.parametrize("suffix", OUTPUTS)
def test_ont_outputs_match_jax(runs, suffix):
    pj, pt, _, _, _ = runs
    with open(f"{pj}.{suffix}", "rb") as f:
        want = f.read()
    with open(f"{pt}.{suffix}", "rb") as f:
        got = f.read()
    assert got, f"{pt}.{suffix} is empty"
    assert got == want, f"{suffix} differs from the JAX package's"


def test_ont_corrected_reads_match_jax(runs):
    _, _, jres, res, _ = runs
    assert res.store.n_reads == jres.store.n_reads
    for i in range(res.store.n_reads):
        np.testing.assert_array_equal(res.store.get_codes(i),
                                      jres.store.get_codes(i))


def test_ont_counters(runs):
    """K1 ran over 375 rows a window, pass 1 and retries alike; both ONT
    graph branches acted on the store (so the byte-for-byte cases above
    cover them), and the chimeric-cut span is there."""
    _, _, _, _, c = runs
    d = c["D"]
    assert d["windows"] > 0
    assert d["k1_rows"] == 375 * (d["windows"] + d["retry_windows"])
    assert set(c["S"]) == {"el_rescued", "chem_cut_reads"}
    assert c["S"]["el_rescued"] > 0
    assert c["S"]["chem_cut_reads"] > 0
    assert c["stage"]["chimeric"] > 0


def test_ont_host_dag_workers_match_serial(runs, tmp_path):
    """The host DAG pass over three OpenMP threads of the native host
    library (``-t 3``) gives the one-thread run's outputs and corrected
    reads, byte for byte, over the same reads, all of them served by the
    native call."""
    _, pt, _, res, c = runs
    assert c["P"]["host_dag_reads"] > 1
    assert c["P"]["host_dag_native_reads"] == c["P"]["host_dag_reads"]
    p3 = str(tmp_path / "t3")
    trace.reset()
    res3 = assemble(ont_store(), HifiasmConfig(
        output_prefix=p3, ignore_bin=True, mesh_devices=1, threads=3, **ONT),
        device="cpu")
    assert P.STATS["host_dag_reads"] == c["P"]["host_dag_reads"]
    assert P.STATS["host_dag_native_reads"] == P.STATS["host_dag_reads"]
    for suffix in OUTPUTS:
        with open(f"{pt}.{suffix}", "rb") as f, \
                open(f"{p3}.{suffix}", "rb") as g:
            assert g.read() == f.read(), f"{suffix} differs with -t 3"
    for i in range(res.store.n_reads):
        np.testing.assert_array_equal(res3.store.get_codes(i),
                                      res.store.get_codes(i))


@pytest.mark.parametrize("seed", [3, 4])
def test_k1_plain_matches_oracle_at_ont_width(seed):
    """K1's plain version at XL 375, e 31 on windows of ONT-error reads,
    short last windows and cut targets among them: every output equals
    the host oracle's."""
    x, xlen, y, ylen = k1_ont_windows(np.random.default_rng(seed), 96)
    ref = banded_batch_np(x, xlen, y, ylen, 31, traceback=True)
    out = [o.numpy() for o in banded_tb_torch(
        *[torch.as_tensor(a) for a in (x, xlen, y, ylen)], 31)]
    for got, want in zip(out, (ref.err, ref.y_start, ref.y_end, ref.tb_base,
                               ref.ins_cnt, ref.ins_base)):
        np.testing.assert_array_equal(got, want)
    assert (ref.err >= 0).sum() > 60 and (xlen < 375).any()
