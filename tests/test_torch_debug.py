"""The port's debug surfaces against the JAX package's, on the CPU:
``-e/--ex-list`` (``<prefix>.trace.tsv``, and ``--ex-iter``'s
``<prefix>.extract.paf``) and ``--dbg-het-cnt``
(``<prefix>.het_cnt.log``: the JAX package's from its host phase
pass, the port's from DeviceEC's het sites).  The port runs
through its CLI with ``--device cpu``; the JAX package through
``assemble`` on its device-EC path (align_engine="jax",
mesh_devices=1)."""

import numpy as np
import pytest

from hifiasm_tpu.assemble import assemble as jax_assemble
from hifiasm_tpu.config import HifiasmConfig as JConfig
from hifiasm_tpu.io.readstore import ReadStore as JStore
from tests.synth import make_genome, sample_reads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from hifiasm_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("torch_debug")
    rng = np.random.default_rng(11)
    h1, h2 = make_genome(rng, 10000, het_rate=0.004)
    reads = []
    for h in (h1, h2):
        reads += sample_reads(rng, h, depth=8, read_len=2000,
                              err_rate=0.002)[0]
    names = [f"r{i}" for i in range(len(reads))]
    with open(d / "reads.fa", "w") as f:
        for n, r in zip(names, reads):
            f.write(f">{n}\n{''.join('ACGT'[c] for c in r)}\n")
    # two traced reads, one name absent from the store
    (d / "ex.txt").write_text("r0\nr7 extra\nnot_a_read\n")
    jax_assemble(JStore.from_arrays(names, reads), JConfig(
        output_prefix=str(d / "jax"), align_engine="jax", mesh_devices=1,
        n_rounds_ec=1, ignore_bin=True, ex_list=str(d / "ex.txt"),
        extract_iter=2, dbg_het_cnt=True))
    assert main(["-o", str(d / "port"), "-r", "1", "-i", "--device", "cpu",
                 "-e", str(d / "ex.txt"), "--ex-iter", "2",
                 "--dbg-het-cnt", str(d / "reads.fa")]) == 0
    return d, len(reads)


def _same(d, suffix):
    with open(d / f"jax.{suffix}", "rb") as a, \
            open(d / f"port.{suffix}", "rb") as b:
        da, db = a.read(), b.read()
    assert da, f"jax.{suffix} is empty"
    assert da == db, f"{suffix} differs"
    return db.decode()


def test_trace_and_extract_match_jax(runs):
    d, _ = runs
    trace = _same(d, "trace.tsv")
    assert trace.startswith("READ\tr0\t") and "\nREAD\tr7\t" in trace
    assert "\nCHAIN\tr0\t" in trace
    ext = _same(d, "extract.paf")
    assert all(len(ln.split("\t")) == 12 for ln in ext.splitlines())
    _same(d, "bp.p_ctg.gfa")


def test_het_cnt_log_matches_jax(runs):
    d, n = runs
    log = _same(d, "het_cnt.log").splitlines()
    assert len(log) == n
    cnts = [int(ln.split("\t")[1]) for ln in log]
    assert log[0].startswith(">r0\t") and max(cnts) > 0
