"""The port's trio branch (``dip.*`` outputs: binning from yak dumps or
name lists, --trio-dual, --kpt-rate's ``kdp`` graph, --skip-triobin)
against the JAX package's, on the CPU.

The yak run assembles from the reads in both packages (the JAX package
on its device-EC path, align_engine="jax", mesh_devices=1); the other
variants resume both packages from the JAX package's EC checkpoint of
the same reads.  Trio flags and every output must be identical.  The
reference runs with the port's sequence memo (``jax_assemble`` of
tests/test_torch_hic.py says why)."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from hifiasm_tpu.config import HifiasmConfig as JConfig
from hifiasm_tpu.io.binfiles import checkpoint_paths
from hifiasm_tpu.io.readstore import ReadStore as JStore
from hifiasm_tpu.trio import _read_kmers
from hifiasm_tpu_torch.assemble import assemble
from hifiasm_tpu_torch.convert import config_from_reference
from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.trio import AMBIGU, FATHER, MOTHER
from tests.synth import make_genome, sample_reads
from tests.test_torch_hic import jax_assemble
from tests.test_trio import write_yak_dump

L = 14000


def _jcfg(pfx, **kw):
    kw = {"n_rounds_ec": 1, "ignore_bin": True, **kw}
    return JConfig(output_prefix=pfx, align_engine="jax", mesh_devices=1,
                   **kw)


def _port_cfg(pfx, **kw):
    return config_from_reference(dataclasses.asdict(_jcfg(pfx, **kw)))


def _outputs(d, tag):
    return sorted(f[len(tag) + 1:] for f in os.listdir(d)
                  if f.startswith(tag + ".") and not f.endswith(".bin"))


def _assert_same(d, ta, tb, must=()):
    fa, fb = _outputs(d, ta), _outputs(d, tb)
    assert fa == fb
    for suf in must:
        assert suf in fa, f"{ta}.{suf} was not written"
    for suf in fa:
        with open(d / f"{ta}.{suf}", "rb") as a, \
                open(d / f"{tb}.{suf}", "rb") as b:
            assert a.read() == b.read(), f"{suf} differs"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_trio")
    rng = np.random.default_rng(11)
    h1, h2 = make_genome(rng, L, het_rate=0.008)
    k = 31
    k1 = np.unique(_read_kmers(h1, k)[1])
    k2 = np.unique(_read_kmers(h2, k)[1])
    write_yak_dump(str(d / "p.yak"), k, k1, np.full(len(k1), 20))
    write_yak_dump(str(d / "m.yak"), k, k2, np.full(len(k2), 20))
    r1, _, _ = sample_reads(rng, h1, depth=13, read_len=2200,
                            err_rate=0.002)
    r2, _, _ = sample_reads(rng, h2, depth=13, read_len=2200,
                            err_rate=0.002)
    reads = r1 + r2
    names = [f"r{i}" for i in range(len(reads))]
    # name lists that disagree with the yak binning on a few reads
    pat = names[:len(r1) - 3] + names[len(r1):len(r1) + 2]
    (d / "pat.txt").write_text("".join(f"{n}\n" for n in pat))
    (d / "mat.txt").write_text("".join(
        f"{n}\n" for n in names[len(r1) + 2:]))
    yak = {"fn_bin_yak_pat": str(d / "p.yak"),
           "fn_bin_yak_mat": str(d / "m.yak")}
    return d, names, reads, len(r1), yak


@pytest.fixture(scope="module")
def runs(data):
    d, names, reads, _, yak = data
    jres = jax_assemble(JStore.from_arrays(names, reads),
                        _jcfg(str(d / "jax"), **yak))
    res = assemble(ReadStore.from_arrays(names, reads),
                   _port_cfg(str(d / "port"), **yak), device="cpu")
    return jres, res


def _resumed(data, tag, **kw):
    d, names, _, _, _ = data
    stub = [np.zeros(10, np.uint8)]
    out = []
    for pkg in ("jax", "port"):
        p = str(d / f"{tag}_{pkg}")
        for src, dst in zip(checkpoint_paths(str(d / "jax")),
                            checkpoint_paths(p)):
            shutil.copyfile(src, dst)
        if pkg == "jax":
            out.append(jax_assemble(JStore.from_arrays(["x"], stub),
                                    _jcfg(p, ignore_bin=False, **kw)))
        else:
            out.append(assemble(ReadStore.from_arrays(["x"], stub),
                                _port_cfg(p, ignore_bin=False, **kw),
                                device="cpu"))
            assert out[-1].store.n_reads == len(names)
    return out


def test_yak_binning_matches_jax(data, runs):
    d, _, _, n1, _ = data
    jres, res = runs
    np.testing.assert_array_equal(np.asarray(jres.store.trio_flags),
                                  np.asarray(res.store.trio_flags))
    f = np.asarray(res.store.trio_flags)
    assert (f[:n1] == FATHER).mean() > 0.6
    assert (f[n1:] == MOTHER).mean() > 0.6
    _assert_same(d, "jax", "port",
                 must=("dip.hap1.p_ctg.gfa", "dip.hap2.p_ctg.gfa",
                       "dip.p_ctg.gfa", "dip.r_utg.gfa", "p_ctg.fa"))


def test_list_binning_matches_jax(data, runs):
    d = data[0]
    jres, res = _resumed(data, "list", fn_bin_list_pat=str(d / "pat.txt"),
                         fn_bin_list_mat=str(d / "mat.txt"))
    np.testing.assert_array_equal(np.asarray(jres.store.trio_flags),
                                  np.asarray(res.store.trio_flags))
    _assert_same(d, "list_jax", "list_port",
                 must=("dip.hap1.p_ctg.gfa", "dip.hap2.p_ctg.gfa"))


def test_trio_dual_matches_jax(data, runs):
    d, _, _, _, yak = data
    _resumed(data, "dual", trio_dual=True, **yak)
    _assert_same(d, "dual_jax", "dual_port",
                 must=("dip.hap1.p_ctg.gfa", "dip.hap2.p_ctg.gfa"))


def test_kpt_rate_matches_jax(data, runs):
    d, _, _, _, yak = data
    _resumed(data, "kdp", kpt_rate=0.6, **yak)
    _assert_same(d, "kdp_jax", "kdp_port",
                 must=("kdp.p_ctg.gfa", "kdp.p_ctg.noseq.gfa"))


def test_skip_triobin_matches_jax(data, runs):
    d, _, _, _, yak = data
    jres, res = _resumed(data, "skip", skip_triobin=True, **yak)
    f = np.asarray(res.store.trio_flags)
    assert (f == AMBIGU).all() or (f == f[0]).all()
    np.testing.assert_array_equal(np.asarray(jres.store.trio_flags), f)
    _assert_same(d, "skip_jax", "skip_port",
                 must=("dip.hap1.p_ctg.gfa", "dip.hap2.p_ctg.gfa"))
