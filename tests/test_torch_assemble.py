"""The port's ``bp`` assembly (hifiasm_tpu_torch.assemble, device="cpu")
against the JAX package's device-EC path (hifiasm_tpu.assemble with
align_engine="jax", mesh_devices=1) on the store of
tests/test_device_frontend.py: bp.p_ctg.gfa, bp.r_utg.gfa, bp.p_utg.gfa
and p_ctg.fa must be byte-identical — fresh, on a rerun, through the
port's CLI on a FASTA file, after resuming from the JAX package's EC
checkpoint, and on the repeat-heavy store of that file with the device
front end on and off; and ``--ul`` alone and beside Hi-C and
``--dual-scaf``, resumed from that checkpoint."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from hifiasm_tpu.assemble import assemble as jax_assemble
from hifiasm_tpu.config import HifiasmConfig as JConfig
from hifiasm_tpu.io.binfiles import checkpoint_paths
from hifiasm_tpu.io.readstore import ReadStore as JStore
from hifiasm_tpu_torch.assemble import assemble
from hifiasm_tpu_torch.convert import config_from_reference
from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.utils import trace
from tests.synth import inject_errors, make_genome, sample_reads

OUTPUTS = ("bp.p_ctg.gfa", "bp.r_utg.gfa", "bp.p_utg.gfa", "p_ctg.fa")


def _reads():
    rng = np.random.default_rng(11)
    g = make_genome(rng, 12000)
    reads, _, _ = sample_reads(rng, g, depth=12, read_len=1800,
                               err_rate=0.004)
    return [f"r{i}" for i in range(len(reads))], reads


def _jcfg(pfx, **kw):
    kw = {"n_rounds_ec": 1, "ignore_bin": True, **kw}
    return JConfig(output_prefix=pfx, align_engine="jax", mesh_devices=1,
                   **kw)


def _port_cfg(pfx, **kw):
    """The port's config, carried over from the JAX package's."""
    d = dataclasses.asdict(_jcfg(pfx, **kw))
    return config_from_reference(d)


def _read(pfx, suffix):
    with open(f"{pfx}.{suffix}", "rb") as f:
        return f.read()


def _assert_same(pa, pb):
    for suffix in OUTPUTS:
        a, b = _read(pa, suffix), _read(pb, suffix)
        assert a, f"{pa}.{suffix} is empty"
        assert a == b, f"{suffix} differs"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_asm")
    names, reads = _reads()
    pj = str(d / "jax")
    jax_assemble(JStore.from_arrays(names, reads), _jcfg(pj))
    pt = str(d / "port")
    assemble(ReadStore.from_arrays(names, reads), _port_cfg(pt),
             device="cpu")
    return d, names, reads, pj, pt


def test_assemble_matches_jax(runs):
    _, _, _, pj, pt = runs
    _assert_same(pj, pt)


def test_rerun_identical(runs):
    d, names, reads, _, pt = runs
    p2 = str(d / "port2")
    assemble(ReadStore.from_arrays(names, reads), _port_cfg(p2),
             device="cpu")
    _assert_same(pt, p2)


def test_cli_matches_jax(runs):
    from hifiasm_tpu_torch.cli import main

    d, names, reads, pj, _ = runs
    fa = d / "reads.fa"
    with open(fa, "w") as f:
        for n, r in zip(names, reads):
            f.write(f">{n}\n{''.join('ACGT'[c] for c in r)}\n")
    pc = str(d / "cli")
    assert main([str(fa), "-o", pc, "-r", "1", "-i",
                 "--device", "cpu"]) == 0
    _assert_same(pj, pc)


def test_resume_from_jax_checkpoint(runs):
    """The port loads the EC checkpoint the JAX package wrote and writes
    the same GFA as the JAX package resumed from it."""
    d, names, reads, pj, _ = runs
    outs = {}
    for tag in ("jax_resumed", "port_resumed"):
        p = str(d / tag)
        for src, dst in zip(checkpoint_paths(pj), checkpoint_paths(p)):
            shutil.copyfile(src, dst)
        outs[tag] = p
    stub = [np.zeros(10, np.uint8)]
    jax_assemble(JStore.from_arrays(["x"], stub),
                 _jcfg(outs["jax_resumed"], ignore_bin=False))
    res = assemble(ReadStore.from_arrays(["x"], stub),
                   _port_cfg(outs["port_resumed"], ignore_bin=False),
                   device="cpu")
    assert res.store.n_reads == len(names)       # the checkpoint's reads
    _assert_same(outs["jax_resumed"], outs["port_resumed"])


@pytest.mark.parametrize("frontend", [True, False])
def test_repeat_heavy_matches_jax(repeat_runs, frontend):
    """Multi-copy chains, quota and dedup through the port's device front
    end (and its host chain path) against the JAX package's device front
    end, byte for byte."""
    import hifiasm_tpu_torch.ec.pipeline as P

    d, names, reads, pj = repeat_runs
    pt = str(d / f"port_fe{int(frontend)}")
    n0 = P.STATS["frontend_rounds"]
    assemble(ReadStore.from_arrays(names, reads),
             _port_cfg(pt, device_frontend=frontend), device="cpu")
    assert P.STATS["frontend_rounds"] - n0 == int(frontend)
    _assert_same(pj, pt)


@pytest.fixture(scope="module")
def repeat_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_asm_rep")
    rng = np.random.default_rng(7)
    g = make_genome(rng, 16000, repeat_frac=0.3)
    reads, _, _ = sample_reads(rng, g, depth=14, read_len=2200,
                               err_rate=0.004)
    names = [f"r{i}" for i in range(len(reads))]
    pj = str(d / "jax")
    jax_assemble(JStore.from_arrays(names, reads), _jcfg(pj))
    return d, names, reads, pj


def test_unported_branches_raise(runs):
    """--ul, the branch off bp that the port once refused, now runs alone
    and beside the other branches: UL, UL + Hi-C and UL + --dual-scaf,
    each resumed from the JAX package's EC checkpoint, write the JAX
    package's bytes (the reference run with the port's sequence memo,
    tests/test_torch_hic.py ``jax_assemble``)."""
    import hifiasm_tpu_torch.ul as ul_mod
    from tests.test_torch_hic import _assert_same as assert_all_same
    from tests.test_torch_hic import jax_assemble as jax_held_memo

    d, names, _, pj, _ = runs
    g = make_genome(np.random.default_rng(11), 12000)   # _reads' genome
    rng = np.random.default_rng(5)
    nt = np.frombuffer(b"ACGT", np.uint8)
    with open(d / "ul.fa", "w") as f:
        for i in range(3):
            ul = inject_errors(rng, g[500:11500].copy(), 0.05)
            f.write(f">u{i}\n{nt[ul].tobytes().decode()}\n")
    mates = ([], [])
    for a, b in rng.integers(0, len(g) - 150, (400, 2)):
        mates[0].append(inject_errors(rng, g[a:a + 150].copy(), 0.01))
        mates[1].append(inject_errors(rng, g[b:b + 150].copy(), 0.01))
    for k, m in enumerate(mates):
        with open(d / f"hic_{k + 1}.fq", "w") as f:
            for i, s in enumerate(m):
                f.write(f"@p{i}\n{nt[s].tobytes().decode()}\n+\n"
                        f"{'I' * len(s)}\n")
    ul = {"ul_reads": [str(d / "ul.fa")], "ignore_bin": False}
    stub = [np.zeros(10, np.uint8)]
    for tag, kw, must in (
            ("ul", ul, ("bp.p_ctg.gfa",)),
            ("ul_hic", {**ul, "hic_reads_1": [str(d / "hic_1.fq")],
                        "hic_reads_2": [str(d / "hic_2.fq")]},
             ("hic.p_ctg.gfa", "hic.hap1.p_ctg.gfa", "hic.hap1.scaf.fa")),
            ("ul_dual", {**ul, "dual_scaf": True},
             ("bp.hap1.scaf.fa", "bp.hap2.scaf.fa"))):
        for pkg in ("jax", "port"):
            p = str(d / f"{tag}_{pkg}")
            for src, dst in zip(checkpoint_paths(pj), checkpoint_paths(p)):
                shutil.copyfile(src, dst)
            if pkg == "jax":
                jax_held_memo(JStore.from_arrays(["x"], stub), _jcfg(p, **kw))
            else:
                trace.reset()
                res = assemble(ReadStore.from_arrays(["x"], stub),
                               _port_cfg(p, **kw), device="cpu")
                assert res.store.n_reads == len(names)
                assert "ul" in res.stage_s
                assert ul_mod.STATS["mapped"] >= 3, ul_mod.STATS
        assert_all_same(d, f"{tag}_jax", f"{tag}_port", must=must)


def test_default_device_raises_without_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    names, reads = _reads()
    with pytest.raises(RuntimeError, match="CUDA"):
        assemble(ReadStore.from_arrays(names, reads),
                 _port_cfg(str(tmp_path / "x")))
    assert not os.listdir(tmp_path)
