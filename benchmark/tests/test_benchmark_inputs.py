"""The inputs: the same seed gives the same inputs, another seed other
reads of the same genome, the reads have the traffic's depth, lengths
and error rate, and each read's origin spells its truth."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.inputs import synth
from benchmark.reference.edits import edit_distance
from benchmark.reference.kmers import Truth


def _inputs(root, cell, seed):
    spec = harness.Spec(root)
    maker = harness.InputMaker(spec, spec.cell(cell), seed)
    try:
        inp = maker.window(1)[0]
        hic = None
        if inp.hic:
            hic = [open(p, "rb").read() for p in inp.hic]
        return inp, hic
    finally:
        import shutil
        shutil.rmtree(maker.workdir)


@pytest.mark.parametrize("cell", ["tiny.haploid", "tiny.hic"])
def test_same_seed_same_inputs(tiny_root, cell):
    big = 2 ** 31 + 12345
    a, ha = _inputs(tiny_root, cell, big)
    b, hb = _inputs(tiny_root, cell, big)
    c, hc = _inputs(tiny_root, cell, big + 1)
    assert len(a.reads) == len(b.reads)
    assert all(np.array_equal(x, y) for x, y in zip(a.reads, b.reads))
    assert all(np.array_equal(x, y) for x, y in zip(a.haps, b.haps))
    assert ha == hb
    # the genome is the traffic's own; the reads are the seed's
    assert all(np.array_equal(x, y) for x, y in zip(a.haps, c.haps))
    assert len(a.reads) != len(c.reads) or not all(
        np.array_equal(x, y) for x, y in zip(a.reads, c.reads))
    if ha:
        assert ha != hc


def test_hifi_library_shape():
    rng = np.random.default_rng(7)
    g = synth.proxy_genome(rng, 200_000)
    reads, origins = synth.hifi_reads(rng, g, 30, 15000, 0.003, 0.015,
                                      0.35)
    assert origins.shape == (len(reads), 2, 3)
    assert 0.005 < (origins[:, 1, 1] > 0).mean() < 0.03      # chimeras
    lens = np.array([len(r) for r in reads])
    assert abs(lens.sum() / len(g) - 30) < 0.5
    assert 13000 < lens.mean() < 17000
    assert lens.min() >= 700
    # 31-mers of raw HiFi reads at 0.3% error: about 1 - 0.997^31 = 9%
    # miss the genome
    err = Truth([g]).err_ppm(reads[:40]) / 1e6
    assert 0.05 < err < 0.13


@pytest.mark.parametrize("cell", ["tiny.haploid", "tiny.hic"])
def test_origins_spell_the_reads(tiny_root, cell):
    """Each read of an input, reordered and re-stranded by the seed, is
    its truth with HiFi errors: about 0.3% edits, never a wrong place."""
    inp, _ = _inputs(tiny_root, cell, 2 ** 40 + 3)
    n_hap = 2 if cell == "tiny.hic" else 1
    assert set(inp.origins[:, 0, 0].tolist()) <= set(range(n_hap))
    assert set(inp.origins[:, 0, 3].tolist()) == {0, 1}
    ed = np.array([edit_distance(r, inp.truth(i))
                   for i, r in enumerate(inp.reads)])
    tot = sum(len(inp.truth(i)) for i in range(len(inp.reads)))
    assert 0.002 < ed.sum() / tot < 0.004
    assert (ed < 0.02 * np.array([len(r) for r in inp.reads])).all()


def test_dataset_seed_gives_another_genome(tiny_root):
    spec = harness.Spec(tiny_root)
    cell = spec.cell("tiny.haploid")
    got = []
    for ds in (None, 77, 77):
        maker = harness.InputMaker(spec, cell, 5, ds)
        try:
            got.append(maker.window(1)[0].haps[0])
        finally:
            import shutil
            shutil.rmtree(maker.workdir)
    assert not np.array_equal(got[0], got[1])
    assert np.array_equal(got[1], got[2])


def test_proxy_genome_repeats():
    rng = np.random.default_rng(3)
    g = synth.proxy_genome(rng, 300_000)
    u = synth.unique_genome(rng, 300_000)
    t_g, t_u = Truth([g]), Truth([u])
    # repeats: far fewer distinct 31-mers than positions in the proxy
    assert len(t_g.all) < 0.95 * (len(g) - 30)
    assert len(t_u.all) > 0.99 * (len(u) - 30)


def test_hic_pairs():
    rng = np.random.default_rng(5)
    h = synth.unique_genome(rng, 50_000)
    (s1, b1), (s2, b2) = synth.hic_pairs(rng, h, 1000, 150, 0.003)
    assert len(b1) == len(b2) == 1001
    assert abs(np.diff(b1).mean() - 150) < 1
