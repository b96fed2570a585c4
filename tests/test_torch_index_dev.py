"""The port's device table build and per-read anchor gather
(hifiasm_tpu_torch/index/pos_table_dev.py) against the JAX package's
(hifiasm_tpu/index/pos_table_jax.py) and the host build and gather
(index/pos_table.build_position_table, overlap/anchors.
collect_anchors_many), on the CPU, tolerance zero.

The cases are tests/test_pos_table_jax.py's, with its stores: the table
with its peaks, the anchors over many small chunks, the tandem repeat
that reaches the high-occurrence weights, a read-length table past 2^20
reads (the JAX package's "wide" sort), and the empty table; then the
device sketch and build end to end (``build_position_table_device``,
tests/test_chain_device.py's store) against the JAX package's, with the
device-built table serving the front end's grouped gather."""

import numpy as np
import pytest
import torch

from hifiasm_tpu.index.pos_table import build_position_table as j_build
from hifiasm_tpu.index.pos_table_jax import (
    build_position_table_device as j_build_device,
    build_position_table_jax, collect_anchors_device as j_anchors,
)
from hifiasm_tpu.ops.sketch import Minimizers as JMinimizers
from hifiasm_tpu_torch.convert import (
    minimizers_from_reference, table_from_reference,
)
from hifiasm_tpu_torch.index.pos_table import build_position_table
from hifiasm_tpu_torch.index.pos_table_dev import (
    build_position_table_device, build_table_device,
    collect_anchor_groups_device, collect_anchors_device,
    device_table_from_host,
)
from hifiasm_tpu_torch.ops.sketch import Minimizers
from hifiasm_tpu_torch.overlap.anchors import collect_anchors_many
from tests.synth import make_genome, sample_reads
from tests.test_pos_table_jax import _reads_with_overlaps

PT_FIELDS = ("hashes", "start", "count", "rid", "pos", "rev", "span")
TBL_FIELDS = ("keys", "start", "count", "rid", "pos", "rev", "span")
AN_FIELDS = ("tid", "rev", "self_off", "t_off", "span", "weight")


def _jax_table(jt):
    """The JAX package's device table as the port's."""
    return table_from_reference(
        **{f: np.asarray(getattr(jt, f)) for f in
           ("h_hi", "h_lo", "start", "count", "rid", "pos", "rev", "span")},
        n_distinct=jt.n_distinct, tot_pos=jt.tot_pos)


def _same_table(a, b):
    for f in TBL_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f)


def _same_pt(a, b):
    for f in PT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _same_anchors(a, b, tag):
    assert len(a) == len(b), tag
    for i, (x, y) in enumerate(zip(a, b)):
        assert len(x) == len(y), f"{tag} read {i}: {len(x)} vs {len(y)}"
        for f in AN_FIELDS:
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype, f"{tag} read {i}: {f} dtype"
            np.testing.assert_array_equal(u, v,
                                          err_msg=f"{tag} read {i}: {f}")


def _builds(reads, k=17, w=11):
    """Host builds of both packages and the port's device build."""
    pt, ph, pht, mzs = build_position_table(reads, k, w)
    jpt, jph, jpht, jmzs = j_build(reads, k, w)
    tbl, dph, dpht = build_table_device(mzs, device="cpu")
    assert (ph, pht) == (jph, jpht) == (dph, dpht)
    return pt, mzs, jmzs, tbl


def test_device_table_matches_jax_and_host():
    reads = _reads_with_overlaps(np.random.default_rng(11))
    pt, mzs, jmzs, tbl = _builds(reads)
    jt, jph, jpht = build_position_table_jax(jmzs)
    _same_pt(tbl.to_host(), pt)
    _same_table(tbl, _jax_table(jt))
    _same_table(tbl, device_table_from_host(pt, "cpu"))
    assert tbl.n_distinct > 100 and tbl.tot_pos > 2 * tbl.n_distinct


def _anchors_case(reads, hom, chunk_mz, lens=None):
    pt, mzs, jmzs, tbl = _builds(reads)
    jt, _, _ = build_position_table_jax(jmzs)
    if lens is None:
        lens = np.array([len(r) for r in reads], np.int64)
    rids = list(range(len(reads)))
    host = collect_anchors_many(mzs, pt, rids, lens, hom)
    got = collect_anchors_device(mzs, tbl, rids, lens, hom,
                                 chunk_mz=chunk_mz)
    jax = j_anchors(jmzs, jt, rids, lens, hom, chunk_mz=chunk_mz)
    _same_anchors(got, host, "port")
    _same_anchors(jax, host, "jax")
    assert sum(map(len, host)) > 10 * len(reads)
    return host


def test_device_anchors_match_jax_and_host():
    reads = _reads_with_overlaps(np.random.default_rng(7), glen=6000,
                                 rlen=800, depth=5)
    _anchors_case(reads, 5, 500)          # many chunks


def test_device_anchors_high_occ_weights():
    """The 40-copy tandem repeat: occurrences reach the weight LUT's
    floor(pow(wh, 1.1)) branch."""
    rng = np.random.default_rng(3)
    g = np.tile(rng.integers(0, 4, 150).astype(np.uint8), 40)
    reads = [g[s:s + 450].copy() for s in rng.integers(0, len(g) - 450, 30)]
    host = _anchors_case(reads, 3, 400_000)
    assert any((a.weight > 2).any() for a in host)


def test_device_anchors_wide():
    """A read-length table past 2^20 reads: the JAX package switches to
    its 4-key wide sort; the port's sort is the same at any count."""
    reads = _reads_with_overlaps(np.random.default_rng(5), glen=5000,
                                 rlen=700, depth=4)
    lens = np.array([len(r) for r in reads], np.int64)
    lens = np.concatenate([lens, np.zeros((1 << 20) - len(lens) + 7,
                                          np.int64)])
    _anchors_case(reads, 5, 700, lens=lens)


def test_device_table_empty_and_tiny():
    z = lambda t: np.zeros(0, t)   # noqa: E731
    empty = Minimizers(z(np.uint64), z(np.int64), z(np.uint8),
                       z(np.int64), z(np.uint32))
    jempty = JMinimizers(z(np.uint64), z(np.int64), z(np.uint8),
                         z(np.int64), z(np.uint32))
    tbl, ph, pht = build_table_device([empty, empty], device="cpu")
    jt, jph, jpht = build_position_table_jax([jempty, jempty])
    assert tbl.n_distinct == tbl.tot_pos == jt.n_distinct == jt.tot_pos == 0
    assert (ph, pht) == (jph, jpht)
    _same_table(tbl, _jax_table(jt))
    lens = np.array([100, 100], np.int64)
    an = collect_anchors_device([empty, empty], tbl, [0, 1], lens, 3)
    assert len(an) == 2 and len(an[0]) == 0 and len(an[1]) == 0
    # one read's minimizers: every hash once, so the band filter drops all
    one = minimizers_from_reference(
        hash=np.array([5, 2 ** 63 + 1, 9], np.uint64), pos=[10, 20, 30],
        rev=[0, 1, 0], span=[17, 17, 18], cnt=[0, 0, 0])
    tbl, _, _ = build_table_device([one], device="cpu")
    assert tbl.n_distinct == 0
    tbl, _, _ = build_table_device([one, one], device="cpu")
    assert tbl.n_distinct == 3 and tbl.count.tolist() == [2, 2, 2]
    # unsigned order: the bit-63 hash sorts last
    assert tbl.to_host().hashes.tolist() == [5, 9, 2 ** 63 + 1]


def test_build_position_table_device_end_to_end():
    """The device sketch then the device build, against the JAX
    package's build_position_table_device and the host build; the
    device-built table serves the grouped gather as the uploaded host
    table does."""
    rng = np.random.default_rng(11)
    g = make_genome(rng, 40000, repeat_frac=0.25)
    reads, _, _ = sample_reads(rng, g, depth=12, read_len=5000,
                               err_rate=0.004)
    k = w = 51
    tbl, ph, pht, mzs = build_position_table_device(reads, k, w,
                                                    device="cpu")
    jt, jph, jpht, jmzs = j_build_device(reads, k, w)
    pt, hph, hpht, hmzs = build_position_table(reads, k, w)
    assert (ph, pht) == (jph, jpht) == (hph, hpht) and ph > 0
    for i, (a, b, c) in enumerate(zip(mzs, jmzs, hmzs)):
        for f in ("hash", "pos", "rev", "span", "cnt"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"read {i}: {f}")
            np.testing.assert_array_equal(getattr(a, f), getattr(c, f),
                                          err_msg=f"read {i}: {f}")
    _same_table(tbl, _jax_table(jt))
    _same_pt(tbl.to_host(), pt)
    lens = np.array([len(r) for r in reads], np.int64)
    rids = list(range(len(reads)))
    up = device_table_from_host(pt, "cpu")
    n = 0
    for (ca, ma), (cb, mb) in zip(
            collect_anchor_groups_device(mzs, tbl, rids, lens, ph,
                                         chunk_mz=20_000),
            collect_anchor_groups_device(mzs, up, rids, lens, ph,
                                         chunk_mz=20_000)):
        for f in ("g_start", "g_end", "g_read", "g_tid", "g_rev"):
            np.testing.assert_array_equal(ma[f], mb[f], err_msg=f)
        for f in ca:
            assert torch.equal(ca[f], cb[f]), f
        n += len(ma["g_start"])
    assert n > len(reads)


def test_index_dev_device_rule():
    """The new entry points run on the CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    z = Minimizers(*(np.zeros(0, t) for t in (
        np.uint64, np.int64, np.uint8, np.int64, np.uint32)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_table_device([z])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_position_table_device([np.zeros(100, np.uint8)], 17, 11)
