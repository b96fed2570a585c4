"""The port's device sketch (hifiasm_tpu_torch/ops/sketch_dev.py) against
the JAX package's (hifiasm_tpu/ops/sketch_jax.py) and the host sketch
(ops/sketch.sketch_read), on the CPU, tolerance zero.

The cases are tests/test_sketch_jax.py's, with its reads and parameters:
four (k, w) pairs with edge-case reads (empty, shorter than k, all N,
one homopolymer), a filter table, ``is_unique``, and HiFi-shaped reads
at (51, 51).  Each case also runs the port at two or three row counts a
chunk.  Half of all k-mer hashes have bit 63 set, so a signed compare
anywhere in the window minimum would pick other minimizers than the
host's; the int64 hash itself is held to the uint64 one alone."""

import numpy as np
import pytest
import torch

from hifiasm_tpu.index.pos_table import FilterTable as JFilterTable
from hifiasm_tpu.ops.sketch_jax import sketch_many_jax
from hifiasm_tpu_torch.convert import minimizers_from_reference
from hifiasm_tpu_torch.index.pos_table import FilterTable
from hifiasm_tpu_torch.ops.sketch import all_kmers_read, sketch_read
from hifiasm_tpu_torch.ops.sketch_dev import (
    default_rows, sketch_many_device, yak_hash64_i64,
)
from hifiasm_tpu_torch.ops.hashes import yak_hash64_np
from tests.test_sketch_jax import _random_reads

FIELDS = ("hash", "pos", "rev", "span", "cnt")


def _same(a, b, tag):
    assert len(a) == len(b), tag
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f"{tag}: {f} dtype"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}: {f}")


def _check(reads, k, w, jax_kw, ft=None, is_unique=False, rows=(1, 5)):
    """The port at two chunk sizes == JAX == host, read by read."""
    jft = None if ft is None else JFilterTable(ft.hashes, ft.counts,
                                               ft.cutoff)
    jax = [minimizers_from_reference(**{f: np.asarray(getattr(m, f))
                                        for f in FIELDS})
           for m in sketch_many_jax(reads, k, w, ft=jft, is_unique=is_unique,
                                    **jax_kw)]
    runs = [sketch_many_device(reads, k, w, ft=ft, is_unique=is_unique,
                               device="cpu", row_chunk=r) for r in rows]
    lookup = None if ft is None else ft.lookup
    hosts = []
    for i, r in enumerate(reads):
        host = sketch_read(r, k, w, lookup, is_unique=is_unique)
        _same(jax[i], host, f"read {i}: jax")
        for rc, run in zip(rows, runs):
            _same(run[i], host, f"read {i}: row_chunk {rc}")
        hosts.append(host)
    assert sum(map(len, hosts)) > len(reads)
    return hosts


@pytest.mark.parametrize("k,w", [(7, 5), (17, 11), (31, 17), (51, 51)])
def test_sketch_dev_matches_jax_and_host(k, w):
    rng = np.random.default_rng(11)
    reads = _random_reads(rng, 24)
    reads += [np.zeros(0, np.uint8),
              rng.integers(0, 4, max(k - 2, 1)).astype(np.uint8),
              np.full(80, 4, np.uint8),
              np.full(120, 2, np.uint8)]
    _check(reads, k, w, dict(row_chunk=8, l_bucket=64), rows=(1, 7, 0))


def _table(reads, k, rng, frac, scale):
    allh = np.concatenate([all_kmers_read(r, k) for r in reads])
    uniq, cnts = np.unique(allh, return_counts=True)
    sel = rng.random(len(uniq)) < frac
    return FilterTable(hashes=uniq[sel],
                       counts=np.minimum(cnts[sel] * scale, 2000).astype(
                           np.uint16), cutoff=5)


def test_sketch_dev_filter_table():
    rng = np.random.default_rng(7)
    reads = _random_reads(rng, 16, lmin=200, lmax=1200, n_rate=0.003)
    ft = _table(reads, 17, rng, 0.3, 40)
    _check(reads, 17, 11, dict(row_chunk=8, l_bucket=128), ft=ft)


def test_sketch_dev_is_unique():
    rng = np.random.default_rng(3)
    reads = _random_reads(rng, 10, lmin=150, lmax=600, n_rate=0.0)
    ft = _table(reads, 17, rng, 1.0, 1)
    _check(reads, 17, 11, dict(row_chunk=4, l_bucket=128), ft=ft,
           is_unique=True)


def test_sketch_dev_long_reads_realistic():
    """HiFi-shaped reads at the production (k=51, w=51) parameters, with
    a filter table holding 98% of the k-mers: the host high-occurrence
    filter drops most minimizers and rescues some in long streaks."""
    rng = np.random.default_rng(5)
    reads = _random_reads(rng, 6, lmin=8000, lmax=15000, n_rate=0.0005)
    ft = _table(reads, 51, rng, 0.98, 40)
    hosts = _check(reads, 51, 51, dict(row_chunk=4), ft=ft, rows=(2, 0))
    assert any((m.cnt > 0).any() for m in hosts)


def test_yak_hash64_i64_matches_uint64():
    """The int64 hash equals the numpy uint64 one on keys with bit 63
    (and every other high bit) set."""
    rng = np.random.default_rng(1)
    keys = np.concatenate([
        rng.integers(0, 2 ** 64 - 1, 4000, dtype=np.uint64),
        np.array([0, 1, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1], np.uint64)])
    got = yak_hash64_i64(torch.from_numpy(keys.view(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), yak_hash64_np(keys))
    assert (got < 0).any() and (got >= 0).any()


def test_sketch_dev_device_rule():
    """The entry point runs on the CPU only when asked; the default row
    count bounds a chunk's planes."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sketch_many_device([np.zeros(100, np.uint8)], 17, 11)
    assert sketch_many_device([], 17, 11, device="cpu") == []
    assert default_rows(16384) * 16384 * 320 <= 1 << 31
    assert default_rows(10 ** 12) == 1
