"""The plain reference: k-mer arithmetic against a brute-force count, the
per-base edit distance against a brute-force dynamic program, and the
comparison of an assembly's outputs on hand-made GFA files."""

import numpy as np
import pytest

from benchmark.inputs import synth
from benchmark.reference import check, edits, kmers


def _brute(seq, k):
    f = r = 0
    for x in seq:
        f = f * 4 + int(x)
    for x in seq[::-1]:
        r = r * 4 + (3 - int(x))
    return min(f, r)


@pytest.mark.parametrize("k", [1, 5, 21, 31])
def test_canonical_kmers(k):
    g = np.random.default_rng(k).integers(0, 4, 3000).astype(np.uint8)
    km = kmers.canonical_kmers(g, k)
    assert len(km) == len(g) - k + 1
    assert [int(x) for x in km[::97]] == \
        [_brute(g[i:i + k], k) for i in range(0, len(g) - k + 1, 97)]
    rc = (3 - g[::-1]).astype(np.uint8)
    assert np.array_equal(np.sort(kmers.canonical_kmers(rc, k)),
                          np.sort(km))


def test_windows_with_n_are_skipped():
    g = np.random.default_rng(1).integers(0, 4, 200).astype(np.uint8)
    g[50] = 4
    assert len(kmers.canonical_kmers(g)) == 200 - 31 + 1 - 31


def test_truth_numbers():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 4, 20000).astype(np.uint8)
    b = a.copy()
    b[1000:20000:1000] ^= 1                   # 19 SNPs: haplotype b
    t = kmers.Truth([a, b])
    assert t.err_ppm([a, b, (3 - a[::-1]).astype(np.uint8)]) == 0
    bad = a.copy()
    bad[5000] ^= 2                            # in neither haplotype
    assert t.err_ppm([bad]) == pytest.approx(1e6 * 31 / (20000 - 30))
    assert t.missed_pct([a, b]) == 0
    assert t.missed_pct([a]) == pytest.approx(
        100 * 19 * 31 / len(t.all), rel=0.01)
    assert t.phase_err_pct([[a], [b]]) == 0
    mixed = np.concatenate([a[:10000], b[10000:]])   # a switch halfway
    assert t.phase_err_pct([[mixed], [b]]) == pytest.approx(100 * 9 / 38,
                                                            rel=0.01)


def _gfa(path, seqs):
    nt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"S\tctg{i}\t{nt[s].tobytes().decode()}\tLN:i:{len(s)}\n")


def _brute_edits(a, b):
    d = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        p = d[:]
        d[0] = i
        for j in range(1, len(b) + 1):
            d[j] = min(p[j - 1] + (a[i - 1] != b[j - 1]), p[j] + 1,
                       d[j - 1] + 1)
    return d[-1]


@pytest.mark.parametrize("seed", range(4))
def test_edit_dp_exact(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        a = rng.integers(0, 4, rng.integers(0, 40)).astype(np.uint8)
        b = rng.integers(0, 4, rng.integers(0, 40)).astype(np.uint8)
        assert edits._dp(a, b) == _brute_edits(a, b)
        if len(a) and len(b):
            assert edits._banded(a, b, 50) == _brute_edits(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_edit_distance_of_reads(seed):
    """HiFi errors on pieces of the repeat-rich genome, satellite units
    among them: exact where the blocks are sound, never below."""
    rng = np.random.default_rng(seed)
    g = synth.proxy_genome(rng, 60_000)
    for start in (1_000, 26_500, 30_000):          # 27-33 kb: satellite
        t = g[start:start + int(rng.integers(400, 1200))]
        r = synth._hifi_errors(rng, t, 0.01)
        assert edits.edit_distance(r, t) == _brute_edits(r, t)
    t = g[20_000:35_000]
    assert edits.edit_distance(t, t) == 0
    r = t.copy()
    r[[500, 7_500, 14_000]] ^= 1                 # 3 substitutions
    r = np.delete(r, [3_000, 9_000])              # 2 deletions
    r = np.insert(r, 11_000, [2, 2])              # 2 insertions
    assert edits.edit_distance(r, t) == 7


def test_read_corrected_toward_a_paralog():
    """A read made into another copy of a 1%-diverged repeat keeps the
    differences as errors, which no count of genome k-mers sees."""
    rng = np.random.default_rng(4)
    unit = rng.integers(0, 4, 5000).astype(np.uint8)
    copy = unit.copy()
    sites = np.arange(50, 5000, 100)              # 1% apart
    copy[sites] = (copy[sites] + 1) % 4
    g = np.concatenate([rng.integers(0, 4, 3000).astype(np.uint8), unit,
                        rng.integers(0, 4, 3000).astype(np.uint8), copy,
                        rng.integers(0, 4, 3000).astype(np.uint8)])
    truth = g[3000:8000]                           # the read lies in unit
    wrong = g[11000:16000]                         # corrected into copy
    assert kmers.Truth([g]).err_ppm([wrong]) == 0
    nums = check.numbers([g], [(wrong, truth)], [], False)
    assert nums["ec_edit_ppm"] == pytest.approx(1e6 * len(sites) / 5000)


def test_comparison_passes_and_fails(tmp_path):
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 30000).astype(np.uint8)
    good = str(tmp_path / "good.gfa")
    _gfa(good, [g[:16000], g[15000:]])
    reads = [g[i:i + 3000] for i in range(0, 27000, 1500)]
    pairs = [(r, r) for r in reads]
    limits = {"ec_edit_ppm": 100.0, "ctg_err_ppm": 100.0,
              "ctg_missed_pct": 1.0}
    nums = check.numbers([g], pairs, [good], False)
    assert nums == {"ec_edit_ppm": 0.0, "ctg_err_ppm": 0.0,
                    "ctg_missed_pct": 0.0}
    assert check.passed(check.verdict([nums], limits))

    altered = g.copy()
    altered[::1000] = (altered[::1000] + 1) % 4
    bad = str(tmp_path / "bad.gfa")
    _gfa(bad, [altered])
    for got in (check.numbers([g], pairs, [bad], False),
                check.numbers([g], [(altered, g)], [good], False),
                check.numbers([g], pairs, [str(tmp_path / "none.gfa")],
                              False)):
        assert not check.passed(check.verdict([nums, got], limits))
    half = str(tmp_path / "half.gfa")
    _gfa(half, [g[:15000]])
    assert check.numbers([g], pairs, [half], False)["ctg_missed_pct"] > 45
