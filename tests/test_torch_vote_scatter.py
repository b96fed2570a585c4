"""The EC vote kernel (hifiasm_tpu_torch/ops/vote_scatter.py,
csrc/vote_scatter.cu) against its plain version, and ec/device_ec.py's
vote functions against a spare-slot ``index_add_`` oracle kept here
(masked entries go to the accumulator's spare last slot, which counts
them), tolerance zero: the accumulators and the dropped counts are
integers and must be equal bit for bit.

The CPU cases run everywhere.  The ``cuda``-marked cases skip without a
card; on one they run with ``python -m pytest --noconftest -m cuda
tests/test_torch_vote_scatter.py`` (this file imports no JAX)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import hifiasm_tpu_torch.ec.device_ec as D
from hifiasm_tpu_torch.ops import vote_scatter as V
from hifiasm_tpu_torch.utils import trace

FORMS = ("L2", "L4", "seam")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _windows(rng, N, XL, rows, L):
    """A batch of windows over ``rows`` read rows of width ``L``: ragged
    xlen (some past XL), window starts near the read's end (pos >= qlen),
    masked windows, tb == 5, ic > 8 and ib >= 4."""
    qlen_row = rng.integers(L // 2, L + 1, rows)
    q_row = rng.integers(0, rows, N)
    qlen = qlen_row[q_row]
    q_ws = (rng.random(N) * qlen).astype(np.int64)
    q_ws[: N // 8] = np.maximum(qlen[: N // 8] - rng.integers(1, XL, N // 8),
                                0)
    xlen = rng.integers(0, XL + 1, N)
    xlen[rng.random(N) < 0.05] = XL + 7
    mask = rng.random(N) < 0.7
    tb = rng.integers(0, 6, (N, XL)).astype(np.uint8)
    ic = np.where(rng.random((N, XL)) < 0.2, rng.integers(1, 12, (N, XL)),
                  0).astype(np.uint8)
    ib = rng.integers(0, 6, (N, XL)).astype(np.uint8)
    t = torch.as_tensor
    return dict(tb=t(tb), ic=t(ic), ib=t(ib), q_row=t(q_row), q_ws=t(q_ws),
                xlen=t(xlen), qlen_w=t(qlen), mask=t(mask))


def _seams(rng, n, rows, L):
    """Seam columns of seam_add, some out of range, some off cis."""
    n_ov = 50
    return dict(rowc=torch.as_tensor(rng.integers(-1, rows + 2, n)),
                colc=torch.as_tensor(rng.integers(-2, L + 3, n)),
                base=torch.as_tensor(rng.integers(-1, 5, n)),
                glen=torch.as_tensor(rng.integers(-1, 12, n)),
                ov=torch.as_tensor(rng.integers(0, n_ov, n)),
                is_match=torch.as_tensor(rng.integers(0, 3, n_ov)
                                         .astype(np.uint8)))


def _accs(form, rows, L, dev):
    k = (5,) if form == "L2" else (5, 1, 4, 9)
    return [torch.zeros(c * rows * L + 1, dtype=torch.int32, device=dev)
            for c in k]


def _case(form, seed, N, XL, rows=24, L=2048):
    rng = np.random.default_rng(seed)
    if form == "seam":
        return _seams(rng, N, rows, L), rows, L
    return _windows(rng, N, XL, rows, L), rows, L


def _to(d, dev):
    return {k: v.to(dev) for k, v in d.items()}


def _device_ec_route(form, d, rows, L, dev):
    """device_ec's vote functions with a VoteTally: the kernel on a card,
    the plain version on the CPU.  Returns (accumulators, tally)."""
    tally = D.VoteTally(dev)
    if form == "L2":
        acc = _accs(form, rows, L, dev)
        D.raw_counts_add(acc[0], L, d["tb"], d["q_row"], d["q_ws"],
                         d["xlen"], d["qlen_w"], d["mask"], tally)
    elif form == "L4":
        acc = _accs(form, rows, L, dev)
        D.cis_votes_add(*acc, L, d["tb"], d["ic"], d["ib"], d["q_row"],
                        d["q_ws"], d["xlen"], d["qlen_w"], d["mask"], tally)
    else:
        acc = _accs("L4", rows, L, dev)[1:]
        D.seam_add(*acc, rows, L, d["rowc"], d["colc"], d["base"], d["glen"],
                   d["ov"], d["is_match"], tally)
    return acc, tally


def _seam_entries(d, rows, L, acc):
    """(accumulator, flat index, keep) of each seam_add sub-scatter."""
    RL = rows * L
    okm = (d["is_match"][d["ov"]] == 1) & (d["rowc"] >= 0) & \
        (d["rowc"] < rows) & (d["colc"] >= 0) & (d["colc"] < L) & \
        (d["base"] >= 0) & (d["base"] < 4)
    pos = d["rowc"] * L + d["colc"]
    return ((acc[0], pos, okm), (acc[1], d["base"] * RL + pos, okm),
            (acc[2], d["glen"].clamp(max=8) * RL + pos,
             okm & (d["glen"] >= 0)))


def _spare_slot_oracle(form, d, rows, L):
    """The votes as plain ``index_add_`` calls on CPU tensors: each
    sub-scatter adds ones, and its masked entries go to the spare last
    slot of the accumulator.  Returns (accumulators, entries given,
    entries dropped: the spare slots' sum)."""
    cpu = torch.device("cpu")
    if form == "L2":
        acc = _accs(form, rows, L, cpu)
        subs = V.raw_entries(acc[0], L, d["tb"], d["q_row"], d["q_ws"],
                             d["xlen"], d["qlen_w"], d["mask"])
    elif form == "L4":
        acc = _accs(form, rows, L, cpu)
        subs = V.cis_entries(*acc, L, d["tb"], d["ic"], d["ib"], d["q_row"],
                             d["q_ws"], d["xlen"], d["qlen_w"], d["mask"])
    else:
        acc = _accs("L4", rows, L, cpu)[1:]
        subs = _seam_entries(d, rows, L, acc)
    adds = 0
    for a, idx, keep in subs:
        dump = a.numel() - 1
        idx = torch.where(keep, idx, torch.full_like(idx, dump)).reshape(-1)
        adds += idx.numel()
        a.index_add_(0, idx, torch.ones_like(idx, dtype=a.dtype))
    return acc, adds, sum(int(a[-1]) for a in acc)


def _wrapper(form, d, rows, L, dev, plain=False):
    """The vote_scatter wrapper (or, with ``plain``, its plain version)
    on fresh accumulators.  Returns (accumulators, dropped)."""
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if form == "L2":
        acc = _accs(form, rows, L, dev)
        fn = V.raw_counts_torch if plain else V.raw_counts
        fn(acc[0], L, d["tb"], d["q_row"], d["q_ws"], d["xlen"],
           d["qlen_w"], d["mask"], dropped)
    elif form == "L4":
        acc = _accs(form, rows, L, dev)
        fn = V.cis_votes_torch if plain else V.cis_votes
        fn(*acc, L, d["tb"], d["ic"], d["ib"], d["q_row"], d["q_ws"],
           d["xlen"], d["qlen_w"], d["mask"], dropped)
    else:
        acc = _accs(form, rows, L, dev)[:1]
        idx = d["rowc"].clamp(0, rows - 1) * L + d["colc"].clamp(0, L - 1)
        keep = (d["rowc"] >= 0) & (d["rowc"] < rows) & (d["colc"] >= 0) & \
            (d["colc"] < L)
        (V.masked_add_torch if plain else V.masked_add)(acc[0], idx, keep,
                                                         dropped)
    return acc, dropped


def _launches():
    return (V.raw_counts.launches, V.cis_votes.launches,
            V.masked_add.launches)


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


# ---- CPU ------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
def test_wrapper_runs_plain_on_cpu(form):
    """For CPU tensors the wrapper runs the plain version: the same
    accumulators and drops, and no kernel launch."""
    d, rows, L = _case(form, 1, 300, 40)
    n0 = _launches()
    got, dg = _wrapper(form, d, rows, L, torch.device("cpu"))
    assert _launches() == n0
    ref, dr = _wrapper(form, d, rows, L, torch.device("cpu"), plain=True)
    _same(got, ref)
    assert int(dg) == int(dr) > 0
    assert sum(int(a.sum()) for a in got) > 0


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("N,XL", [(300, 40), (97, 13)])
def test_plain_matches_spare_slot_route(form, N, XL):
    """device_ec's vote functions on the CPU (the plain version) add what
    the spare-slot index_add_ oracle adds, count the entries it is given
    and drop what its spare slots count; their own spare slots stay 0."""
    d, rows, L = _case(form, 2 + N, N, XL)
    ref, adds, dropped = _spare_slot_oracle(form, d, rows, L)
    n0 = _launches()
    acc, tally = _device_ec_route(form, d, rows, L, torch.device("cpu"))
    assert _launches() == n0
    for a, r in zip(acc, ref):
        assert torch.equal(a[:-1], r[:-1])
        assert int(a[-1]) == 0
    assert int(tally.dropped) == dropped > 0
    assert tally.adds == adds > dropped


def test_wrapper_checks():
    d, rows, L = _case("L4", 3, 20, 16)
    acc = _accs("L4", rows, L, torch.device("cpu"))
    args = [d[k] for k in ("tb", "ic", "ib", "q_row", "q_ws", "xlen",
                           "qlen_w", "mask")]

    def call(*a, acc=acc, dropped=None):
        V.cis_votes(*acc, L, *a, dropped)

    call(*args)
    with pytest.raises(TypeError):                      # int32 descriptor
        call(*args[:3], args[3].int(), *args[4:])
    with pytest.raises(ValueError):                     # ic of another shape
        call(args[0], args[1][:, :8].contiguous(), *args[2:])
    with pytest.raises(ValueError):                     # not contiguous
        call(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError):                     # mask length
        call(*args[:7], args[7][:5])
    with pytest.raises(ValueError):                     # accumulator size
        call(*args, acc=[acc[0][:-1]] + acc[1:])
    with pytest.raises(TypeError):
        call(*args, dropped=torch.zeros((), dtype=torch.int32))
    with pytest.raises(TypeError):
        V.masked_add(acc[1], args[3], args[7].int())


# ---- on the card ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("N,XL", [(D.CHUNK_CUDA, 775), (1013, 775),
                                  (257, 37)])
def test_kernel_matches_plain_on_card(form, N, XL):
    """The kernel on a full CUDA chunk and on ragged batches: its
    accumulators and dropped count equal the plain version's on .cpu()
    copies, and device_ec's vote functions on the card equal the
    spare-slot oracle (spare slots 0 on the card, the same adds and
    drops)."""
    dev = _card()
    rows, L = (128, 16384) if N == D.CHUNK_CUDA else (24, 2048)
    d, rows, L = _case(form, 40 + N + XL, N, XL, rows, L)
    n0 = _launches()
    got, dg = _wrapper(form, _to(d, dev), rows, L, dev)
    torch.cuda.synchronize()
    assert sum(_launches()) > sum(n0)
    ref, dr = _wrapper(form, d, rows, L, torch.device("cpu"), plain=True)
    _same(got, ref)
    assert int(dg) == int(dr) > 0

    got, tg = _device_ec_route(form, _to(d, dev), rows, L, dev)
    ref, adds, dropped = _spare_slot_oracle(form, d, rows, L)
    for a, r in zip(got, ref):
        assert torch.equal(a[:-1].cpu(), r[:-1])
        assert int(a[-1]) == 0
    assert int(tg.dropped) == dropped > 0
    assert tg.adds == adds


def _ec_store():
    """The store and overlaps of tests/test_torch_device_ec.py
    ``_ec_inputs``, made without the JAX package."""
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.ec.pipeline import _chain_all_reads
    from hifiasm_tpu_torch.index.pos_table import build_position_table
    from hifiasm_tpu_torch.io.readstore import ReadStore

    spec = importlib.util.spec_from_file_location(
        "synth", os.path.join(os.path.dirname(__file__), "synth.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    rng = np.random.default_rng(11)
    g = synth.make_genome(rng, 8000)
    reads, _, _ = synth.sample_reads(rng, g, depth=12, read_len=1800,
                                     err_rate=0.004)
    store = ReadStore.from_arrays([f"r{i}" for i in range(len(reads))],
                                  reads)
    cfg = HifiasmConfig()
    codes = [store.get_codes(i) for i in range(store.n_reads)]
    pt, hom, _, mzs = build_position_table(codes, cfg.k, cfg.w)
    read_ovs = _chain_all_reads(store, codes, mzs, pt, cfg,
                                hom if hom > 0 else cfg.hom_cov)
    return store, read_ovs, cfg


@pytest.mark.cuda
def test_device_ec_on_card_matches_cpu():
    """DeviceEC.process on the card (vote kernel) and on the CPU (its
    plain version): the same consensus planes, per-read results and vote
    counters."""
    dev = _card()
    store, read_ovs, cfg = _ec_store()
    runs = {}
    for d in (dev, "cpu"):
        trace.reset()
        n0 = _launches()
        runs[str(d)] = (D.DeviceEC(store, wl=cfg.ec_window,
                                   e_rate=cfg.max_ov_diff_ec,
                                   device=d).process(read_ovs),
                        D.STATS["vote_adds"], D.STATS["vote_dropped_adds"],
                        _launches()[0] - n0[0], _launches()[1] - n0[1])
    (outs_g, cns_g), adds_g, drop_g, l2, l4 = runs[str(dev)]
    (outs_c, cns_c), adds_c, drop_c, l2c, l4c = runs["cpu"]
    assert l2 > 0 and l4 > 0 and l2c == l4c == 0
    assert adds_g == adds_c > drop_g == drop_c > 0
    assert sorted(cns_g) == sorted(cns_c) and sorted(outs_g) == sorted(outs_c)
    for rid in cns_c:
        for a, b in zip(cns_g[rid], cns_c[rid]):
            np.testing.assert_array_equal(a, b)
    for rid, o in outs_c.items():
        g = outs_g[rid]
        for f in ("is_match", "win_tot", "win_ok", "err", "ts", "te",
                  "het_sites"):
            np.testing.assert_array_equal(getattr(g, f), getattr(o, f))
