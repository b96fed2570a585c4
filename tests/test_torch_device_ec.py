"""DeviceEC of the PyTorch/CUDA port (hifiasm_tpu_torch/ec/device_ec.py)
against the JAX package's hifiasm_tpu/ec/device_ec.py, on the CPU.

Every stage gets the same numpy inputs, made from a seed, in the JAX
layout and in the port's layout; every output is an integer plane and
must be exactly equal (tolerance zero).  Then ``DeviceEC.process`` of
both packages runs on the store of tests/test_device_ec.py, whole and in
small read batches."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hifiasm_tpu.ec.device_ec as J
import hifiasm_tpu_torch.ec.device_ec as T

Rp, L, XL = 12, 64, 16


def _t(a, dtype=None):
    t = torch.as_tensor(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _planes(rng, ties=False):
    hi = 3 if ties else 9
    cnt = rng.integers(0, hi, (5, Rp, L)).astype(np.int32)
    bank_rows = rng.integers(0, 5, (Rp, L)).astype(np.uint8)
    qlen = rng.integers(0, L + 1, Rp).astype(np.int32)
    qlen[0] = L
    return cnt, bank_rows, qlen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_het_planes(seed):
    rng = np.random.default_rng(seed)
    cnt, bank_rows, qlen = _planes(rng, ties=seed == 2)
    # plant adjacent pseudo-SNP pairs for the shift veto
    cnt[:, :, 10:12] = 0
    cnt[1, :, 10] = 5
    cnt[0, :, 11] = 5
    bank_rows[:, 9:13] = [1, 0, 1, 2]
    ref = J._het_planes(L, jnp.asarray(cnt), jnp.asarray(bank_rows),
                        jnp.asarray(qlen))
    got = T.het_planes(_t(cnt), _t(bank_rows), _t(qlen))
    assert int(np.asarray(ref[0]).sum()) > 0
    # JAX also returns the packed 2-bit alts, which nothing reads
    for a, b in zip((ref[0], ref[1], ref[2], ref[4]), got):
        _eq(a, b.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_decide_planes_with_ties(seed):
    rng = np.random.default_rng(10 + seed)
    votes = rng.integers(0, 3, (5, Rp, L)).astype(np.int32)   # many ties
    votes[:, 1] = 1                                            # all tied
    ins_tot = rng.integers(0, 4, (Rp, L)).astype(np.int32)
    ins_bc = rng.integers(0, 2, (4, Rp, L)).astype(np.int32)
    ins_lc = rng.integers(0, 2, (9, Rp, L)).astype(np.int32)
    ins_lc[0] = 0
    het_u8 = (rng.random((Rp, L)) < 0.1).astype(np.uint8)
    _, bank_rows, qlen = _planes(rng)
    ref = J._decide_planes(L, *(jnp.asarray(a) for a in (
        votes, ins_tot, ins_bc, ins_lc, het_u8, bank_rows, qlen)))
    got = T.decide_planes(*(_t(a) for a in (
        votes, ins_tot, ins_bc, ins_lc, het_u8, bank_rows, qlen)))
    for a, b in zip(ref, got):
        _eq(a, b.numpy())
    rb, rl = J._finalize_ins(jnp.asarray(ins_bc), jnp.asarray(ins_lc))
    gb, gl = T.finalize_ins(_t(ins_bc), _t(ins_lc))
    _eq(rb, gb.numpy())
    _eq(rl, gl.numpy())
    # the ambiguity mask a block of rows at a time (the last block
    # ragged) is the JAX package's too
    for rows in (1, 5, Rp):
        _eq(ref[4], T.amb_bits(*(_t(a) for a in (
            votes, ins_tot, het_u8, bank_rows, qlen)), rows=rows).numpy())


def test_argmax_takes_first_max():
    v = torch.tensor([[3, 7, 7, 1], [2, 2, 2, 2]], dtype=torch.int32)
    assert torch.argmax(v, dim=1).tolist() == [1, 0]
    planes = torch.zeros((5, 3, 4), dtype=torch.int32)
    planes[2] = 4
    planes[4] = 4
    assert torch.argmax(planes, dim=0).unique().tolist() == [2]


def test_classify():
    rng = np.random.default_rng(4)
    n = 200
    n_same = rng.integers(0, 4, n).astype(np.int32)
    n_flip = rng.integers(0, 4, n).astype(np.int32)
    het_cnt = rng.integers(0, 6, Rp).astype(np.int32)
    ov_qrow = rng.integers(0, Rp, n).astype(np.int32)
    usable = rng.random(n) < 0.8
    ref = J._classify_dev(*(jnp.asarray(a) for a in (
        n_same, n_flip, het_cnt, ov_qrow, usable)))
    got = T.classify(_t(n_same), _t(n_flip), _t(het_cnt),
                     _t(ov_qrow, torch.int64), _t(usable))
    _eq(ref, got.numpy())
    ok = rng.random(n) < 0.5
    ov = rng.integers(0, n, n).astype(np.int32)
    _eq(J._cis_mask_dev(jnp.asarray(ok), jnp.asarray(ov), ref),
        T.cis_mask(_t(ok), _t(ov, torch.int64), got).numpy())


def test_seam_add_drops_out_of_range():
    rng = np.random.default_rng(6)
    n = 300
    rowc = rng.integers(0, Rp + 3, n).astype(np.int32)     # some rows OOB
    colc = rng.integers(0, L, n).astype(np.int32)
    colc[:5] = L + 2                                       # cols OOB
    base = rng.integers(0, 4, n).astype(np.int32)
    glen = rng.integers(1, 12, n).astype(np.int32)
    n_ov = 40
    ov = rng.integers(0, n_ov, n).astype(np.int32)
    is_match = rng.integers(0, 3, n_ov).astype(np.uint8)
    z = [np.zeros(s, np.int32) for s in ((Rp, L), (4, Rp, L), (9, Rp, L))]
    ref = J._seam_add(*(jnp.asarray(a) for a in z), *(jnp.asarray(a) for a in (
        rowc, colc, base, glen, ov, is_match)))
    acc = [torch.zeros(a.size + 1, dtype=torch.int32) for a in z]
    T.seam_add(*acc, Rp, L, *(_t(a, torch.int64) for a in (
        rowc, colc, base, glen, ov)), _t(is_match))
    for a, b, zz in zip(ref, acc, z):
        _eq(a, b[:-1].view(zz.shape).numpy())
    assert int(np.asarray(ref[0]).sum()) > 0


def test_packers():
    rng = np.random.default_rng(8)
    b = rng.random((Rp, L)) < 0.5
    v2 = rng.integers(0, 4, (Rp, L)).astype(np.uint8)
    v4 = rng.integers(0, 16, (Rp, L)).astype(np.uint8)
    _eq(J._pack_bits(jnp.asarray(b)), T.pack_bits(_t(b)).numpy())
    _eq(J._pack2(jnp.asarray(v2)), T.pack2(_t(v2)).numpy())
    _eq(J._pack4(jnp.asarray(v4)), T.pack4(_t(v4)).numpy())


def _windows(rng, N=96, R=20):
    """One [C=1, chunk=N] stack of windows in the JAX layout."""
    qlen = rng.integers(L // 2, L + 1, R).astype(np.int32)
    q_rid = rng.integers(0, R, N).astype(np.int32)
    q_row = np.sort(rng.integers(0, Rp, N)).astype(np.int32)
    q_ws = rng.integers(0, L - 4, N).astype(np.int32)
    xlen = rng.integers(0, XL + 1, N).astype(np.int32)
    w_ok = rng.random(N) < 0.8
    tb = rng.integers(0, 6, (N, XL)).astype(np.uint8)
    ic = np.where(rng.random((N, XL)) < 0.3,
                  rng.integers(1, 12, (N, XL)), 0).astype(np.uint8)
    ib = rng.integers(0, 5, (N, XL)).astype(np.uint8)
    ov = rng.integers(0, 30, N).astype(np.int32)
    return qlen, q_rid, q_row, q_ws, xlen, w_ok, tb, ic, ib, ov


def _stack(a):
    return jnp.asarray(a.reshape(1, -1))


def test_raw_counts():
    rng = np.random.default_rng(12)
    qlen, q_rid, q_row, q_ws, xlen, w_ok, tb, _, _, _ = _windows(rng)
    ref = J._raw_counts_scan(
        XL, L, Rp, jnp.zeros((5, Rp, L), jnp.int32), jnp.asarray(qlen),
        jnp.zeros(1, jnp.int32), _stack(tb), _stack(q_rid), _stack(q_row),
        _stack(q_ws), _stack(xlen), _stack(w_ok))
    cnt = torch.zeros(5 * Rp * L + 1, dtype=torch.int32)
    T.raw_counts_add(cnt, L, _t(tb), _t(q_row, torch.int64),
                     _t(q_ws, torch.int64), _t(xlen, torch.int64),
                     _t(qlen[q_rid], torch.int64), _t(w_ok))
    _eq(ref, cnt[:-1].view(5, Rp, L).numpy())
    assert int(np.asarray(ref).sum()) > 0


def test_het_agree():
    rng = np.random.default_rng(13)
    qlen, q_rid, q_row, q_ws, xlen, w_ok, tb, _, _, ov = _windows(rng)
    tb = np.where(rng.random(tb.shape) < 0.7, rng.integers(0, 2, tb.shape),
                  tb).astype(np.uint8)
    bank_rows = rng.integers(0, 2, (Rp, L)).astype(np.uint8)
    het = (rng.random((Rp, L)) < 0.4).astype(np.uint8)
    alt = np.where(het > 0, 1 - bank_rows, 0).astype(np.uint8)
    n_ov = 30
    ref = J._het_agree_scan(
        XL, L, Rp, jnp.zeros(n_ov, jnp.int32), jnp.zeros(n_ov, jnp.int32),
        jnp.asarray(bank_rows), jnp.asarray(alt), jnp.asarray(het),
        jnp.asarray(qlen), jnp.zeros(1, jnp.int32), _stack(tb),
        _stack(q_rid), _stack(q_row), _stack(q_ws), _stack(xlen),
        _stack(w_ok), _stack(ov))
    ns = torch.zeros(n_ov + 1, dtype=torch.int32)
    nf = torch.zeros_like(ns)
    T.het_agree_add(ns, nf, _t(bank_rows), _t(alt), _t(het), _t(tb),
                    _t(q_row, torch.int64), _t(q_ws, torch.int64),
                    _t(xlen, torch.int64), _t(qlen[q_rid], torch.int64),
                    _t(w_ok), _t(ov, torch.int64))
    _eq(ref[0], ns[:-1].numpy())
    _eq(ref[1], nf[:-1].numpy())
    assert int(np.asarray(ref[0]).sum()) > 0 and \
        int(np.asarray(ref[1]).sum()) > 0


def test_cis_votes():
    rng = np.random.default_rng(14)
    qlen, q_rid, q_row, q_ws, xlen, w_ok, tb, ic, ib, _ = _windows(rng)
    z = [jnp.zeros(s, jnp.int32) for s in ((5, Rp, L), (Rp, L),
                                            (4, Rp, L), (9, Rp, L))]
    ref = J._cis_votes_scan(
        XL, L, Rp, *z, jnp.asarray(qlen), jnp.zeros(1, jnp.int32),
        _stack(tb), _stack(ic), _stack(ib), _stack(q_rid), _stack(q_row),
        _stack(q_ws), _stack(xlen), _stack(w_ok))
    acc = [torch.zeros(int(np.prod(a.shape)) + 1, dtype=torch.int32)
           for a in z]
    T.cis_votes_add(*acc, L, _t(tb), _t(ic), _t(ib),
                    _t(q_row, torch.int64), _t(q_ws, torch.int64),
                    _t(xlen, torch.int64), _t(qlen[q_rid], torch.int64),
                    _t(w_ok))
    for a, b in zip(ref, acc):
        _eq(a, b[:-1].view(a.shape).numpy())
    assert int(np.asarray(ref[3]).sum()) > 0


# ---- DeviceEC.process, both packages, on one store ----------------------

def _ec_inputs():
    from hifiasm_tpu.io.readstore import ReadStore as JStore
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.ec.pipeline import _chain_all_reads
    from hifiasm_tpu_torch.index.pos_table import build_position_table
    from hifiasm_tpu_torch.io.readstore import ReadStore
    from tests.synth import make_genome, sample_reads

    rng = np.random.default_rng(11)
    g = make_genome(rng, 8000)
    reads, _, _ = sample_reads(rng, g, depth=12, read_len=1800,
                               err_rate=0.004)
    names = [f"r{i}" for i in range(len(reads))]
    store = ReadStore.from_arrays(names, reads)
    jstore = JStore.from_arrays(names, reads)
    cfg = HifiasmConfig()
    codes = [store.get_codes(i) for i in range(store.n_reads)]
    pt, hom, _, mzs = build_position_table(codes, cfg.k, cfg.w)
    read_ovs = _chain_all_reads(store, codes, mzs, pt, cfg,
                                hom if hom > 0 else cfg.hom_cov)
    return store, jstore, read_ovs, cfg


@pytest.fixture(scope="module")
def ec_case():
    store, jstore, read_ovs, cfg = _ec_inputs()
    jdev = J.DeviceEC(jstore, wl=cfg.ec_window, e_rate=cfg.max_ov_diff_ec)
    ref = jdev.process(read_ovs)
    return store, read_ovs, cfg, ref


def _assert_same(ref, got):
    outs_r, cns_r = ref
    outs_g, cns_g = got
    assert sorted(outs_r) == sorted(outs_g)
    assert sorted(cns_r) == sorted(cns_g)
    for rid, a in outs_r.items():
        b = outs_g[rid]
        for f in ("is_match", "win_tot", "win_ok", "err", "ts", "te",
                  "het_sites"):
            _eq(getattr(a, f), getattr(b, f))
    for rid, a in cns_r.items():
        for x, y in zip(a, cns_g[rid]):
            _eq(x, y)


def test_process_matches_jax(ec_case):
    store, read_ovs, cfg, ref = ec_case
    dev = T.DeviceEC(store, wl=cfg.ec_window, e_rate=cfg.max_ov_diff_ec,
                     device="cpu")
    got = dev.process(read_ovs)
    _assert_same(ref, got)
    n_win = sum(int(o.win_tot.sum()) for o in got[0].values())
    assert n_win > 1000
    assert any((o.is_match == 1).any() for o in got[0].values())


def test_process_read_batching_identical(ec_case):
    """Bounded read batches (vote planes sized per batch) and small
    aggregation chunks must not change any output."""
    store, read_ovs, cfg, ref = ec_case
    dev = T.DeviceEC(store, wl=cfg.ec_window, e_rate=cfg.max_ov_diff_ec,
                     device="cpu", chunk=1000)
    outs, cns = {}, {}
    for b0 in range(0, len(read_ovs), 7):
        o, c = dev._process_batch(read_ovs[b0:b0 + 7])
        outs.update(o)
        cns.update(c)
    _assert_same(ref, (outs, cns))
