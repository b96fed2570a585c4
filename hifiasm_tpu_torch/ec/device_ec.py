"""Device-resident error correction on a CUDA card, on a mesh of cards
(parallel/mesh.py), or, on request, on the CPU.

The port of hifiasm_tpu/ec/device_ec.py.  The whole read store lives on
each device as a [R, 2, Lp] uint8 bank (forward and reverse-complement
planes, padded with 4).  Per batch of reads:

  L1 align     gather every window from the bank and align it with K1
               (ops/banded_tb.py); tracebacks stay on the device; one
               boundary-retry round (window_align.retry_plan)
  L2 rawcnt    allele counts per (read, pos) over accepted windows
  het          het sites + alternate alleles (the JAX package's
               ec/phase.het_from_counts, integer form)
  L3 hetagree  per-overlap agreement at het sites -> cis/trans
  L4 cisvotes  consensus votes + insertion aggregates over cis windows,
               plus the window-seam insertion votes
  L5 decide    column decisions + ambiguity mask (the JAX package's
               consensus_decide, _ambiguous_mask); only PACKED bit and
               nibble planes come back to the host

The JAX package aggregates with one-hot int8 matmuls and log-shift rolls,
which work around the TPU's slow scatters.  Here every aggregation is an
integer scatter-add at the absolute position ws + i.  Integer adds
commute, so the sums do not depend on the order and stay bit-identical
with the JAX package and the host rules.  The votes of L2, L4 and the
seams go through ops/vote_scatter.py on every device: the vote kernel on
a CUDA device, its plain version on the CPU.  Both add only the kept
entries and add the dropped ones to a count on the device
(``VoteTally``).  Every other aggregation is an ``index_add_`` in which
masked entries go to one spare slot past the end of the accumulator.

Reference scope covered: gen_hc_r_alin_ea (ecovlp.cpp:2810), rphase_hc
(:3301), wcns_gen (:2293).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hifiasm_tpu_torch.config import THRESHOLD_MAX_SIZE, WINDOW_HC
from hifiasm_tpu_torch.ec.consensus import _ambiguity_clusters, cluster_range
from hifiasm_tpu_torch.ec.window_align import (
    WindowColumns, plan_windows_many, retry_plan,
)
from hifiasm_tpu_torch.io.readstore import ReadStore, revcomp_codes
from hifiasm_tpu_torch.ops import vote_scatter
from hifiasm_tpu_torch.ops.banded_tb import banded_tb
from hifiasm_tpu_torch.overlap.anchors import OverlapRegions
from hifiasm_tpu_torch.parallel.mesh import device_of
from hifiasm_tpu_torch.utils import trace

E_BAND = THRESHOLD_MAX_SIZE          # one static band for all windows

# windows per L1 launch and per aggregation step: bounds K1's checkpoint
# scratch (128 MB at XL = 775) and the [chunk, XL] index temporaries of
# L3 (and, on the CPU, of the plain votes)
CHUNK_CUDA = 65536
CHUNK_CPU = 8192

# Left pad: y starts go negative down to -(E_BAND + window) through the
# boundary-retry plan, so the bank rows carry pad 4 there; the right pad
# covers span + realign slack.
_PAD_L = 1024
_PAD_R = 1024

# counters of the runs since the caller last reset them: windows aligned
# in L1, windows re-aligned by the retry round, the rows K1 ran over
# (windows x the window width, both passes), entries passed to the
# vote scatter-adds of L2, L4 and the seams and those of them dropped
# (masked off), and the seconds (trace.span) of the bank upload, window
# planning (host), L1 (gather + K1, synced), L2-L5 (synced at the
# packed-plane fetches) and the host work between and after them
# (ec.prep, ec.package); for the host DAG pass of reads with an
# ambiguity cluster, the windows whose columns were gathered from K1's
# outputs, the bytes fetched and the seconds of the gather
# (ec.dag_gather)
STATS = trace.register("device_ec", {
    "windows": 0, "retry_windows": 0, "k1_rows": 0, "vote_adds": 0,
    "vote_dropped_adds": 0, "bank_s": 0.0, "plan_s": 0.0, "align_s": 0.0,
    "vote_s": 0.0, "host_s": 0.0, "dag_gather_windows": 0,
    "dag_gather_bytes": 0, "dag_gather_s": 0.0})
# per shard index (0 without a mesh): windows aligned and K1 launches
SHARD_STATS: Dict[int, Dict[str, int]] = trace.register("device_ec.shards",
                                                        {})


@dataclass
class DeviceBank:
    bank: torch.Tensor     # [R, 2, Lp] uint8 (pad 4 outside the read)
    lens: torch.Tensor     # [R] int64
    L: int                 # plane width (max read length, bucketed)
    R: int
    Lp: int


def build_bank(store: ReadStore, device, l_bucket: int = 2048) -> DeviceBank:
    R = store.n_reads
    maxlen = int(store.lens.max()) if R else 1
    L = ((maxlen + l_bucket - 1) // l_bucket) * l_bucket
    Lp = _PAD_L + L + _PAD_R
    arr = np.full((max(R, 1), 2, Lp), 4, np.uint8)
    for rid in range(R):
        c = store.get_codes(rid)
        arr[rid, 0, _PAD_L:_PAD_L + len(c)] = c
        arr[rid, 1, _PAD_L:_PAD_L + len(c)] = revcomp_codes(c)
    bank = torch.from_numpy(arr).to(device)
    lens = torch.as_tensor(np.asarray(store.lens, np.int64)[:R],
                           device=device)
    return DeviceBank(bank, lens, L, R, Lp)


def _take(flat: torch.Tensor, row_base: torch.Tensor, col0: torch.Tensor,
          n: int, Lp: int) -> torch.Tensor:
    """[N, n] slices of bank rows starting at col0; 4 outside the row."""
    col = col0[:, None] + torch.arange(n, device=flat.device)[None, :]
    ok = (col >= 0) & (col < Lp)
    g = flat[row_base[:, None] + col.clamp(0, Lp - 1)]
    return torch.where(ok, g, torch.full_like(g, 4))


def gather_windows(bank: DeviceBank, XL: int, e: int, q_rid, q_ws, xlen,
                   t_rid, t_rev, t_ws, last):
    """Window inputs of K1 from the bank (port of device_ec._gather_align):
    x = query forward plane at ws, y = target plane (rev-comp when t_rev)
    from t_ws - e; ylen clips at the target's end; the last window of an
    overlap shortens x to the available y."""
    YL = XL + 2 * e
    flat = bank.bank.view(-1)
    Lp = bank.Lp
    x = _take(flat, q_rid * (2 * Lp), _PAD_L + q_ws, XL, Lp)
    y0 = t_ws - e
    y = _take(flat, (t_rid * 2 + t_rev) * Lp, _PAD_L + y0, YL, Lp)
    ylen = (bank.lens[t_rid] - y0).clamp(0, YL)
    xlen_eff = torch.where(last & (ylen < xlen), ylen, xlen)
    return (x.contiguous(), xlen_eff.int().contiguous(), y.contiguous(),
            ylen.int().contiguous())


# ---------------------------------------------------------------------------
# L2-L4: integer scatter-add aggregation at absolute read positions


class VoteTally:
    """The entries one device's vote scatter-adds are given in a batch
    (``adds``, from shapes on the host) and those dropped, in ``dropped``
    on the device, unfetched: the kernel and its plain version both add
    their dropped entries to it."""

    def __init__(self, device):
        self.adds = 0
        self.dropped = torch.zeros((), dtype=torch.int64, device=device)

    def given(self, n: int) -> torch.Tensor:
        """Counts ``n`` entries given to a vote scatter-add; returns the
        counter it adds the dropped ones to."""
        self.adds += n
        return self.dropped


def _dropped(tally: Optional[VoteTally], n: int) -> Optional[torch.Tensor]:
    return None if tally is None else tally.given(n)


def raw_counts_add(cnt: torch.Tensor, L: int, tb, q_row, q_ws, xlen,
                   qlen_w, w_ok, tally: Optional[VoteTally] = None) -> None:
    """cnt [5*Rp*L + 1] int32 += per-allele counts (port of
    _raw_counts_scan): class tb in 0..4 at (row, ws + i)."""
    vote_scatter.raw_counts(cnt, L, tb, q_row, q_ws, xlen, qlen_w, w_ok,
                            _dropped(tally, tb.numel()))


def het_agree_add(n_same: torch.Tensor, n_flip: torch.Tensor,
                  bank_rows: torch.Tensor, alt: torch.Tensor,
                  het: torch.Tensor, tb, q_row, q_ws, xlen, qlen_w, w_ok,
                  ov) -> None:
    """Per-overlap same/flip counts at het sites (port of
    _het_agree_scan); n_same/n_flip are [n_ov + 1] int32, dropped windows
    land in the spare slot."""
    XL = tb.shape[1]
    L = bank_rows.shape[1]
    pos, valid = vote_scatter.abs_index(XL, L, q_row, q_ws, xlen, qlen_w,
                                        w_ok)
    p = torch.where(valid, pos, torch.zeros_like(pos))
    qa = bank_rows.reshape(-1)[p].long()
    al = alt.reshape(-1)[p].long()
    hz = het.reshape(-1)[p]
    t = tb.long()
    validp = valid & (t <= 3) & (hz > 0)
    same_p = (validp & (t == qa)).sum(1, dtype=torch.int32)
    flip_p = (validp & (t == al)).sum(1, dtype=torch.int32)
    dump = n_same.numel() - 1
    idx = torch.where(w_ok, ov, torch.full_like(ov, dump))
    n_same.index_add_(0, idx, same_p)
    n_flip.index_add_(0, idx, flip_p)


def cis_votes_add(votes, ins_tot, ins_bc, ins_lc, L: int, tb, ic, ib,
                  q_row, q_ws, xlen, qlen_w, w_cis,
                  tally: Optional[VoteTally] = None) -> None:
    """votes [5*Rp*L+1], ins_tot [Rp*L+1], ins_bc [4*Rp*L+1],
    ins_lc [9*Rp*L+1] int32 += cis-window votes (port of
    _cis_votes_scan)."""
    vote_scatter.cis_votes(votes, ins_tot, ins_bc, ins_lc, L, tb, ic, ib,
                           q_row, q_ws, xlen, qlen_w, w_cis,
                           _dropped(tally, 4 * tb.numel()))


def seam_add(ins_tot, ins_bc, ins_lc, Rp: int, L: int, rowc, colc, base,
             glen, ov, is_match, tally: Optional[VoteTally] = None) -> None:
    """Window-SEAM insertion votes (port of _seam_add): one unit vote per
    seam of a cis overlap; out-of-range entries are dropped."""
    RL = Rp * L
    okm = (is_match[ov] == 1) & (rowc >= 0) & (rowc < Rp) & \
        (colc >= 0) & (colc < L) & (base >= 0) & (base < 4)
    pos = rowc * L + colc
    subs = ((ins_tot, pos, okm), (ins_bc, base * RL + pos, okm),
            (ins_lc, glen.clamp(max=8) * RL + pos, okm & (glen >= 0)))
    for acc, idx, keep in subs:
        vote_scatter.masked_add(acc, idx, keep, _dropped(tally, idx.numel()))


def classify(n_same, n_flip, het_cnt, ov_qrow, usable) -> torch.Tensor:
    """classify_overlaps (the JAX package's ec/phase.py): 1 cis, 2 trans,
    0 unusable; min_flip is 1 on reads with >= 3 het sites, else 2."""
    min_flip = torch.where(het_cnt[ov_qrow] >= 3, 1, 2)
    trans = usable & (n_flip > n_same) & (n_flip >= min_flip)
    return torch.where(usable, torch.where(trans, 2, 1), 0).to(torch.uint8)


def cis_mask(okm, ov, is_match) -> torch.Tensor:
    return okm & (is_match[ov] == 1)


# ---------------------------------------------------------------------------
# het detection + consensus decisions; thresholds are the integer-exact
# forms of the host rules (x > 0.500001*cov <=> 2x > cov, x > 0.25*cov
# <=> 4x > cov), bit-identical with the JAX package's
# ec/phase.het_from_counts and ec/consensus.consensus_decide /
# _ambiguous_mask


def pack_bits(b: torch.Tensor) -> torch.Tensor:
    """[Rp, L] bool -> [Rp, L//8] u8 (little bit order)."""
    Rp, L = b.shape
    w = b.reshape(Rp, L // 8, 8).int()
    sh = torch.arange(8, device=b.device, dtype=torch.int32)
    return (w << sh).sum(2, dtype=torch.int32).to(torch.uint8)


def pack2(v: torch.Tensor) -> torch.Tensor:
    """[Rp, L] 2-bit values -> [Rp, L//4] u8."""
    Rp, L = v.shape
    w = v.reshape(Rp, L // 4, 4).int()
    sh = torch.arange(0, 8, 2, device=v.device, dtype=torch.int32)
    return (w << sh).sum(2, dtype=torch.int32).to(torch.uint8)


def pack4(v: torch.Tensor) -> torch.Tensor:
    """[Rp, L] 4-bit values -> [Rp, L//2] u8."""
    Rp, L = v.shape
    w = v.reshape(Rp, L // 2, 2).int()
    return (w[:, :, 0] | (w[:, :, 1] << 4)).to(torch.uint8)


def _shift(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """result[:, p] = a[:, p + k], ``fill`` outside the row."""
    pad = torch.full((a.shape[0], abs(k)), fill, dtype=a.dtype,
                     device=a.device)
    if k > 0:
        return torch.cat([a[:, k:], pad], dim=1)
    return torch.cat([pad, a[:, :k]], dim=1)


def het_planes(cnt: torch.Tensor, bank_rows: torch.Tensor,
               qlen_rows: torch.Tensor):
    """het_from_counts over the whole batch (port of _het_planes).
    cnt [5, Rp, L] int32; returns (het_u8, alt_u8, packed het bits,
    het count per row)."""
    Rp, L = bank_rows.shape
    pos = torch.arange(L, device=cnt.device)[None, :]
    in_r = pos < qlen_rows[:, None]
    q = bank_rows.int()
    qa = q.clamp(max=3)
    c = cnt
    c4 = torch.stack([c[k] + ((qa == k) & in_r).int() for k in range(4)])
    occ0 = c4.gather(0, qa[None].long())[0]
    altc = torch.stack([torch.where(qa == k, torch.zeros_like(c4[k]), c4[k])
                        for k in range(4)])
    site_alt = torch.argmax(altc, dim=0).int()             # first max
    occ1 = altc.max(dim=0).values
    minor = torch.minimum(occ0, occ1)
    het = (occ0 >= 2) & (occ1 >= 2) & (q <= 3) & \
        (4 * minor >= occ0 + occ1) & in_r
    # deletion-majority veto
    het = het & ~(c[4] > c4.sum(0))
    # alignment-SHIFT veto: adjacent pseudo-SNP pairs whose alt alleles
    # are the query shifted by one are indel artifacts
    pair = het & _shift(het, 1, False)
    qa_m = torch.where(in_r, qa, torch.full_like(qa, 9))
    pairL = pair & (pos >= 1) & (site_alt == _shift(qa_m, -1, 9)) & \
        (_shift(site_alt, 1, -9) == qa_m)
    pairR = pair & (pos + 2 < qlen_rows[:, None]) & \
        (site_alt == _shift(qa_m, 1, 9)) & \
        (_shift(site_alt, 1, -9) == _shift(qa_m, 2, 9))
    dp = pairL | pairR
    het = het & ~(dp | _shift(dp, -1, False))
    alt = torch.where(het, site_alt, torch.zeros_like(site_alt)) \
        .to(torch.uint8)
    return (het.to(torch.uint8), alt, pack_bits(het),
            het.sum(1, dtype=torch.int32))


def finalize_ins(ins_bc: torch.Tensor, ins_lc: torch.Tensor):
    """Majority insertion base (first max over 4) and length (first max
    over 1..8)."""
    b = torch.argmax(ins_bc, dim=0).to(torch.uint8)
    ln = (torch.argmax(ins_lc[1:], dim=0) + 1).to(torch.uint8)
    return b, ln


# room for the temporaries of the ambiguity mask, which L5 computes while
# K1's tracebacks are still held for the host DAG pass's gather: the
# whole batch at once would raise the peak above that of L5's decisions
AMB_TEMP_BYTES = 64 << 20


def amb_plane(votes, ins_tot, het_u8, bank_rows, qlen_rows) -> torch.Tensor:
    """The JAX package's _ambiguous_mask over the batch, [Rp, L] bool:
    the ambiguity mask of ``decide_planes``, computed without its
    [5, Rp, L] stacks."""
    L = bank_rows.shape[1]
    pos = torch.arange(L, device=votes.device)[None, :]
    in_r = pos < qlen_rows[:, None]
    qa = bank_rows.int().clamp(max=3)
    dels = votes[4]
    it = ins_tot
    cov = dels + in_r.int()               # the query's own vote, once
    wv = dels
    for k in range(4):
        cov = cov + votes[k]
        wv = torch.maximum(wv, votes[k] + ((qa == k) & in_r).int())
    return (cov >= 3) & ((2 * wv <= cov) |
                         ((4 * dels > cov) & (2 * dels <= cov)) |
                         ((4 * it > cov) & (2 * it <= cov))) & in_r & \
        (het_u8 == 0)


def amb_bits(votes, ins_tot, het_u8, bank_rows, qlen_rows,
             rows: int = 0) -> torch.Tensor:
    """``pack_bits(amb_plane(...))``, a block of ``rows`` rows at a time
    (by default as many as keep its temporaries, about 32 bytes a column,
    within AMB_TEMP_BYTES)."""
    Rp, L = bank_rows.shape
    rows = rows or max(1, AMB_TEMP_BYTES // (32 * L))
    return torch.cat([pack_bits(amb_plane(
        votes[:, r:r + rows], ins_tot[r:r + rows], het_u8[r:r + rows],
        bank_rows[r:r + rows], qlen_rows[r:r + rows]))
        for r in range(0, Rp, rows)])


def decide_planes(votes, ins_tot, ins_bc, ins_lc, het_u8, bank_rows,
                  qlen_rows, amb_pk=None):
    """The JAX package's consensus_decide + _ambiguous_mask (port of its
    _decide_planes); returns the packed (subw, pass_ins, ins base,
    ins len - 1, amb).  ``amb_pk``: the batch's packed ambiguity mask, if
    it is already there."""
    Rp, L = bank_rows.shape
    pos = torch.arange(L, device=votes.device)[None, :]
    in_r = pos < qlen_rows[:, None]
    qa = bank_rows.int().clamp(max=3)
    qsel = [((qa == k) & in_r).int() for k in range(4)]
    v = torch.stack([votes[k] + qsel[k] for k in range(4)] + [votes[4]])
    cov = v.sum(0)
    winner = torch.argmax(v, dim=0).int()                  # first max
    wv = v.max(dim=0).values
    it = ins_tot
    het = het_u8 > 0
    pass_sub = (cov >= 3) & (2 * wv > cov) & (winner != qa) & in_r & ~het
    # thin-coverage corner rescue: exactly one aligned voter corrects
    vq = torch.stack([v[k] - qsel[k] for k in range(4)] + [v[4]])
    v_tot = vq.sum(0)
    v_win = torch.argmax(vq, dim=0).int()
    thin = (cov == 2) & (v_tot == 1) & (v_win != qa) & in_r & ~het
    thin_ins = (cov == 2) & (it == 1) & in_r & ~het
    # burst guard: <= 2 rescue events per +-8 bp neighbourhood
    ch = F.pad((thin | thin_ins).int(), (8, 8))
    loc = sum(ch[:, 8 + d:8 + d + L] for d in range(-8, 9))
    keep = loc <= 2
    thin = thin & keep
    thin_ins = thin_ins & keep
    pass_sub = pass_sub | thin
    winner = torch.where(thin, v_win, winner)
    pass_ins = ((cov >= 3) & (2 * it > cov) | thin_ins) & in_r & ~het
    if amb_pk is None:
        amb_pk = pack_bits(amb_plane(votes, ins_tot, het_u8, bank_rows,
                                     qlen_rows))
    ib, il = finalize_ins(ins_bc, ins_lc)
    subw = torch.where(pass_sub, winner, torch.full_like(winner, 15))
    return (pack4(subw), pack_bits(pass_ins), pack2(ib), pack4(il - 1),
            amb_pk)


def _unpack_bits(a: np.ndarray, L: int) -> np.ndarray:
    return np.unpackbits(a, axis=1, bitorder="little")[:, :L] \
        .astype(bool)


def _unpack2(a: np.ndarray, L: int) -> np.ndarray:
    out = np.zeros((a.shape[0], L), np.uint8)
    for k in range(4):
        out[:, k::4] = (a >> (2 * k)) & 3
    return out


def _unpack4(a: np.ndarray, L: int) -> np.ndarray:
    out = np.zeros((a.shape[0], L), np.uint8)
    out[:, 0::2] = a & 15
    out[:, 1::2] = a >> 4
    return out


@dataclass
class ReadECOut:
    ov: OverlapRegions
    is_match: np.ndarray
    win_tot: np.ndarray
    win_ok: np.ndarray
    err: np.ndarray
    ts: np.ndarray
    te: np.ndarray
    het_sites: np.ndarray
    # reads with an ambiguity cluster: the columns of their final window
    # results that the host DAG pass reads
    dag: Optional[WindowColumns] = None


def lpt_rows(wc: np.ndarray, n_dev: int) -> Tuple[np.ndarray, int]:
    """Balanced read -> plane-row assignment of a batch on an ``n_dev``
    mesh (port of the JAX package's ``_shard_b`` branch of
    ``DeviceEC._process_batch``).  Shard d owns rows [d*rb, (d+1)*rb),
    and its align and vote work is its rows' window count (``wc`` per
    read): LPT, heaviest read first, each to the lightest shard that has
    a free row.  Returns (row per read, Rp): Rp is a power of two >= 256
    rounded up to a multiple of n_dev."""
    R = len(wc)
    Rp = 256
    while Rp < R:
        Rp *= 2
    rb = -(-Rp // n_dev)
    order = np.argsort(-np.asarray(wc, np.int64), kind="stable")
    load = np.zeros(n_dev, np.int64)
    used = np.zeros(n_dev, np.int64)
    next_row = [d * rb for d in range(n_dev)]
    rows = np.zeros(R, np.int64)
    for i in order:
        cand = [d for d in range(n_dev) if used[d] < rb]
        d = min(cand, key=lambda d: (load[d], d))
        rows[i] = next_row[d]
        next_row[d] += 1
        used[d] += 1
        load[d] += wc[i]
    return rows, rb * n_dev


def route_windows(q_row: np.ndarray, Rp: int, n_dev: int, chunk: int):
    """Owner-routed slot map (port of ``DeviceEC._route_windows``):
    returns (wmap, C, rb): wmap [C*chunk] holds the window occupying each
    slot (-1 pad), shard d's slots are columns [d*pc, (d+1)*pc) of every
    chunk row (pc = chunk // n_dev), and rb = Rp // n_dev is a shard's
    row block."""
    nd = n_dev
    pc = chunk // nd
    rb = Rp // nd
    owner = np.minimum(q_row // rb, nd - 1)
    perm = np.argsort(owner, kind="stable")
    n_d = np.bincount(owner, minlength=nd)
    need = max(int(n_d.max()) if len(q_row) else 1, 1)
    C = 1
    while C * pc < need:
        C *= 2
    wmap = np.full(C * chunk, -1, np.int64)
    off = np.zeros(nd + 1, np.int64)
    off[1:] = np.cumsum(n_d)
    for d in range(nd):
        idx = perm[off[d]:off[d + 1]]
        j = np.arange(len(idx))
        slots = (j // pc) * chunk + d * pc + (j % pc)
        wmap[slots] = idx
    return wmap, C, rb


def shard_windows(wmap: np.ndarray, n_dev: int, chunk: int):
    """The windows of each shard in its slot order (the port's
    ``_stack_routed``: a shard's lanes without the pad slots)."""
    w = wmap.reshape(-1, n_dev, chunk // n_dev)
    out = []
    for d in range(n_dev):
        s = w[:, d, :].reshape(-1)
        out.append(s[s >= 0])
    return out


class DeviceEC:
    """Runs the EC stages over all reads of a round: on one device, or
    owner-routed over a mesh (parallel/mesh.py).

    On a mesh (the JAX package's ``DeviceEC(mesh=)``), the bank is
    replicated once per distinct device.  Per batch, each shard owns a
    block of plane rows (``lpt_rows``), and every window goes to the
    shard that owns its read's row (``route_windows``).  A shard aligns
    its windows with K1 on its device (pass 1 and the retry round) and
    runs L2-L5 over its own row block; only the per-overlap agreement
    counters cross shards, summed as integers on the first device, where
    the overlaps are classified.  Each stage is launched on every shard
    before any result is fetched.  Without a mesh the same code runs as
    one shard."""

    def __init__(self, store: ReadStore, wl: int = WINDOW_HC,
                 e_rate: float = 0.04, device="cuda", chunk: int = 0,
                 mesh=None):
        self.mesh = mesh
        self.devices = list(mesh.devices) if mesh is not None else \
            [device_of(device)]
        self.device = self.devices[0]
        self.n_dev = len(self.devices)
        self.store = store
        self.wl = wl
        self.e_rate = e_rate
        chunk = chunk if chunk > 0 else (
            CHUNK_CUDA if self.device.type == "cuda" else CHUNK_CPU)
        self.chunk = max(chunk // self.n_dev, 1) * self.n_dev
        with trace.span("ec.bank", STATS, "bank_s"):
            banks = {}
            for dev in self.devices:
                if dev not in banks:
                    b0 = next(iter(banks.values()), None)
                    banks[dev] = build_bank(store, dev) if b0 is None else \
                        DeviceBank(b0.bank.to(dev), b0.lens.to(dev), b0.L,
                                   b0.R, b0.Lp)
            self.banks = [banks[d] for d in self.devices]
            self.bank = self.banks[0]

    def _t(self, a: np.ndarray, dtype=torch.int64, dev=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=dev or self.device, dtype=dtype)

    def _owners(self, q_row: np.ndarray, Rp: int):
        """Window indices of each shard, in its slot order."""
        if self.mesh is None:
            return [np.arange(len(q_row))]
        wmap, _, _ = route_windows(q_row, Rp, self.n_dev, self.chunk)
        return shard_windows(wmap, self.n_dev, self.chunk)

    def _align(self, s: int, q_rid, q_ws, xlen, t_rid, t_rev, t_ws, last):
        """L1 of shard ``s`` over host window arrays: gather + K1 per
        chunk on the shard's device.  Returns device (err, ys, yn) and
        (tb, ic, ib) [n, XL] uint8, unfetched."""
        XL, e = self.wl, E_BAND
        dev, bank = self.devices[s], self.banks[s]
        n = len(q_rid)
        cols = [self._t(a, dev=dev)
                for a in (q_rid, q_ws, xlen, t_rid, t_rev, t_ws)]
        last_d = self._t(last, torch.bool, dev)
        err = torch.empty(n, dtype=torch.int32, device=dev)
        ys = torch.empty_like(err)
        yn = torch.empty_like(err)
        tb = torch.empty((n, XL), dtype=torch.uint8, device=dev)
        ic = torch.empty_like(tb)
        ib = torch.empty_like(tb)
        k0 = banded_tb.launches
        for c0 in range(0, n, self.chunk):
            sl = slice(c0, min(n, c0 + self.chunk))
            x, xl, y, yl = gather_windows(
                bank, XL, e, *(c[sl] for c in cols), last_d[sl])
            if x.device != dev:
                raise RuntimeError(f"shard {s}'s windows are on {x.device}, "
                                   f"its device is {dev}")
            banded_tb(x, xl, y, yl, e,
                      out=tuple(a[sl] for a in (err, ys, yn, tb, ic, ib)))
        STATS["k1_rows"] += n * XL
        sh = SHARD_STATS.setdefault(s, {"windows": 0, "k1_launches": 0})
        sh["windows"] += n
        sh["k1_launches"] += banded_tb.launches - k0
        return err, ys, yn, tb, ic, ib

    def _align_all(self, owners, cols, n: int):
        """L1 over every shard: all shards launched, then (err, ys, yn)
        fetched and put back in window order; plus each shard's device
        (tb, ic, ib)."""
        outs = [self._align(s, *(c[idx] for c in cols)) if len(idx) else
                None for s, idx in enumerate(owners)]
        host = [np.zeros(n, np.int32) for _ in range(3)]
        planes = []
        for idx, o in zip(owners, outs):
            if o is None:
                planes.append(None)
                continue
            for h, t in zip(host, o[:3]):
                h[idx] = t.cpu().numpy()
            planes.append(o[3:])
        return (*host, planes)

    def process(self, read_ovs: List[Tuple[int, OverlapRegions]],
                plans: Optional[Dict[int, dict]] = None
                ) -> Tuple[Dict[int, ReadECOut], Dict[int, tuple]]:
        """read_ovs: [(rid, overlaps)]; returns per-read results plus
        per-read consensus inputs (packed decision planes, unpacked).
        ``plans``: ready-made window plans per read (the device front
        end's, with t_ws); without them each read is planned here.
        Each read whose ambiguity mask holds a cluster gets, in
        ``ReadECOut.dag``, the columns of its cis overlaps' window
        results over its clusters' ranges (``_dag_gather``).

        Reads stream through in bounded batches: the vote/count planes
        are sized [rows_per_batch, L], not [n_reads, L]."""
        # ~1.5 GB of vote planes per batch: L*(5+5+1+4+9) int32 per row
        rows = max(256, int(1.5e9 // max(self.bank.L * 96, 1)))
        if len(read_ovs) <= rows:
            return self._process_batch(read_ovs, plans)
        outs: Dict[int, ReadECOut] = {}
        cns: Dict[int, tuple] = {}
        for b0 in range(0, len(read_ovs), rows):
            o, c = self._process_batch(read_ovs[b0:b0 + rows], plans)
            outs.update(o)
            cns.update(c)
        return outs, cns

    def _process_batch(self, read_ovs: List[Tuple[int, OverlapRegions]],
                       plans: Optional[Dict[int, dict]] = None
                       ) -> Tuple[Dict[int, ReadECOut], Dict[int, tuple]]:
        R, L = len(read_ovs), self.bank.L
        e = E_BAND
        nd = self.n_dev
        devs = self.devices
        with trace.span("ec.plan", STATS, "plan_s"):
            # ---- plan all windows (host), unless the plans are given ----
            jobs = []
            ov_base = {}
            n_ov_tot = 0
            win_tot_all = []
            if plans is None:
                plans = plan_windows_many(read_ovs, self.wl, self.e_rate,
                                          with_tws=True)
            for rid, ov in read_ovs:
                pl = plans[rid]
                ov_base[rid] = n_ov_tot
                wt = np.zeros(len(ov), np.int32)
                np.add.at(wt, pl["ov_idx"], 1)
                win_tot_all.append(wt)
                jobs.append((rid, ov, pl))
                n_ov_tot += len(ov)
            # plane rows: on a mesh, balanced row blocks (one per shard);
            # else one block holding the batch's reads in order
            if self.mesh is not None and R:
                rows, Rp = lpt_rows(np.array([len(p["ws"])
                                              for _, _, p in jobs],
                                             np.int64), nd)
            else:
                rows, Rp = np.arange(R), R
            rb = Rp // nd
            row_of = {rid: int(r) for (rid, _), r in zip(read_ovs, rows)}

            def cat(parts, dtype):
                return np.concatenate(parts).astype(dtype) if jobs else \
                    np.zeros(0, dtype)

            j_qrid = cat([np.full(len(p["ws"]), rid) for rid, _, p in jobs],
                         np.int64)
            j_qrow = cat([np.full(len(p["ws"]), row_of[rid])
                          for rid, _, p in jobs], np.int64)
            j_ws = cat([p["ws"] for _, _, p in jobs], np.int64)
            j_xlen = cat([p["wlen"] for _, _, p in jobs], np.int64)
            j_tws = cat([p["t_ws"] for _, _, p in jobs], np.int64)
            j_thre = cat([p["thre"] for _, _, p in jobs], np.int64)
            j_last = cat([p["last"] for _, _, p in jobs], bool)
            j_ovid = cat([p["ov_idx"].astype(np.int64) + ov_base[rid]
                          for rid, _, p in jobs], np.int64)
            j_trid = cat([ov.y_id[p["ov_idx"]] for _, ov, p in jobs],
                         np.int64)
            j_trev = cat([ov.rev[p["ov_idx"]] for _, ov, p in jobs],
                         np.int64)

        W = len(j_qrid)
        if W == 0:
            z = np.zeros(0, np.int64)
            return ({rid: ReadECOut(ov, np.zeros(0, np.uint8), z, z, z, z,
                                    z, z) for rid, ov in read_ovs}, {})

        # ---- L1: align every window on its shard; tracebacks stay on
        # the device ----
        with trace.span("ec.L1", STATS, "align_s"):
            own1 = self._owners(j_qrow, Rp)
            err_all, ys_all, yn_all, planes1 = self._align_all(
                own1, (j_qrid, j_ws, j_xlen, j_trid, j_trev, j_tws, j_last),
                W)
        STATS["windows"] += W

        with trace.span("ec.prep", STATS, "host_s"):
            # window acceptance: doubled per-window budget, capped at the
            # band
            accept = np.minimum(j_thre * 2, E_BAND)
            w_ok = (err_all >= 0) & (err_all <= accept)
            # ---- one boundary-retry round (window_align.retry_plan);
            # retried tracebacks form a second segment per shard, and the
            # aggregation masks per slot, so a window's pass-1 slot stays
            # dead once its retry wins.  Slots: pass-1 windows 0..W-1,
            # then retry j at W + j
            tws_fin = j_tws.copy()
            y0p = tws_fin - e
            win_y = np.stack([y0p + ys_all, y0p + yn_all], axis=1)
            ridx, t2 = retry_plan(j_ovid, j_tws, j_xlen, w_ok, win_y, e)
            ok_slot = w_ok.copy()
        n_r = len(ridx)
        own2, planes2 = [], []
        if n_r:
            with trace.span("ec.L1_retry", STATS, "align_s"):
                own2 = self._owners(j_qrow[ridx], Rp)
                e2, ys2, yn2, planes2 = self._align_all(
                    own2, (j_qrid[ridx], j_ws[ridx], j_xlen[ridx],
                           j_trid[ridx], j_trev[ridx], t2.astype(np.int64),
                           j_last[ridx]), n_r)
            STATS["retry_windows"] += n_r

        with trace.span("ec.prep", STATS, "host_s"):
            segs = [[(p, own1[s])] if p is not None else []
                    for s, p in enumerate(planes1)]
            s_cols = [j_qrid, j_qrow, j_ws, j_xlen, j_ovid]
            if n_r:
                acc2 = (e2 >= 0) & (e2 <= accept[ridx])
                upd = ridx[acc2]
                err_all[upd] = e2[acc2]
                ys_all[upd] = ys2[acc2]
                yn_all[upd] = yn2[acc2]
                tws_fin[upd] = t2[acc2]
                w_ok[upd] = True
                ok_slot = np.concatenate([ok_slot, acc2])
                for s, p in enumerate(planes2):
                    if p is not None:
                        segs[s].append((p, W + own2[s]))
                s_cols = [np.concatenate([c, c[ridx]]) for c in s_cols]
            s_qrid, s_qrow, s_ws, s_xlen, s_ovid = s_cols

            # window-SEAM insertion evidence, applied to the L4
            # accumulators after the cis classification below
            seam = self._seams(j_ovid, j_ws, j_qrow, j_trid, j_trev, w_ok,
                               tws_fin - e, ys_all, yn_all)

            # per-overlap stats
            win_tot = np.concatenate(win_tot_all).astype(np.int64)
            win_ok = np.zeros(n_ov_tot, np.int64)
            np.add.at(win_ok, j_ovid[w_ok], 1)
            ov_err = np.zeros(n_ov_tot, np.int64)
            np.add.at(ov_err, j_ovid[w_ok], err_all[w_ok])
            # per-WINDOW evidence (~wcns_gen, ecovlp.cpp:2293): any
            # aligned window qualifies the overlap; failed windows' slots
            # are already excluded by ok_slot
            usable_ov = win_ok > 0
            w_use = ok_slot & usable_ov[s_ovid]

            # precise per-overlap target ranges from first/last accepted
            # window
            y0 = tws_fin - e
            ts_ov = np.full(n_ov_tot, -1, np.int64)
            te_ov = np.full(n_ov_tot, -1, np.int64)
            okw = np.flatnonzero(w_ok)
            if len(okw):
                first_w = np.full(n_ov_tot, W, np.int64)
                last_w = np.full(n_ov_tot, -1, np.int64)
                np.minimum.at(first_w, j_ovid[okw], okw)
                np.maximum.at(last_w, j_ovid[okw], okw)
                has = last_w >= 0
                fw = first_w[has]
                lw = last_w[has]
                ts_ov[has] = np.maximum(y0[fw] + ys_all[fw], 0)
                te_ov[has] = y0[lw] + yn_all[lw] - 1

            # per shard, its slots' device columns cut into aggregation
            # chunks; rows are local to the shard's block
            lens_np = np.asarray(self.store.lens, np.int64)
            steps = []
            for s, sg in enumerate(segs):
                dev = devs[s]
                st = []
                for (tb, ic, ib), slots in sg:
                    for c0 in range(0, len(slots), self.chunk):
                        sl = slice(c0, min(len(slots), c0 + self.chunk))
                        g = slots[sl]
                        st.append((tb[sl], ic[sl], ib[sl],
                                   self._t(s_qrow[g] - s * rb, dev=dev),
                                   self._t(s_ws[g], dev=dev),
                                   self._t(s_xlen[g], dev=dev),
                                   self._t(lens_np[s_qrid[g]], dev=dev),
                                   self._t(w_use[g], torch.bool, dev),
                                   self._t(s_ovid[g], dev=dev)))
                steps.append(st)

        with trace.span("ec.vote", STATS, "vote_s"):
            tallies = [VoteTally(dev) for dev in devs]
            # ---- L2: raw allele counts ----
            with trace.span("ec.L2"):
                cnts = [torch.zeros(5 * rb * L + 1, dtype=torch.int32,
                                    device=dev) for dev in devs]
                for cnt, st, tly in zip(cnts, steps, tallies):
                    for tb, ic, ib, qrow, ws, xlen, qlen_w, use, ov in st:
                        raw_counts_add(cnt, L, tb, qrow, ws, xlen, qlen_w,
                                       use, tly)

            # het detection on the device (the JAX package's
            # ec/phase.het_from_counts, integer form): only packed het
            # bits + 2-bit alts come back.  Rows no read holds (mesh
            # padding) have length 0: nothing is decided there.
            rid_rows = np.zeros(Rp, np.int64)
            row_valid = np.zeros(Rp, bool)
            rid_rows[rows] = [rid for rid, _ in read_ovs]
            row_valid[rows] = True
            with trace.span("ec.het"):
                bank_rows, qlen_rows, hets = [], [], []
                for s, (dev, bank) in enumerate(zip(devs, self.banks)):
                    blk = slice(s * rb, (s + 1) * rb)
                    rr = self._t(rid_rows[blk], dev=dev)
                    bank_rows.append(
                        bank.bank[rr, 0, _PAD_L:_PAD_L + L].contiguous())
                    ql = bank.lens[rr]
                    qlen_rows.append(torch.where(
                        self._t(row_valid[blk], torch.bool, dev), ql,
                        torch.zeros_like(ql)))
                    hets.append(het_planes(cnts[s][:-1].view(5, rb, L),
                                           bank_rows[s], qlen_rows[s]))
                del cnts

            # ---- L3: per-overlap het agreement -> cis/trans; the
            # counters are the only sums across shards ----
            with trace.span("ec.L3"):
                agree = []
                for s, (dev, st) in enumerate(zip(devs, steps)):
                    n_same = torch.zeros(n_ov_tot + 1, dtype=torch.int32,
                                         device=dev)
                    n_flip = torch.zeros_like(n_same)
                    het_d, alt_d = hets[s][0], hets[s][1]
                    for tb, ic, ib, qrow, ws, xlen, qlen_w, use, ov in st:
                        het_agree_add(n_same, n_flip, bank_rows[s], alt_d,
                                      het_d, tb, qrow, ws, xlen, qlen_w,
                                      use, ov)
                    agree.append((n_same, n_flip))
                dev0 = devs[0]
                n_same = _sum_on(dev0, [a[0] for a in agree])
                n_flip = _sum_on(dev0, [a[1] for a in agree])
                het_cnt = torch.cat([h[3].to(dev0) for h in hets])
                ov_qrow = np.zeros(n_ov_tot, np.int64)
                for rid, ov in read_ovs:
                    b = ov_base[rid]
                    ov_qrow[b:b + len(ov)] = row_of[rid]
                is_match_d = classify(n_same[:-1], n_flip[:-1], het_cnt,
                                      self._t(ov_qrow),
                                      self._t(usable_ov, torch.bool))
                is_match = {dev0: is_match_d}
                for dev in devs:
                    if dev not in is_match:
                        is_match[dev] = is_match_d.to(dev)

            # ---- L4: cis-only votes + insertion aggregates ----
            RL = rb * L
            with trace.span("ec.L4"):
                acc = []
                for s, (dev, st, tly) in enumerate(zip(devs, steps,
                                                       tallies)):
                    votes = torch.zeros(5 * RL + 1, dtype=torch.int32,
                                        device=dev)
                    ins_tot = torch.zeros(RL + 1, dtype=torch.int32,
                                          device=dev)
                    ins_bc = torch.zeros(4 * RL + 1, dtype=torch.int32,
                                         device=dev)
                    ins_lc = torch.zeros(9 * RL + 1, dtype=torch.int32,
                                         device=dev)
                    im = is_match[dev]
                    for tb, ic, ib, qrow, ws, xlen, qlen_w, use, ov in st:
                        cis_votes_add(votes, ins_tot, ins_bc, ins_lc, L, tb,
                                      ic, ib, qrow, ws, xlen, qlen_w,
                                      cis_mask(use, ov, im), tly)
                    if seam is not None:
                        mine = seam[:, seam[0] // rb == s]
                        if mine.shape[1]:
                            mine[0] -= s * rb
                            seam_add(ins_tot, ins_bc, ins_lc, rb, L,
                                     *(self._t(a, dev=dev) for a in mine),
                                     im, tly)
                    acc.append((votes, ins_tot, ins_bc, ins_lc))
            # ---- L5, first the ambiguity mask and cis/trans: they say
            # which window results the host DAG pass will read, while
            # K1's tracebacks are still on the device ----
            with trace.span("ec.L5"):
                ambs = [amb_bits(votes[:-1].view(5, rb, L),
                                 ins_tot[:-1].view(rb, L), hets[s][0],
                                 bank_rows[s], qlen_rows[s])
                        for s, (votes, ins_tot, _, _) in enumerate(acc)]
                ismatch_h = is_match_d.cpu().numpy()
                amb_h = np.concatenate([a.cpu().numpy() for a in ambs])
        with trace.span("ec.dag_gather", STATS, "dag_gather_s"):
            dag = self._dag_gather(
                read_ovs, ov_base, row_of, amb_h, ismatch_h, j_ovid, j_ws,
                j_xlen, ok_slot[:W], w_ok, ridx, own1, planes1, own2,
                planes2, seam)
        # the tracebacks are freed before the decisions, which need more
        # room than the ambiguity mask's row blocks
        del steps, segs, planes1, planes2
        with trace.span("ec.vote", STATS, "vote_s"):
            # ---- L5: consensus decisions on the device; the stage's
            # last fetch ----
            with trace.span("ec.L5"):
                packed = []
                for s in range(nd):
                    votes, ins_tot, ins_bc, ins_lc = acc[s]
                    packed.append((hets[s][2],) + decide_planes(
                        votes[:-1].view(5, rb, L), ins_tot[:-1].view(rb, L),
                        ins_bc[:-1].view(4, rb, L),
                        ins_lc[:-1].view(9, rb, L), hets[s][0],
                        bank_rows[s], qlen_rows[s], amb_pk=ambs[s])[:4])
                (het_pk_h, subw_h, ins_h, ib_h, il_h) = (
                    np.concatenate([p[k].cpu().numpy() for p in packed])
                    for k in range(5))
                # the device is idle after the fetch: no wait
                STATS["vote_dropped_adds"] += sum(int(t.dropped)
                                                  for t in tallies)
                STATS["vote_adds"] += sum(t.adds for t in tallies)

        with trace.span("ec.package", STATS, "host_s"):
            is_match_all = ismatch_h[:n_ov_tot]
            het_bits = _unpack_bits(het_pk_h, L)
            subw_all = _unpack4(subw_h, L)
            ins_all = _unpack_bits(ins_h, L)
            ib_all = _unpack2(ib_h, L)
            il_all = _unpack4(il_h, L)
            amb_all = _unpack_bits(amb_h, L)
            # ---- package per read ----
            out: Dict[int, ReadECOut] = {}
            cns_in: Dict[int, tuple] = {}
            for rid, ov in read_ovs:
                b = ov_base[rid]
                n = len(ov)
                sl = slice(b, b + n)
                row = row_of[rid]
                hs = np.flatnonzero(het_bits[row])
                out[rid] = ReadECOut(
                    ov, is_match_all[sl], win_tot[sl], win_ok[sl],
                    ov_err[sl], ts_ov[sl], te_ov[sl], hs, dag.get(rid))
                qlen = int(self.store.lens[rid])
                cns_in[rid] = (subw_all[row, :qlen], ins_all[row, :qlen],
                               ib_all[row, :qlen], il_all[row, :qlen],
                               amb_all[row, :qlen])
        return out, cns_in

    def _seams(self, j_ovid, j_ws, j_qrow, j_trid, j_trev, w_ok, y0,
               ys_all, yn_all) -> Optional[np.ndarray]:
        """Window-SEAM insertion evidence (mirrors the JAX package's
        WindowBatcher._inject_seams): [5, n] rows, columns, bases, gap
        lengths and overlap ids of the seams between consecutive accepted
        windows of an overlap whose gap is one homopolymer run of 1-8
        bases on the target; None without one.  ``y0``: each window's
        final y start less the band."""
        if len(j_ovid) < 2:
            return None
        same = (j_ovid[1:] == j_ovid[:-1]) & \
            (j_ws[1:] == j_ws[:-1] + self.wl) & w_ok[1:] & w_ok[:-1]
        cw = np.flatnonzero(same)
        if not len(cw):
            return None
        lend = y0[cw] + yn_all[cw]
        rstart = y0[cw + 1] + ys_all[cw + 1]
        gap = rstart - lend
        k = (gap >= 1) & (gap <= 8)
        cw, lend, gap = cw[k], lend[k], gap[k]
        rows_s, cols_s, base_s, len_s, ov_s = [], [], [], [], []
        t_or_cache: Dict[Tuple[int, int], np.ndarray] = {}
        for w, lo, g in zip(cw.tolist(), lend.tolist(), gap.tolist()):
            key = (int(j_trid[w]), int(j_trev[w]))
            t = t_or_cache.get(key)
            if t is None:
                t = self.store.get_codes(key[0])
                if key[1]:
                    t = revcomp_codes(t)
                t_or_cache[key] = t
            seg = t[lo:lo + g]
            if len(seg) < g or (seg != seg[0]).any() or seg[0] > 3:
                continue
            rows_s.append(int(j_qrow[w]))
            cols_s.append(int(j_ws[w]) + self.wl - 1)
            base_s.append(int(seg[0]))
            len_s.append(int(g))
            ov_s.append(int(j_ovid[w]))
        if not rows_s:
            return None
        return np.array([rows_s, cols_s, base_s, len_s, ov_s], np.int64)

    def _dag_gather(self, read_ovs, ov_base, row_of, amb_pk, is_match,
                    j_ovid, j_ws, j_xlen, ok1, w_ok, ridx, own1, planes1,
                    own2, planes2, seam) -> Dict[int, WindowColumns]:
        """The window results that the host DAG pass of each read with an
        ambiguity cluster reads (ec/consensus.dag_cluster_consensus),
        gathered from K1's outputs on the devices: over the union of its
        clusters' ranges (``cluster_range``), the columns of every
        accepted window of its cis overlaps, from the pass that was
        accepted (the retry only where pass 1 failed), and the seams
        there.  One fetch a device.  ``amb_pk``: the packed ambiguity
        planes; ``ok1``: pass 1's acceptance; ``w_ok``: the final one."""
        XL = self.wl
        big = np.int64(1) << np.int64(32)     # query columns stay below
        # windows are in (overlap, start) order
        key = j_ovid * big + j_ws
        pg, ps, pe, iv_of, n_pairs, n_ov = [], [], [], {}, [], {}
        for rid, ov in read_ovs:
            row = row_of[rid]
            if not amb_pk[row].any():
                continue
            qlen = int(self.store.lens[rid])
            amb = np.unpackbits(amb_pk[row], bitorder="little")[:qlen]
            clusters = _ambiguity_clusters(amb.astype(bool))
            if not clusters:
                continue
            q = self.store.get_codes(rid)
            ivs = []
            for cs, ce in sorted(cluster_range(q, cs, ce)
                                 for cs, ce in clusters):
                if ivs and cs <= ivs[-1][1]:
                    ivs[-1][1] = max(ivs[-1][1], ce)
                else:
                    ivs.append([cs, ce])
            iv_of[rid] = np.array(ivs, np.int64).reshape(-1, 2)
            n_ov[rid] = len(ov)
            n_pairs.append(0)
            b = ov_base[rid]
            cis = np.flatnonzero(is_match[b:b + len(ov)] == 1)
            xs = ov.x_s[cis].astype(np.int64)
            xe = ov.x_e[cis].astype(np.int64) + 1
            for cs, ce in ivs:
                o = cis[(xs < ce) & (xe > cs)]
                pg.append(b + o)
                ps.append(np.full(len(o), cs, np.int64))
                pe.append(np.full(len(o), ce, np.int64))
                n_pairs[-1] += len(o)
        if not iv_of:
            return {}
        g, r0, r1 = (np.concatenate(a) for a in (pg, ps, pe))
        # each (overlap, range) pair's windows: from the one holding the
        # range's start to the last starting before its end
        lo = np.maximum(np.searchsorted(key, g * big + r0, "right") - 1,
                        np.searchsorted(key, g * big, "left"))
        cnt = np.maximum(np.searchsorted(key, g * big + r1, "left") - lo, 0)
        pair = np.repeat(np.arange(len(g)), cnt)
        w = np.repeat(lo, cnt) + np.arange(len(pair)) - \
            np.repeat(np.cumsum(cnt) - cnt, cnt)
        c0 = np.maximum(j_ws[w], r0[pair])
        c1 = np.minimum(j_ws[w] + j_xlen[w], r1[pair])
        keep = w_ok[w] & (c1 > c0)
        pair, w, c0, n = pair[keep], w[keep], c0[keep], (c1 - c0)[keep]
        # each window's final result: its device, pass and row there
        p1 = ok1[w]
        shard = np.zeros(len(w), np.int64)
        prow = np.zeros(len(w), np.int64)
        for own, m, wi in ((own1, p1, w[p1]),
                           (own2, ~p1, np.searchsorted(ridx, w[~p1]))):
            if not m.any():
                continue
            sh_of = np.zeros(sum(len(idx) for idx in own), np.int64)
            row_in = np.zeros_like(sh_of)
            for s, idx in enumerate(own):
                sh_of[idx] = s
                row_in[idx] = np.arange(len(idx))
            shard[m] = sh_of[wi]
            prow[m] = row_in[wi]
        start = prow * XL + (c0 - j_ws[w])
        src = np.zeros(len(w), np.int64)
        vals, off = [], 0
        for s, dev in enumerate(self.devices):
            parts = []
            for planes, m in ((planes1, p1), (planes2, ~p1)):
                idx = np.flatnonzero(m & (shard == s))
                if not len(idx):
                    continue
                tot = int(n[idx].sum())
                st = self._t(start[idx], dev=dev)
                ln = self._t(n[idx], dev=dev)
                flat = torch.repeat_interleave(
                    st - (torch.cumsum(ln, 0) - ln), ln, output_size=tot) + \
                    torch.arange(tot, device=dev)
                parts.append(torch.stack([a.reshape(-1)[flat]
                                          for a in planes[s]]))
                src[idx] = off + np.cumsum(n[idx]) - n[idx]
                off += tot
            if parts:
                vals.append(torch.cat(parts, 1).cpu().numpy())
        buf = np.concatenate(vals, 1) if vals else \
            np.zeros((3, 0), np.uint8)
        STATS["dag_gather_windows"] += len(np.unique(w))
        STATS["dag_gather_bytes"] += buf.nbytes
        # per read: its segments, and its seams inside its ranges
        if seam is None:
            seam = np.zeros((5, 0), np.int64)
        bounds = np.searchsorted(pair, np.cumsum([0] + n_pairs))
        out = {}
        for k, rid in enumerate(iv_of):
            e_sl = slice(bounds[k], bounds[k + 1])
            b = ov_base[rid]
            ivs = iv_of[rid]
            sm = seam[:, (seam[4] >= b) & (seam[4] < b + n_ov[rid])]
            at = np.searchsorted(ivs[:, 0], sm[1], "right") - 1
            sm = sm[:, (at >= 0) & (sm[1] < ivs[np.maximum(at, 0), 1])]
            out[rid] = WindowColumns(
                g[pair[e_sl]] - b, c0[e_sl], n[e_sl], src[e_sl], buf[0],
                buf[1], buf[2], np.stack([sm[4] - b, sm[1], sm[3], sm[2]],
                                         axis=1))
        return out


def _sum_on(dev: torch.device, ts: List[torch.Tensor]) -> torch.Tensor:
    """Integer sum of per-shard tensors on ``dev`` (the port's psum)."""
    out = ts[0].to(dev)
    for t in ts[1:]:
        out = out + t.to(dev)
    return out
