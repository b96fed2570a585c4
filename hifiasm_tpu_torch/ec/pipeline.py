"""Error-correction driver: overlap -> phase -> consensus rounds.

The port of hifiasm_tpu/ec/pipeline.py, device branch only.  Every round
rebuilds the minimizer position index over the current reads (host) and
uploads it; with ``cfg.device_frontend`` (the default) the anchors are
gathered, chained and turned into window plans on the device
(``_chain_all_reads_device``: index/pos_table_dev.py,
overlap/chain_device.py), else anchors and chains come from the host.
Then the window alignment, phasing and vote aggregation run on the
device (ec/device_ec.DeviceEC) and the host applies the per-column
decisions.  There is no size gate and no host-engine branch: ``ec_round``
always takes the device branch on the given device.  The one host step
inside a round is by design: reads whose vote planes show an ambiguity
cluster re-run on the host DAG path (traceback strings -> plurality),
and their count is logged.  The ``--dbg-het-cnt`` debug pass
(``het_cnt_pass``) runs on the host, as in the JAX package.

Re-expresses ``cal_ec_r`` / ``worker_hap_ec`` / ``sl_ec_r``
(ecovlp.cpp:6268, :3234, :6410) and the final overlap records
``cal_ov_r`` (:6385).  Corrections are written back only after ALL reads
finish (the reference's barrier between ``kt_for`` and ``sl_ec_r``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.device import resolve_device
from hifiasm_tpu_torch.ec.consensus import windowed_consensus
from hifiasm_tpu_torch.ec.phase import phase_overlaps
from hifiasm_tpu_torch.index.pos_table import FilterTable, build_position_table
from hifiasm_tpu_torch.io.readstore import ReadStore, revcomp_codes
from hifiasm_tpu_torch.ops.chain import ChainParams
from hifiasm_tpu_torch.overlap.anchors import OverlapRegions
from hifiasm_tpu_torch.overlap.paf import PafRecords, PafStore
from hifiasm_tpu_torch.utils.logging import log

LONG_INDEL_WIN_DIFF = 16

# per-stage wall seconds and counters of the EC runs since the last reset:
# chain_s is the whole front end (anchors to window plans, either path);
# within the device front end, plan_many_s is the vectorised host window
# planner and tws_s the device t_ws search (the anchor and chain stages
# count in index/pos_table_dev.STATS and overlap/chain_device.STATS)
STATS = {"index_s": 0.0, "chain_s": 0.0, "plan_many_s": 0.0, "tws_s": 0.0,
         "device_ec_s": 0.0, "consensus_s": 0.0, "host_dag_reads": 0,
         "frontend_rounds": 0}


@dataclass
class ECResult:
    paf: PafStore
    reverse_paf: PafStore
    hom_cov: int
    het_cov: int
    n_corrected: int = 0


class _TargetCache:
    def __init__(self, store: ReadStore):
        self.store = store
        self._fwd = {}
        self._rc = {}

    def __call__(self, tid: int, rev: int) -> np.ndarray:
        cache = self._rc if rev else self._fwd
        if tid not in cache:
            codes = self.store.get_codes(tid)
            cache[tid] = revcomp_codes(codes) if rev else codes
        return cache[tid]


def _chain_all_reads(store, codes, mzs, pt, cfg, hom_cov):
    """Anchor collection + batched chain DP for every read (host)."""
    from hifiasm_tpu_torch.overlap.anchors import (
        chain_many, collect_anchors_many,
    )

    cp = ChainParams.for_k(cfg.k)
    rids = list(range(store.n_reads))
    ans = collect_anchors_many(mzs, pt, rids, store.lens, hom_cov)
    reads = [(rid, an, len(codes[rid])) for rid, an in zip(rids, ans)]
    ovs = chain_many(reads, store.lens, cp, max_n_chain=cfg.max_n_chain)
    return [(rid, ov) for (rid, _, _), ov in zip(reads, ovs)]


def _chain_all_reads_device(store, mzs, pt, cfg, hom_cov, device):
    """Device front end (port of the JAX package's function of the same
    name): the table is uploaded, anchors are gathered and chained on
    the device, and only per-chain numbers reach the host.  Returns
    (read_ovs, plans): regions field-identical with the host chain_many
    (hits stay on the device) and ready-made window plans per read."""
    from hifiasm_tpu_torch.ec.window_align import plan_windows_many
    from hifiasm_tpu_torch.index.pos_table_dev import (
        collect_anchor_groups_device, device_table_from_host,
    )
    from hifiasm_tpu_torch.overlap.chain_device import (
        DeviceChunkChains, regions_from_device_chains,
    )

    cp = ChainParams.for_k(cfg.k)
    table = device_table_from_host(pt, device)
    read_ovs = []
    plans = {}
    for cols, meta in collect_anchor_groups_device(
            mzs, table, list(range(store.n_reads)), store.lens, hom_cov):
        dcc = DeviceChunkChains(cols, meta, store.lens, store.lens, cp)
        regs = regions_from_device_chains(dcc, store.lens, store.lens,
                                          cfg.max_n_chain)
        # window planning: one vectorised host pass over the chunk, then
        # one device search for every window's t_ws
        t0 = time.time()
        chunk_plans = plan_windows_many(regs, cfg.ec_window,
                                        cfg.max_ov_diff_ec)
        t1 = time.time()
        STATS["plan_many_s"] += t1 - t0
        ws = [chunk_plans[rr]["ws"] for rr, _ in regs]
        ci = [ov.hit_ref[chunk_plans[rr]["ov_idx"]] for rr, ov in regs]
        t_all = dcc.tws_for_windows(np.concatenate(ci), np.concatenate(ws))
        STATS["tws_s"] += time.time() - t1
        o = 0
        for (rr, ov), w in zip(regs, ws):
            pl = chunk_plans[rr]
            pl["t_ws"] = t_all[o:o + len(w)]
            o += len(w)
            plans[rr] = pl
            read_ovs.append((rr, ov))
    STATS["frontend_rounds"] += 1
    return read_ovs, plans


def _index(codes, cfg: HifiasmConfig, ft):
    t0 = time.time()
    out = build_position_table(
        codes, cfg.k, cfg.w, ft=ft, min_hist_cnt=cfg.min_hist_kmer_cnt,
        keep_max=min(cfg.max_kmer_cnt, 4095))
    STATS["index_s"] += time.time() - t0
    return out


def ec_round(store: ReadStore, cfg: HifiasmConfig, ft: Optional[FilterTable],
             round_idx: int, collect=None, device="cuda"
             ) -> Tuple[int, int, int]:
    """One correction round; returns (hom_cov, het_cov, n_corrected).

    ``collect``: optional (paf, rev_paf, edits) triple.  When given, the
    round's per-overlap results are ALSO pushed as final overlap records
    (the reference's architecture: ``cal_ec_r`` stores the round's
    overlaps, and the final overlap round ``cal_ov_r``,
    ecovlp.cpp:6385, does no realignment).  Record coordinates are in the
    round's start-of-round frame; the caller clamps them to the corrected
    lengths afterwards (~``flip_paf_rc`` clamping, ecovlp.cpp:3846)."""
    from hifiasm_tpu_torch.ec.consensus import (
        _ambiguity_clusters, consensus_apply,
    )
    from hifiasm_tpu_torch.ec.device_ec import DeviceEC
    from hifiasm_tpu_torch.ec.window_align import align_overlaps

    dev = resolve_device(device)
    codes = [store.get_codes(i) for i in range(store.n_reads)]
    # index dump/resume (~write_pt_index/load_pt_index, htab.cpp:1367,
    # saved under --dbg-gfa like the reference's HA_F_VERBOSE_GFA load)
    pt_fp = (f"pt:{store.n_reads}:{store.total_bases}:{cfg.k}:{cfg.w}:"
             f"r{round_idx}")
    loaded = None
    if cfg.dbg_gfa and not cfg.ignore_bin and cfg.output_prefix:
        from hifiasm_tpu_torch.io.binfiles import load_pt_index
        loaded = load_pt_index(cfg.output_prefix, pt_fp)
    if loaded is not None:
        _ft, pt, mzs, peak_hom, peak_het = loaded
    else:
        pt, peak_hom, peak_het, mzs = _index(codes, cfg, ft)
        if cfg.dbg_gfa and cfg.output_prefix:
            from hifiasm_tpu_torch.io.binfiles import save_pt_index
            save_pt_index(cfg.output_prefix, ft, pt, mzs, pt_fp,
                          peak_hom, peak_het)
    hom_cov = peak_hom if peak_hom > 0 else cfg.hom_cov
    new_seqs = {}
    n_corr = 0

    t0 = time.time()
    plans = None
    if cfg.device_frontend and loaded is None:
        read_ovs, plans = _chain_all_reads_device(store, mzs, pt, cfg,
                                                  hom_cov, dev)
    else:
        read_ovs = _chain_all_reads(store, codes, mzs, pt, cfg, hom_cov)
    STATS["chain_s"] += time.time() - t0
    t0 = time.time()
    dec = DeviceEC(store, wl=cfg.ec_window, e_rate=cfg.max_ov_diff_ec,
                   device=dev)
    outs, cns_in = dec.process(read_ovs, plans=plans)
    STATS["device_ec_s"] += time.time() - t0
    t0 = time.time()
    ov_of = dict(read_ovs)
    get_target = _TargetCache(store)
    n_routed = 0
    for rid, eco in outs.items():
        if collect is not None:
            _push_records_stats(
                collect[0], collect[1], rid, store.lens, eco.ov,
                (eco.win_tot > 0) & (eco.win_ok == eco.win_tot),
                eco.err, eco.ts, eco.te, eco.is_match,
                cfg.max_ov_diff_final)
        if rid not in cns_in:
            continue
        # per-column decisions were made on the device (packed planes;
        # device_ec.decide_planes == consensus_decide bit for bit)
        subw, ins_p, ib_, il, amb = cns_in[rid]
        q = store.get_codes(rid)
        # votes can't carry the cluster strings: reads whose vote
        # matrix shows an ambiguity cluster re-run on the host path
        # (traceback strings -> DAG plurality, ec/consensus.py)
        if _ambiguity_clusters(amb):
            ov_full = ov_of[rid]
            if len(ov_full) and len(ov_full.hit_self) == 0 and \
                    ov_full.n_hits.max(initial=0) > 0:
                # hits live on the device: re-derive this read's overlaps
                # on the host (bit-identical anchors and chain DP)
                from hifiasm_tpu_torch.overlap.anchors import (
                    chain_many, collect_anchors_many,
                )
                an1 = collect_anchors_many(mzs, pt, [rid], store.lens,
                                           hom_cov)[0]
                ov_full = chain_many(
                    [(rid, an1, len(q))], store.lens,
                    ChainParams.for_k(cfg.k),
                    max_n_chain=cfg.max_n_chain)[0]
            tbs = align_overlaps(q, ov_full, get_target,
                                 wl=cfg.ec_window,
                                 e_rate=cfg.max_ov_diff_ec)
            ph = phase_overlaps(q, ov_full, tbs)
            cns = windowed_consensus(q, ov_full, tbs, ph)
            n_routed += 1
        else:
            cns = consensus_apply(q, subw != 15, ins_p,
                                  subw.astype(np.int64), ib_,
                                  il.astype(np.int64) + 1)
        if cns.n_corrected:
            new_seqs[rid] = cns.seq
            n_corr += cns.n_corrected
            if collect is not None:
                collect[2][rid] = cns.edits
    STATS["host_dag_reads"] += n_routed
    log("ec_round",
        f"routed {n_routed} ambiguous reads to the host DAG path")
    # barrier: write corrections back only after every read is processed
    for rid, seq in new_seqs.items():
        store.set_codes(rid, seq)
    STATS["consensus_s"] += time.time() - t0
    log("ec_round", f"round {round_idx}: corrected {n_corr} bases in "
        f"{len(new_seqs)} reads")
    return hom_cov, peak_het, n_corr


def _push_records_stats(paf: PafStore, rev_paf: PafStore, rid: int,
                        tlens: np.ndarray, ov: OverlapRegions,
                        full: np.ndarray, err: np.ndarray, ts_q: np.ndarray,
                        te_q: np.ndarray, is_match: np.ndarray,
                        e_rate: float) -> None:
    """Store cis/trans ma_hit records (~push_ne_ovlp, ecovlp.cpp:2585)."""
    for flag, dst in ((1, paf), (2, rev_paf)):
        sel = np.flatnonzero(full & (is_match == flag))
        if len(sel) == 0:
            continue
        qs = ov.x_s[sel]
        qe = ov.x_e[sel] + 1
        tn = ov.y_id[sel]
        rev = ov.rev[sel]
        tl = tlens[tn].astype(np.int64)
        ys = ts_q[sel]
        ye = te_q[sel]                       # inclusive, query frame
        ts = np.where(rev == 0, ys, tl - 1 - ye)
        te = np.where(rev == 0, ye + 1, tl - ys)
        bl = qe - qs
        ml = np.maximum(bl - err[sel], 0)
        el = (err[sel] <= bl * (e_rate * 0.5)).astype(np.uint8)
        # long-indel flag: target extent differs a lot from query extent
        dlt = np.abs((ye - ys + 1) - bl)
        no_l_indel = (dlt < LONG_INDEL_WIN_DIFF).astype(np.uint8)
        dst[rid] = PafRecords.from_columns(
            qs=qs, qe=qe, tn=tn, ts=ts, te=te, rev=rev, ml=ml, bl=bl,
            el=el, no_l_indel=no_l_indel)


def final_overlap_pass(store: ReadStore, cfg: HifiasmConfig,
                       ft: Optional[FilterTable], device="cuda") -> ECResult:
    """~cal_ov_r (ecovlp.cpp:6385): precise overlap records, no correction."""
    from hifiasm_tpu_torch.ec.device_ec import DeviceEC

    dev = resolve_device(device)
    codes = [store.get_codes(i) for i in range(store.n_reads)]
    pt, peak_hom, peak_het, mzs = _index(codes, cfg, ft)
    hom_cov = peak_hom if peak_hom > 0 else cfg.hom_cov
    paf = PafStore(store.n_reads)
    rev_paf = PafStore(store.n_reads)
    dec = DeviceEC(store, wl=cfg.ec_window, e_rate=cfg.max_ov_diff_final,
                   device=dev)
    read_ovs = _chain_all_reads(store, codes, mzs, pt, cfg, hom_cov)
    outs, _ = dec.process(read_ovs)
    for rid, eco in outs.items():
        _push_records_stats(
            paf, rev_paf, rid, store.lens, eco.ov,
            (eco.win_tot > 0) & (eco.win_ok == eco.win_tot),
            eco.err, eco.ts, eco.te, eco.is_match,
            cfg.max_ov_diff_final)
    log("final_overlap_pass",
        f"{paf.total} cis + {rev_paf.total} trans overlaps")
    return ECResult(paf, rev_paf, hom_cov, peak_het)


def _iter_overlap_batches(store: ReadStore, codes, mzs, pt, cfg, hom_cov,
                          e_rate: float, get_target):
    """Yield batches of (rid, q, ov, tbs) with windows aligned per batch.

    Pass 1 of each batch chains anchors and plans window jobs; one flush
    runs ALL windows of the batch through the host alignment engine (the
    native job path, else numpy); pass 2 yields the whole batch."""
    from hifiasm_tpu_torch.ec.window_align import WindowBatcher
    from hifiasm_tpu_torch.overlap.anchors import (
        chain_many, collect_anchors_many,
    )

    cp = ChainParams.for_k(cfg.k)
    bs = max(1, cfg.read_batch)
    for b0 in range(0, store.n_reads, bs):
        rids = list(range(b0, min(b0 + bs, store.n_reads)))
        wb = WindowBatcher(get_target, e_rate, wl=cfg.ec_window)
        ans = collect_anchors_many(mzs, pt, rids, store.lens, hom_cov)
        anchors = [(rid, an, len(codes[rid]))
                   for rid, an in zip(rids, ans)]
        ovs = chain_many(anchors, store.lens, cp,
                         max_n_chain=cfg.max_n_chain)
        planned = [(rid, codes[rid], ov, wb.add_read(codes[rid], ov))
                   for (rid, _, _), ov in zip(anchors, ovs)]
        wb.flush()
        yield planned


def het_cnt_pass(store: ReadStore, cfg: HifiasmConfig) -> np.ndarray:
    """--dbg-het-cnt: per-read confirmed het-SNP counts over the
    corrected reads (~get_het_cnt on the last EC round,
    Assembly.cpp:584,1014; dumped by print_het_cnt_log :968).  Runs the
    host phase path, as the JAX package does whatever its engine: it is
    a debug surface, and the engines are record-identical."""
    codes = [store.get_codes(i) for i in range(store.n_reads)]
    pt, peak_hom, _, mzs = build_position_table(
        codes, cfg.k, cfg.w, min_hist_cnt=cfg.min_hist_kmer_cnt,
        keep_max=min(cfg.max_kmer_cnt, 4095))
    hom_cov = peak_hom if peak_hom > 0 else cfg.hom_cov
    out = np.zeros(store.n_reads, np.int64)
    get_target = _TargetCache(store)
    for batch in _iter_overlap_batches(
            store, codes, mzs, pt, cfg, hom_cov, cfg.max_ov_diff_ec,
            get_target):
        for rid, q, ov, tbs in batch:
            out[rid] = len(phase_overlaps(q, ov, tbs).het_sites)
    log("het_cnt_pass", f"het counts for {store.n_reads} reads")
    return out


def _edit_cum_table(edits_map: dict, n_reads: int):
    """Concatenate per-read (pos, delta) edit traces into one global
    key-sorted table: key = rid << 34 | pos, value = CUMULATIVE delta at
    original coordinates >= pos.  A (rid, 0, 0) sentinel per read makes
    every lookup land inside its own read's slice."""
    keys = [np.asarray([], np.int64)]
    cums = [np.asarray([], np.int64)]
    for rid in range(n_reads):
        ed = edits_map.get(rid)
        pos = ed[0] if ed is not None else np.zeros(0, np.int64)
        delta = ed[1] if ed is not None else np.zeros(0, np.int64)
        base = np.int64(rid) << 34
        keys.append(base + np.concatenate([[0], pos]))
        cums.append(np.concatenate([[0], np.cumsum(delta)]))
    return np.concatenate(keys), np.concatenate(cums)


def _remap_and_clamp(paf: PafStore, lens: np.ndarray,
                     ed_keys: np.ndarray, ed_cums: np.ndarray) -> None:
    """Shift record coordinates through the correction edit traces (the
    reference's scc traces, consumed by ``adjust_exact_match``
    ecovlp.cpp:3521) and clamp into the corrected read lengths
    (~``flip_paf_rc`` bounding, ecovlp.cpp:3846).  Query coordinates
    remap through the query read's trace, target coordinates (stored in
    the target's forward frame) through the target read's trace."""
    for rid, r in enumerate(paf.recs):
        if not len(r):
            continue
        qbase = np.int64(rid) << 34
        tn = r.tn.astype(np.int64)
        tbase = tn << 34

        def shift(coord, base):
            idx = np.searchsorted(ed_keys, base + coord, side="right") - 1
            return coord + ed_cums[idx]

        ql = int(lens[rid])
        tl = lens[tn]
        qs = np.clip(shift(r.qs, qbase), 0, ql)
        qe = np.clip(shift(r.qe, qbase), 0, ql)
        ts = np.clip(shift(r.ts, tbase), 0, tl)
        te = np.clip(shift(r.te, tbase), 0, tl)
        keep = (qe > qs) & (te > ts)
        r.qs, r.qe, r.ts, r.te = qs, qe, ts, te
        r.bl = qe - qs
        r.ml = np.minimum(r.ml, r.bl)
        if not keep.all():
            paf.recs[rid] = r.take(np.flatnonzero(keep))


def run_ec(store: ReadStore, cfg: HifiasmConfig,
           ft: Optional[FilterTable] = None, device="cuda") -> ECResult:
    """Full EC: n_rounds of correction, with final overlap records taken
    from the LAST round (the reference's flow: ``cal_ec_r`` stores each
    round's overlaps and ``cal_ov_r`` never realigns — ecovlp.cpp:6268,
    :6385).  ``cfg.final_realign`` forces the full realign pass against
    the corrected reads instead."""
    dev = resolve_device(device)
    total_corr = 0
    collected = None
    for r in range(cfg.n_rounds_ec):
        collect = None
        if not cfg.final_realign:
            # fresh stores every round: the reference overwrites
            # R_INF.paf per round, keeping only the last round's records
            collect = (PafStore(store.n_reads), PafStore(store.n_reads),
                       {})
        hom_cov, het_cov, n_corr = ec_round(store, cfg, ft, r,
                                            collect=collect, device=dev)
        cfg.update_cov(hom_cov, het_cov)
        total_corr += n_corr
        if collect is not None:
            collected = (collect, hom_cov, het_cov)
        if n_corr == 0:
            break
    if collected is None:
        res = final_overlap_pass(store, cfg, ft, device=dev)
    else:
        (paf, rev_paf, edits_map), hom_cov, het_cov = collected
        ed_keys, ed_cums = _edit_cum_table(edits_map, store.n_reads)
        _remap_and_clamp(paf, store.lens, ed_keys, ed_cums)
        _remap_and_clamp(rev_paf, store.lens, ed_keys, ed_cums)
        log("final_overlap_pass",
            f"{paf.total} cis + {rev_paf.total} trans overlaps "
            f"(from the last EC round)")
        res = ECResult(paf, rev_paf, hom_cov, het_cov)
    res.n_corrected = total_corr
    return res
