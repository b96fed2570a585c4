"""Error-correction driver: overlap -> phase -> consensus rounds.

The port of hifiasm_tpu/ec/pipeline.py, device branch only.  Every round
rebuilds the minimizer position index over the current reads (host).  On
one device, with ``cfg.device_frontend`` (the default), the index is
uploaded and the anchors are gathered, chained and turned into window
plans on the device (``_chain_all_reads_device``: index/pos_table_dev.py,
overlap/chain_device.py), else anchors and chains come from the host.
On a mesh (``_active_mesh``: every visible card unless
``cfg.mesh_devices`` caps it, as in the JAX package), the anchors are
gathered through the bucket-sharded index (parallel/ec_shard.py) and
chained on the host.  Then the window alignment, phasing and vote
aggregation run on the device or the mesh (ec/device_ec.DeviceEC) and
the host applies the per-column decisions.  ``cfg.profile_dir``
(``--profile``) writes one profiler trace of each round.
There is no size gate and no host-engine branch: ``ec_round`` always
takes the device branch on the given device.  The one host step
inside a round is by design: reads whose vote planes show an ambiguity
cluster take the host DAG pass (traceback strings -> plurality) over
the columns of K1's tracebacks that DeviceEC gathers for them, and
their count is logged.  The final overlap pass and the ``--dbg-het-cnt``
debug pass (``het_cnt_pass``) realign every read's overlaps through
DeviceEC too, with no correction.

Re-expresses ``cal_ec_r`` / ``worker_hap_ec`` / ``sl_ec_r``
(ecovlp.cpp:6268, :3234, :6410) and the final overlap records
``cal_ov_r`` (:6385).  Corrections are written back only after ALL reads
finish (the reference's barrier between ``kt_for`` and ``sl_ec_r``).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.device import resolve_device
from hifiasm_tpu_torch.index.pos_table import FilterTable, build_position_table
from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.ops.chain import ChainParams
from hifiasm_tpu_torch.overlap.anchors import OverlapRegions
from hifiasm_tpu_torch.overlap.paf import PafRecords, PafStore
from hifiasm_tpu_torch.utils import trace
from hifiasm_tpu_torch.utils.logging import log

LONG_INDEL_WIN_DIFF = 16

# per-stage seconds (trace.span) and counters of the EC runs since the
# last reset: chain_s is the whole front end (anchors to window plans,
# either path); within the device front end, plan_many_s is the
# vectorised host window planner and tws_s the device t_ws search (the
# anchor and chain stages count in index/pos_table_dev.STATS and
# overlap/chain_device.STATS) (anchors_s: the host or mesh anchor
# collection inside chain_s, the rest of which is the host chain DP);
# frontend_rounds and mesh_rounds count the rounds that took the device
# front end and the mesh gather; mesh_fallback the queries the mesh
# gather answered from the host table; ec_rounds the rounds run;
# consensus_reads the reads through the consensus loop, host_dag_reads
# those of them with an ambiguity cluster, which take the host DAG pass,
# host_dag_s its seconds, host_dag_native_reads those of its reads the
# native host library served (all of them wherever it loads),
# dag_clusters the clusters it resolved and host_dag_fallback_reads
# those of its reads that DeviceEC gave no traceback columns (their
# column decisions stand alone)
STATS = trace.register("pipeline", {
    "index_s": 0.0, "chain_s": 0.0, "anchors_s": 0.0, "plan_many_s": 0.0,
    "tws_s": 0.0, "device_ec_s": 0.0, "consensus_s": 0.0, "host_dag_s": 0.0,
    "ec_rounds": 0, "consensus_reads": 0, "host_dag_reads": 0,
    "host_dag_native_reads": 0, "dag_clusters": 0,
    "host_dag_fallback_reads": 0,
    "frontend_rounds": 0, "mesh_rounds": 0, "mesh_fallback": 0})


@dataclass
class ECResult:
    paf: PafStore
    reverse_paf: PafStore
    hom_cov: int
    het_cov: int
    n_corrected: int = 0


def _active_mesh(cfg: HifiasmConfig, device):
    """The mesh of the device path, by the JAX package's rule: every
    visible card (``cfg.mesh_devices`` == 0) or at most
    ``cfg.mesh_devices`` of them; None (one device) when that is one.
    The CPU counts as one device."""
    from hifiasm_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = cfg.mesh_devices
    n = avail if n == 0 else min(n, avail)
    if n <= 1:
        return None
    return make_mesh(n, dev)


def _chain_all_reads(store, codes, mzs, pt, cfg, hom_cov, mesh=None):
    """Anchor collection + batched chain DP for every read (host).  With
    a mesh, the posting lookups go through the bucket-sharded index
    (parallel/ec_shard.py): byte-identical anchors."""
    from hifiasm_tpu_torch.overlap.anchors import (
        chain_many, collect_anchors_many,
    )

    cp = ChainParams.for_k(cfg.k)
    rids = list(range(store.n_reads))
    with trace.span("ec.anchors", STATS, "anchors_s"):
        if mesh is not None:
            from hifiasm_tpu_torch.parallel.ec_shard import (
                MeshAnchorGather, collect_anchors_mesh,
            )
            gather = MeshAnchorGather(pt, mesh)
            ans = collect_anchors_mesh(mzs, gather, rids, store.lens,
                                       hom_cov)
            STATS["mesh_rounds"] += 1
            STATS["mesh_fallback"] += gather.n_fallback
        else:
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
        with trace.span("ec.plan_many", STATS, "plan_many_s"):
            chunk_plans = plan_windows_many(regs, cfg.ec_window,
                                            cfg.max_ov_diff_ec)
        with trace.span("ec.tws", STATS, "tws_s"):
            ws = [chunk_plans[rr]["ws"] for rr, _ in regs]
            ci = [ov.hit_ref[chunk_plans[rr]["ov_idx"]] for rr, ov in regs]
            t_all = dcc.tws_for_windows(np.concatenate(ci),
                                        np.concatenate(ws))
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
    with trace.span("ec.index", STATS, "index_s"):
        return build_position_table(
            codes, cfg.k, cfg.w, ft=ft, min_hist_cnt=cfg.min_hist_kmer_cnt,
            keep_max=min(cfg.max_kmer_cnt, 4095))


def _profiled(cfg: HifiasmConfig, round_idx: int, devices):
    """--profile: a torch.profiler context over a whole EC round (CPU
    activity, and CUDA on a card) that writes ``ec_r<round>.json``, a
    Chrome trace holding every ``ec.*`` span, into ``cfg.profile_dir``;
    a null context without it."""
    if not cfg.profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(cfg.profile_dir, exist_ok=True)
    path = os.path.join(cfg.profile_dir, f"ec_r{round_idx}.json")
    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)

    def ready(prof):
        prof.export_chrome_trace(path)
        log("ec_round", f"profiler trace of round {round_idx}: {path}")

    return profile(activities=acts, on_trace_ready=ready)


def ec_round(store: ReadStore, cfg: HifiasmConfig, ft: Optional[FilterTable],
             round_idx: int, collect=None, device="cuda", mesh=None
             ) -> Tuple[int, int, int]:
    """One correction round; returns (hom_cov, het_cov, n_corrected).

    ``collect``: optional (paf, rev_paf, edits) triple.  When given, the
    round's per-overlap results are ALSO pushed as final overlap records
    (the reference's architecture: ``cal_ec_r`` stores the round's
    overlaps, and the final overlap round ``cal_ov_r``,
    ecovlp.cpp:6385, does no realignment).  Record coordinates are in the
    round's start-of-round frame; the caller clamps them to the corrected
    lengths afterwards (~``flip_paf_rc`` clamping, ecovlp.cpp:3846).
    ``mesh``: None applies ``_active_mesh``; a Mesh is used as given."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = _active_mesh(cfg, dev)
    devices = list(mesh.devices) if mesh is not None else [dev]
    with _profiled(cfg, round_idx, devices), trace.span("ec.round"):
        STATS["ec_rounds"] += 1
        return _round(store, cfg, ft, round_idx, collect, dev, mesh)


def _round(store: ReadStore, cfg: HifiasmConfig, ft: Optional[FilterTable],
           round_idx: int, collect, dev, mesh) -> Tuple[int, int, int]:
    """The body of ``ec_round`` on a resolved device and mesh."""
    from hifiasm_tpu_torch.ec.consensus import (
        _ambiguity_clusters, consensus_apply,
    )
    from hifiasm_tpu_torch.ec.device_ec import DeviceEC

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

    with trace.span("ec.frontend", STATS, "chain_s"):
        plans = None
        if mesh is not None:
            # the mesh gather; the single-device front end is skipped, as
            # in the JAX package
            read_ovs = _chain_all_reads(store, codes, mzs, pt, cfg, hom_cov,
                                        mesh=mesh)
        elif cfg.device_frontend and loaded is None:
            read_ovs, plans = _chain_all_reads_device(store, mzs, pt, cfg,
                                                      hom_cov, dev)
        else:
            read_ovs = _chain_all_reads(store, codes, mzs, pt, cfg, hom_cov)
    with trace.span("ec.device_ec", STATS, "device_ec_s"):
        dec = DeviceEC(store, wl=cfg.ec_window, e_rate=cfg.max_ov_diff_ec,
                       device=dev, mesh=mesh)
        outs, cns_in = dec.process(read_ovs, plans=plans)
    with trace.span("ec.consensus", STATS, "consensus_s"):
        # votes can't carry the cluster strings: reads whose vote matrix
        # shows an ambiguity cluster take the host DAG pass over their
        # gathered traceback columns (reads are independent until the
        # barrier below, so they run first, in one native call over
        # cfg.threads threads)
        routed = [rid for rid in outs if rid in cns_in
                  and _ambiguity_clusters(cns_in[rid][4])]
        dag = _host_dags(routed, outs, cns_in, store, cfg)
        n_reads = 0
        for rid, eco in outs.items():
            if collect is not None:
                _push_records_stats(
                    collect[0], collect[1], rid, store.lens, eco.ov,
                    (eco.win_tot > 0) & (eco.win_ok == eco.win_tot),
                    eco.err, eco.ts, eco.te, eco.is_match,
                    cfg.max_ov_diff_final)
            if rid not in cns_in:
                continue
            n_reads += 1
            # per-column decisions were made on the device (packed planes;
            # device_ec.decide_planes == the JAX package's
            # consensus_decide bit for bit)
            subw, ins_p, ib_, il, _ = cns_in[rid]
            if rid in dag:
                cns = dag[rid]
            else:
                cns = consensus_apply(store.get_codes(rid), subw != 15,
                                      ins_p, subw.astype(np.int64), ib_,
                                      il.astype(np.int64) + 1)
            if cns.n_corrected:
                new_seqs[rid] = cns.seq
                n_corr += cns.n_corrected
                if collect is not None:
                    collect[2][rid] = cns.edits
        STATS["consensus_reads"] += n_reads
        STATS["host_dag_reads"] += len(routed)
        log("ec_round",
            f"routed {len(routed)} ambiguous reads to the host DAG pass")
        # barrier: write corrections back only after every read is
        # processed
        for rid, seq in new_seqs.items():
            store.set_codes(rid, seq)
    log("ec_round", f"round {round_idx}: corrected {n_corr} bases in "
        f"{len(new_seqs)} reads")
    return hom_cov, peak_het, n_corr


def _host_dags(rids, outs: dict, cns_in: dict, store: ReadStore,
               cfg: HifiasmConfig) -> dict:
    """The host DAG pass of every read in ``rids``: {rid:
    ConsensusResult}, timed into ``host_dag_s``.  One call of the native
    host library serves them all (``native.dag_reads_native``), longest
    first, over ``cfg.threads`` threads of this process (at most one a
    read and one a CPU this process may run on); without the library
    ``_host_dag`` serves them one after another.  Either way the results
    are ``_host_dag``'s, bit for bit."""
    from hifiasm_tpu_torch.native import dag_reads_native

    out = {}
    if not rids:
        return out
    with trace.span(None, STATS, "host_dag_s"):
        reads = [(store.get_codes(rid), outs[rid], cns_in[rid])
                 for rid in rids]
        n = min(int(cfg.threads), len(rids), len(os.sched_getaffinity(0)))
        res = dag_reads_native(reads, max(n, 1))
        if res is None:
            res = [_host_dag(*r) for r in reads]
        else:
            STATS["host_dag_native_reads"] += len(rids)
        for rid, (cns, n_cl, served) in zip(rids, res):
            out[rid] = cns
            STATS["dag_clusters"] += n_cl
            if not served:
                STATS["host_dag_fallback_reads"] += 1
                log("ec_round", f"read {rid}: no traceback columns for its "
                    "ambiguity clusters; its column decisions stand")
    return out


def _host_dag(q: np.ndarray, eco, cns: tuple):
    """The host DAG pass of one read (ec/consensus.py), the plain version
    of the native library's: the strings each cis overlap's traceback
    implies over the read's ambiguity clusters, read from the columns
    DeviceEC gathered (``eco.dag``), vote on the clusters; the
    replacements are applied over the device's column decisions.
    Returns (ConsensusResult, clusters, whether the read had its
    columns)."""
    from hifiasm_tpu_torch.ec.consensus import (
        _ambiguity_clusters, consensus_apply, dag_cluster_consensus,
    )

    subw, ins_p, ib_, il, amb = cns
    clusters = _ambiguity_clusters(amb)
    repl = None
    if eco.dag is not None:
        repl = dag_cluster_consensus(
            q, eco.dag.tracebacks(eco.ov), np.flatnonzero(eco.is_match == 1),
            clusters, eco.het_sites)
    return (consensus_apply(q, subw != 15, ins_p, subw.astype(np.int64), ib_,
                            il.astype(np.int64) + 1, repl=repl),
            len(clusters), eco.dag is not None)


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


def _overlap_pass(store: ReadStore, cfg: HifiasmConfig,
                  ft: Optional[FilterTable], device, mesh, e_rate: float):
    """Every read's overlaps realigned against the current reads, with no
    correction: the index (host), anchors and chains (host, or the mesh
    gather), then DeviceEC.  Returns (DeviceEC's per-read results,
    hom_cov, peak_het); ``mesh`` as in ``ec_round``."""
    from hifiasm_tpu_torch.ec.device_ec import DeviceEC

    dev = resolve_device(device)
    if mesh is None:
        mesh = _active_mesh(cfg, dev)
    codes = [store.get_codes(i) for i in range(store.n_reads)]
    pt, peak_hom, peak_het, mzs = _index(codes, cfg, ft)
    hom_cov = peak_hom if peak_hom > 0 else cfg.hom_cov
    dec = DeviceEC(store, wl=cfg.ec_window, e_rate=e_rate, device=dev,
                   mesh=mesh)
    read_ovs = _chain_all_reads(store, codes, mzs, pt, cfg, hom_cov,
                                mesh=mesh)
    outs, _ = dec.process(read_ovs)
    return outs, hom_cov, peak_het


def final_overlap_pass(store: ReadStore, cfg: HifiasmConfig,
                       ft: Optional[FilterTable], device="cuda",
                       mesh=None) -> ECResult:
    """~cal_ov_r (ecovlp.cpp:6385): precise overlap records, no correction.
    ``mesh`` as in ``ec_round``."""
    outs, hom_cov, peak_het = _overlap_pass(store, cfg, ft, device, mesh,
                                            cfg.max_ov_diff_final)
    paf = PafStore(store.n_reads)
    rev_paf = PafStore(store.n_reads)
    for rid, eco in outs.items():
        _push_records_stats(
            paf, rev_paf, rid, store.lens, eco.ov,
            (eco.win_tot > 0) & (eco.win_ok == eco.win_tot),
            eco.err, eco.ts, eco.te, eco.is_match,
            cfg.max_ov_diff_final)
    log("final_overlap_pass",
        f"{paf.total} cis + {rev_paf.total} trans overlaps")
    return ECResult(paf, rev_paf, hom_cov, peak_het)


def het_cnt_pass(store: ReadStore, cfg: HifiasmConfig, device="cuda",
                 mesh=None) -> np.ndarray:
    """--dbg-het-cnt: per-read confirmed het-SNP counts over the
    corrected reads (~get_het_cnt on the last EC round,
    Assembly.cpp:584,1014; dumped by print_het_cnt_log :968): the het
    sites DeviceEC finds on an overlap pass with the EC round's error
    rate and no filter table.  ``mesh`` as in ``ec_round``."""
    outs, _, _ = _overlap_pass(store, cfg, None, device, mesh,
                               cfg.max_ov_diff_ec)
    out = np.zeros(store.n_reads, np.int64)
    for rid, eco in outs.items():
        out[rid] = len(eco.het_sites)
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
           ft: Optional[FilterTable] = None, device="cuda",
           mesh=None) -> ECResult:
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
                                            collect=collect, device=dev,
                                            mesh=mesh)
        cfg.update_cov(hom_cov, het_cov)
        total_corr += n_corr
        if collect is not None:
            collected = (collect, hom_cov, het_cov)
        if n_corr == 0:
            break
    if collected is None:
        res = final_overlap_pass(store, cfg, ft, device=dev, mesh=mesh)
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
