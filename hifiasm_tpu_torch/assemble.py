"""End-to-end assembly driver (the ``ha_assemble`` analog, Assembly.cpp:2055).

The port of hifiasm_tpu/assemble.py: filter table -> EC rounds on the
device -> final overlap records -> string graph -> cleaning rounds ->
unitigs -> purge -> GFA, with the branches off ``bp`` that make the
assembly haplotype-resolved: trio binning (``dip.*``), Hi-C phasing and
scaffolding (``hic.*``, the seed-extend rescue on the device), polyploid
output, ``--dual-scaf`` and the debug surfaces ``-e`` and
``--dbg-het-cnt``.  Ultralong integration (``--ul``) is not ported yet
(ROADMAP.md Queue 1): a configuration that asks for it raises
``NotImplementedError`` before any work starts.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.device import resolve_device
from hifiasm_tpu_torch.ec.pipeline import ECResult, run_ec
from hifiasm_tpu_torch.graph.clean import (
    asg_arc_cut_inexact, asg_arc_del_short, asg_cut_tips, asg_pop_bubble,
    post_rescue, snapshot_arcs,
)
from hifiasm_tpu_torch.graph.gfa import write_fasta, write_gfa
from hifiasm_tpu_torch.graph.sg import (
    CoverageCut, StringGraph, gen_init_sg, normalize_paf,
)
from hifiasm_tpu_torch.graph.purge import PurgeResult, purge_dups
from hifiasm_tpu_torch.graph.unitig import UnitigGraph, ma_ug_gen
from hifiasm_tpu_torch.index.pos_table import build_filter_table
from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.utils.logging import log


@dataclass
class AssemblyResult:
    store: ReadStore
    ec: ECResult
    sg: StringGraph
    cov: CoverageCut
    r_to_u: np.ndarray
    ug: UnitigGraph
    read_cov: np.ndarray
    purge: Optional[PurgeResult] = None
    raw_ug: Optional[UnitigGraph] = None
    stage_s: dict = field(default_factory=dict)   # wall seconds per stage


_UNPORTED = "is not ported to hifiasm_tpu_torch yet (ROADMAP.md Queue 1"


def _check_ported(cfg: HifiasmConfig) -> None:
    """Raise for the one branch off the ``bp`` path that the port lacks."""
    if cfg.ul_reads:
        raise NotImplementedError(
            f"ultralong integration (--ul) {_UNPORTED}, the branches off "
            f"bp: UL)")


def clean_rounds(sg: StringGraph, cfg: HifiasmConfig,
                 read_cov: Optional[np.ndarray],
                 protect: Optional[np.ndarray] = None,
                 paf=None, cov=None, r_to_u=None,
                 avoid: Optional[np.ndarray] = None,
                 rev_paf=None) -> None:
    """~ul_clean_gfa round schedule (gfa_ut.cpp:3027-3256, HiFi path):
    per round with the drop-ratio ramp — semi-circle cuts, bubble-masked
    chimeric cut, inexact cut, weak-arc cut, bubble-link cuts, small
    bubble pops; afterwards large-indel cuts, semi-circles, post_rescue,
    dead-end tip extension, and the large bubble pop.  Telomeric tips
    (protect mask) are never trimmed; ``avoid`` threads the trio-aware
    path selection into every bubble pop."""
    from hifiasm_tpu_torch.graph.clean import (
        asg_arc_cut_bub_links, asg_arc_cut_chimeric,
        asg_arc_cut_complex_bub_links, asg_cut_large_indel,
        asg_iterative_semi_circ, bubble_protect, ug_ext_gfa,
    )

    n_r = max(cfg.clean_rounds, 1)
    ratios = np.linspace(cfg.min_drop_rate, cfg.max_drop_rate, n_r)
    small_bub = cfg.small_pop_bubble_size or 100000
    snap = snapshot_arcs(sg)
    asg_cut_tips(sg, cfg.max_short_tip, protect)
    for r, ratio in enumerate(ratios):
        asg_iterative_semi_circ(sg)
        vis = bubble_protect(sg, small_bub, read_cov)
        if paf is not None and cov is not None:
            asg_arc_cut_chimeric(sg, paf, cov, vis=vis, protect=protect)
            asg_cut_tips(sg, cfg.max_short_tip, protect)
        asg_arc_cut_inexact(sg)
        asg_cut_tips(sg, cfg.max_short_tip, protect)
        asg_arc_del_short(sg, float(ratio))
        asg_cut_tips(sg, cfg.max_short_tip, protect)
        vis = bubble_protect(sg, small_bub, read_cov)
        asg_arc_cut_bub_links(sg, cfg.large_pop_bubble_size,
                              read_cov=read_cov, vis=vis)
        asg_arc_cut_complex_bub_links(sg, vis=vis)
        asg_cut_tips(sg, cfg.max_short_tip, protect)
        asg_pop_bubble(sg, small_bub, read_cov, avoid)
    asg_iterative_semi_circ(sg)
    vis = bubble_protect(sg, small_bub, read_cov)
    if rev_paf is not None:
        # weak-arc cut preserving haplotype forks (~the final
        # asg_arc_del_orthology_multiple_way, Overlaps.cpp:39560)
        from hifiasm_tpu_torch.graph.clean import asg_arc_del_orthology
        asg_arc_del_orthology(sg, rev_paf, drop_ratio=0.4,
                              max_ext=max(cfg.max_short_tip, 8), vis=vis)
        asg_cut_tips(sg, cfg.max_short_tip, protect)
    asg_cut_large_indel(sg, cfg.max_short_tip, min_diff=0, vis=vis)
    asg_cut_tips(sg, cfg.max_short_tip, protect)
    post_rescue(sg, snap)
    if paf is not None and cov is not None and r_to_u is not None:
        ug_ext_gfa(sg, paf, cov, r_to_u, max_len=75000,
                   tip_reads=cfg.max_short_tip,
                   max_hang=cfg.max_hang_len, int_frac=cfg.max_hang_rate,
                   min_ovlp=2000)
    asg_cut_tips(sg, cfg.max_short_tip, protect)
    asg_pop_bubble(sg, cfg.large_pop_bubble_size, read_cov, avoid)


def assemble(store: ReadStore, cfg: HifiasmConfig,
             write_outputs: bool = True, device="cuda") -> AssemblyResult:
    """Default ``bp`` assembly; EC runs on ``device`` ("cuda" unless the
    caller asks for "cpu")."""
    from hifiasm_tpu_torch.io.binfiles import load_ec_state, save_ec_state

    dev = resolve_device(device)
    _check_ported(cfg)
    walls = {}
    t0 = time.time()

    # resume from checkpoints unless -i (~load_all_data_from_disk,
    # Overlaps.cpp:23590 / Assembly.cpp:2062)
    resumed = None if cfg.ignore_bin else load_ec_state(cfg.output_prefix)
    if resumed is not None:
        store, paf0, rev0 = resumed
        ec = ECResult(paf0, rev0, cfg.hom_cov, -1024)
    else:
        # filter table over ALL HPC k-mers (~ha_ft_gen); -f0 (bf_shift=0)
        # keeps the exact-count path, matching the quick-start config
        codes = (store.get_codes(i) for i in range(store.n_reads))
        ft, peak_hom, peak_het = build_filter_table(
            codes, cfg.k, high_factor=cfg.high_factor,
            max_kmer_cnt=cfg.max_kmer_cnt,
            min_hist_cnt=cfg.min_hist_kmer_cnt, bf_shift=cfg.bf_shift)
        if peak_hom > 0:
            cfg.update_cov(peak_hom, peak_het)
        elif cfg.hg_size > 0:
            # --hg-size: infer coverage from the estimated genome size
            est = max(int(round(store.total_bases / cfg.hg_size)), 1)
            log("assemble", f"coverage from --hg-size: {est}")
            cfg.update_cov(est)

        walls["filter_table"] = time.time() - t0
        t0 = time.time()
        ec = run_ec(store, cfg, ft if len(ft) else None, device=dev)
        walls["ec"] = time.time() - t0
        t0 = time.time()
        if write_outputs:
            save_ec_state(cfg.output_prefix, store, ec.paf, ec.reverse_paf)
    if cfg.bin_only:
        # --bin-only: the reference exits right after dumping the
        # checkpoint bins (Overlaps.cpp:23585, inter.cpp:21639)
        log("assemble", "--bin-only: wrote checkpoint bins, stopping")
        return AssemblyResult(store, ec, None, None, None, None, None)
    if cfg.dbg_het_cnt and write_outputs:
        # --dbg-het-cnt: per-read het-evidence counts on the corrected
        # reads -> <prefix>.het_cnt.log (~print_het_cnt_log,
        # Assembly.cpp:968-978; counted on the last round there)
        from hifiasm_tpu_torch.ec.pipeline import het_cnt_pass
        hc = het_cnt_pass(store, cfg)
        with open(f"{cfg.output_prefix}.het_cnt.log", "w") as f:
            for i in range(store.n_reads):
                f.write(f">{store.names[i]}\t{int(hc[i])}\n")
    if write_outputs and cfg.write_ec:
        _dump_ec_fasta(store, f"{cfg.output_prefix}.ec.fa")
    if write_outputs and cfg.write_paf:
        _dump_paf(store, ec.paf, f"{cfg.output_prefix}.0.paf")
        _dump_paf(store, ec.reverse_paf, f"{cfg.output_prefix}.1.paf")
    if cfg.dbg_ovec:
        # --dbg-ovec (~ha_ec_dbg / cal_ec_r_dbg, Assembly.cpp:1061,
        # ecovlp.cpp:6487): dump the EC overlap set and stop before
        # graph construction
        _dump_paf(store, ec.paf, f"{cfg.output_prefix}.ovlp.paf")
        log("assemble", "--dbg-ovec: wrote EC overlaps, stopping")
        return AssemblyResult(store, ec, None, None, None, None, None)

    # trio binning (~ha_triobin call site, Assembly.cpp:2101);
    # --skip-triobin parses the yak/list inputs but skips the binning
    # (the reference parses HA_F_SKIP_TRIOBIN, CommandLines.cpp:918)
    if cfg.skip_triobin:
        log("assemble", "--skip-triobin: trio binning skipped")
    elif (cfg.fn_bin_yak_pat and cfg.fn_bin_yak_mat) or \
            (cfg.fn_bin_list_pat and cfg.fn_bin_list_mat):
        from hifiasm_tpu_torch.trio import ha_triobin
        t1 = time.time()
        ha_triobin(store, cfg.fn_bin_yak_pat, cfg.fn_bin_yak_mat,
                   cfg.min_cnt, cfg.mid_cnt,
                   list_pat=cfg.fn_bin_list_pat,
                   list_mat=cfg.fn_bin_list_mat)
        _drop_edges_by_trio(ec.paf, store.trio_flags)
        walls["trio_bin"] = time.time() - t1     # part of string_graph

    paf = normalize_paf(ec.paf, store.lens, rescue_el=cfg.is_ont)
    # per-read coverage = overlap-RECORD count (~2x the base depth:
    # each neighbour contributes one record regardless of span).  The
    # purge/cleaning thresholds downstream are calibrated against this
    # scale; switching to base-weighted depth (the reference's ma_sub_t
    # scale, which the rd:i GFA tags then match) halves utg_cov under
    # the purge dup threshold and demotes haplotypes — the rd:i 2x
    # offset vs the reference is a documented cosmetic deviation
    # (scripts/tiebreak_diff.py)
    read_cov = np.array([len(paf[i]) for i in range(store.n_reads)],
                        np.int64)
    sg, cov, r_to_u = gen_init_sg(
        paf, store.lens, min_dp=max(cfg.min_overlap_coverage, 1),
        min_ovlp=cfg.min_overlap_len, max_hang=cfg.max_hang_len,
        int_frac=cfg.max_hang_rate, gap_fuzz=cfg.gap_fuzz,
        # ONT chemistry artifacts: junction support <= chem-c over
        # chem-f flanks (~gen_chemical_arc_rf, ecovlp.cpp:6479)
        chem_cov=cfg.chemical_cov if cfg.is_ont else 0,
        chem_flank=cfg.chemical_flank if cfg.is_ont else 0)
    if cfg.dbg_gfa and write_outputs:
        from hifiasm_tpu_torch.io.binfiles import write_graph
        write_graph(f"{cfg.output_prefix}.dbg_gfa.npz", sg, cov, r_to_u)
    telo = None
    if cfg.telo_motif:
        from hifiasm_tpu_torch.graph.telo import find_telo_reads
        telo = find_telo_reads(store, cfg.telo_motif,
                               min_hits=cfg.telo_min_score,
                               pen=cfg.telo_pen, drop=cfg.telo_drop)
    # raw unitigs before any cleaning (~output r_utg, Overlaps.cpp
    # output_unitig_graph)
    raw_ug = ma_ug_gen(sg)
    walls["string_graph"] = time.time() - t0
    t0 = time.time()
    clean_rounds(sg, cfg, read_cov, protect=telo, paf=paf, cov=cov,
                 r_to_u=r_to_u, rev_paf=ec.reverse_paf)
    ug = ma_ug_gen(sg)
    # base-exact junction snapping BEFORE any sequence consumer: arc
    # overlap lengths passed through the EC edit-trace remap and drift
    # +-1-2 bases, planting an error at every affected read junction
    # (67 of 73 contig-vs-truth errors at 500 kb sat at junctions)
    from hifiasm_tpu_torch.graph.unitig import refine_junction_lens
    refine_junction_lens(ug, store, cov)
    from hifiasm_tpu_torch.graph.unitig import break_by_coverage, ug_cut_tips
    n_tip = ug_cut_tips(ug, cfg.max_contig_tip)
    if n_tip:
        log("assemble", f"removed {n_tip} contig tips (--ctg-n)")
    break_by_coverage(ug, cov, b_low=cfg.b_low_cov, b_high=cfg.b_high_cov)
    if cfg.post_join:
        # -u: merge mutually-unique unitig pairs the contig-level
        # cleanups exposed (~the reference's post-join, CommandLines:126)
        from hifiasm_tpu_torch.graph.unitig import ug_post_join
        ug_post_join(ug, cov)

    if (cfg.hic_reads_1 and cfg.hic_reads_2) or cfg.fn_bin_yak_pat or \
            cfg.fn_bin_list_pat:
        # flatten tiny nested bubbles before Hi-C / trio phasing
        # (~hic_clean in the output paths, Overlaps.cpp:16250/17544)
        from hifiasm_tpu_torch.graph.clean import hic_clean_ug
        hic_clean_ug(ug)

    walls["clean_unitig"] = time.time() - t0
    t0 = time.time()
    simi = (cfg.purge_simi_rate_l2 if cfg.purge_level == 2
            else cfg.purge_simi_rate_l3)
    utg_cov = np.array([
        int(np.round(read_cov[(u.vs >> 1)].mean())) if len(u.vs) else 0
        for u in ug.utgs], np.int64)
    purge_cov_thr = cfg.purge_max_cov
    if purge_cov_thr < 0 and cfg.somatic_cov >= 0:
        # --somatic-cov: a fixed diploid-coverage ceiling replaces the
        # derived threshold (~flat_soma_v, Overlaps.cpp:39127)
        purge_cov_thr = cfg.somatic_cov
    if purge_cov_thr < 0 and cfg.purge_level > 0:
        # auto threshold from the measured read-coverage histogram
        # (~get_read_coverage_thres + if_ploid_sample,
        # Purge_Dups.cpp:394, :5591)
        from hifiasm_tpu_torch.graph.purge import purge_coverage_threshold
        qn_t, _ = ec.reverse_paf.flatten()
        trans_reads = np.unique(qn_t.astype(np.int64))
        ploid_frac = float(store.lens[trans_reads].sum()) / \
            max(int(store.lens.sum()), 1)
        purge_cov_thr = purge_coverage_threshold(
            read_cov, store.lens, ec.hom_cov, ploid_frac)
    purge = purge_dups(ug, ec.reverse_paf, store.n_reads,
                       purge_level=cfg.purge_level, simi_rate=simi,
                       min_ovlp_reads=cfg.purge_overlap_len,
                       utg_cov=utg_cov, max_cov=purge_cov_thr,
                       seed=cfg.seed)
    if purge.hap_pairs and cfg.trans_base_rate_sec >= 0:
        # sequence-level confirmation of purge candidates (~tovlp)
        from hifiasm_tpu_torch.graph.tovlp import confirm_purge_pairs
        from hifiasm_tpu_torch.graph.unitig import unitig_seq

        useqs = [unitig_seq(u, store, cov) for u in ug.utgs]
        # base-level confirmation threshold = --s-base (read-level -s
        # stays on the candidate generation; trans_base_rate_sec < 0
        # disables the alignment pass entirely).  The confirmed pairs
        # are cached (~the trans.bin kv_u_trans dump, Overlaps.cpp:16379)
        from hifiasm_tpu_torch.io.binfiles import (
            load_trans_links, save_trans_links,
        )
        tr_fp = (f"trans:{len(useqs)}:{sum(len(s) for s in useqs)}:"
                 f"{len(purge.hap_pairs)}:"
                 f"{sum(a + b for a, b, _ in purge.hap_pairs)}")
        confirmed = None if cfg.ignore_bin else \
            load_trans_links(cfg.output_prefix, tr_fp)
        if confirmed is None:
            confirmed = confirm_purge_pairs(
                useqs, purge.hap_pairs, max(simi, cfg.trans_base_rate_sec))
            save_trans_links(cfg.output_prefix, confirmed, tr_fp)
        keep_a = {a for a, _, _, _, _ in confirmed}
        restored = [a for a, _, _ in purge.hap_pairs if a not in keep_a]
        if restored:
            purge.primary = sorted(purge.primary + restored)
            purge.alternate = [a for a in purge.alternate
                               if a not in set(restored)]
        # join primary chains across the purged haplotigs
        # (~link_unitigs, Purge_Dups.cpp:5679)
        from hifiasm_tpu_torch.graph.purge import link_purged_chains
        spans = [(a, b, sp[0], sp[1], sp[4])
                 for a, b, _, _, sp in confirmed if sp is not None]
        link_purged_chains(ug, spans, purge.alternate)

    if cfg.recover_atg_cov_min >= 0 and purge is not None and \
            purge.alternate:
        # --pri-range: recover alternates whose coverage sits in the
        # duplication range (~recover_atg_cov_*, Overlaps.cpp:18898)
        rec = [a for a in purge.alternate
               if cfg.recover_atg_cov_min <= int(utg_cov[a])
               <= cfg.recover_atg_cov_max]
        if rec:
            purge.primary = sorted(purge.primary + rec)
            purge.alternate = [a for a in purge.alternate
                               if a not in set(rec)]
            log("assemble", f"--pri-range recovered {len(rec)} "
                f"alternate unitigs into primary")

    walls["purge"] = time.time() - t0
    res = AssemblyResult(store, ec, sg, cov, r_to_u, ug, read_cov, purge,
                         raw_ug, walls)
    if write_outputs:
        t0 = time.time()
        write_assembly_outputs(res, cfg, device=dev)
        walls["write"] = time.time() - t0
    return res


def write_assembly_outputs(res: AssemblyResult, cfg: HifiasmConfig,
                           device="cuda") -> None:
    """File-name matrix follows the reference
    (docs/source/interpreting-output.rst:16-41): default mode prefixes
    everything with ``bp.``, Hi-C with ``hic.``, trio with ``dip.``.
    The Hi-C rescue runs K2 on ``device``; the wall seconds of the Hi-C
    mapping, the phasing and the scaffolding (parts of the write stage)
    go to ``res.stage_s`` as hic_map, phase and scaffold."""
    _check_ported(cfg)
    dev = resolve_device(device)
    walls = res.stage_s
    for key in ("hic_map", "phase", "scaffold"):
        walls[key] = 0.0
    prefix = cfg.output_prefix
    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    mode = "bp"
    if cfg.hic_reads_1 and cfg.hic_reads_2:
        mode = "hic"
    elif (cfg.fn_bin_yak_pat and cfg.fn_bin_yak_mat) or \
            (cfg.fn_bin_list_pat and cfg.fn_bin_list_mat):
        mode = "dip"
    # -l0 or --primary: unprefixed p_ctg/a_ctg, no hap1/hap2 partition
    # (~CommandLines.cpp:947 clears HA_F_PARTITION; Overlaps.cpp:39156
    # drops the ".bp" prefix when the flag is absent)
    primary_mode = cfg.purge_level == 0 or cfg.primary
    ctg_pfx = f"{prefix}." if primary_mode else f"{prefix}.{mode}."
    ug_cov = np.array([
        int(np.round(res.read_cov[(u.vs >> 1)].mean())) if len(u.vs) else 0
        for u in res.ug.utgs], np.int64)
    seq_cache: dict = {}     # id(u) -> seq, valid for this output phase
    def _gfa(path: str, ug: UnitigGraph, pfx: str, ucov) -> None:
        # every graph gets a *.noseq.gfa sibling like the reference
        with open(path, "w") as f:
            write_gfa(f, ug, res.store, res.cov, pfx, ucov,
                      seq_cache=seq_cache)
        with open(path[:-4] + ".noseq.gfa", "w") as f:
            write_gfa(f, ug, res.store, res.cov, pfx, ucov, noseq=True,
                      seq_cache=seq_cache)

    if res.raw_ug is not None:
        raw_cov = np.array([
            int(np.round(res.read_cov[(u.vs >> 1)].mean()))
            if len(u.vs) else 0 for u in res.raw_ug.utgs], np.int64)
        _gfa(f"{ctg_pfx}r_utg.gfa", res.raw_ug, "utg", raw_cov)
        if cfg.prt_raw:
            # --prt-raw: extra pre-cleaning debug graph under the
            # reference's "<prefix>.raw" suffix (prt_dbg_gfa,
            # Overlaps.cpp:39200,39248)
            _gfa(f"{prefix}.raw.gfa", res.raw_ug, "utg", raw_cov)
    _gfa(f"{ctg_pfx}p_utg.gfa", res.ug, "utg", ug_cov)
    if cfg.bed_inconsist_rate > 0:        # --lowQ 0 disables the BED
        from hifiasm_tpu_torch.graph.gfa import write_lowq_bed
        with open(f"{ctg_pfx}p_utg.lowQ.bed", "w") as f:
            write_lowq_bed(f, res.ug, res.cov, "utg")
    if cfg.ex_list:
        from hifiasm_tpu_torch.debug_trace import extract_print, trace_reads
        with open(cfg.ex_list) as f:
            names = [ln.split()[0] for ln in f if ln.strip()]
        with open(f"{prefix}.trace.tsv", "w") as f:
            trace_reads(res.store, cfg, names, f)
        if cfg.extract_iter > 0:
            # --ex-iter: BFS-expanded overlap dump (extract.cpp:165)
            with open(f"{prefix}.extract.paf", "w") as f:
                extract_print(res.store, res.ec.paf, res.ec.reverse_paf,
                              names, cfg.extract_iter, f)

    prim_ids = (res.purge.primary if res.purge is not None
                else list(range(len(res.ug))))
    alt_ids = list(res.purge.alternate) if res.purge is not None else []
    prim = _sub_ug(res.ug, prim_ids)
    # contig-level cleanup + path threading: the reference's p_ctg is a
    # WALK through the cleaned primary unitig graph, not the unitig set
    # (~clean_primary_untig_graph + contig-level ma_ug_gen,
    # Overlaps.cpp:20005/19865) — repeat self-loops drop, primary
    # bubbles pop, het-linked equal tips move to alternate, then
    # mutually-unique chains merge into contigs
    from hifiasm_tpu_torch.graph.clean import clean_primary_ug
    from hifiasm_tpu_torch.graph.purge import unitig_trans_links
    from hifiasm_tpu_torch.graph.unitig import ug_post_join
    links_p = unitig_trans_links(prim, res.ec.reverse_paf,
                                 res.store.n_reads)
    moved = clean_primary_ug(
        prim, ug_cov[prim_ids] if len(prim_ids) else None, links_p)
    alt_ids += [prim_ids[i] for i in moved]
    ug_post_join(prim, res.cov)

    def _recov(g: UnitigGraph) -> np.ndarray:
        return np.array([
            int(np.round(res.read_cov[(u.vs >> 1)].mean()))
            if len(u.vs) else 0 for u in g.utgs], np.int64)

    _gfa(f"{ctg_pfx}p_ctg.gfa", prim, "ptg",
         _recov(prim) if len(prim.utgs) else None)
    with open(f"{prefix}.p_ctg.fa", "w") as f:
        write_fasta(f, prim, res.store, res.cov, seq_cache=seq_cache)
    if alt_ids:
        atg = _sub_ug(res.ug, alt_ids)
        ug_post_join(atg, res.cov)
        _gfa(f"{prefix}.a_ctg.gfa", atg, "atg", _recov(atg))

    # {mode}.hap1/hap2 (phased) outputs (~output_bp_graph / trio joint /
    # output_hic_graph when Hi-C reads are given)
    from hifiasm_tpu_torch.graph.hap_output import phase_unitigs
    hic_links = None
    if mode == "hic":
        from hifiasm_tpu_torch.graph.unitig import unitig_seq
        from hifiasm_tpu_torch.io.fastx import iter_fastx
        from hifiasm_tpu_torch.io.readstore import seq_to_codes
        from hifiasm_tpu_torch.phasing.hic import (
            UnitigIndex, hic_link_matrix,
        )

        seqs = [unitig_seq(u, res.store, res.cov) for u in res.ug.utgs]
        uidx = UnitigIndex.build(seqs)

        def _pairs():
            for f1, f2 in zip(cfg.hic_reads_1, cfg.hic_reads_2):
                for (_, s1), (_, s2) in zip(iter_fastx(f1), iter_fastx(f2)):
                    yield seq_to_codes(s1), seq_to_codes(s2)

        # misjoin (switch-error) breaks before phasing
        # (~update_switch_unitig, hic.cpp:17051; --l-msjoin)
        from hifiasm_tpu_torch.graph.unitig import split_unitig
        from hifiasm_tpu_torch.io.binfiles import load_hic_hits, save_hic_hits
        from hifiasm_tpu_torch.phasing.hic import (
            dedup_pe_hits, detect_switch_misjoins,
            map_hic_pairs_pos_batch,
        )

        def _seq_fp(ss):
            lens = np.array([len(s) for s in ss], np.int64)
            return (f"hic:{len(ss)}:{int(lens.sum())}:"
                    f"{int(np.bitwise_xor.reduce(lens * (np.arange(len(ss)) + 1))) if len(ss) else 0}")

        def _mapped_hits(ss, idx):
            # PE hit cache (~hic.cpp:5239 hic.lk.bin): keyed on the
            # unitig sequence fingerprint, so post-break remaps get
            # their own entry and stale caches recompute
            fp = _seq_fp(ss)
            if not cfg.ignore_bin:
                cached = load_hic_hits(prefix, fp)
                if cached is not None:
                    return cached
            t0 = time.time()
            h = dedup_pe_hits(map_hic_pairs_pos_batch(
                idx, _pairs(), utg_seqs=ss, device=dev))
            walls["hic_map"] += time.time() - t0
            save_hic_hits(prefix, h, fp)
            return h

        hits4 = _mapped_hits(seqs, uidx)
        breaks = detect_switch_misjoins(
            np.array([len(s) for s in seqs], np.int64), hits4,
            misjoin_len=cfg.misjoin_len)
        n_broken = sum(split_unitig(res.ug, u, p)
                       for u, p in breaks.items())
        if n_broken:
            seq_cache.clear()         # split_unitig mutates paths in place
            log("assemble", f"broke {n_broken} misjoined unitigs")
            seqs = [unitig_seq(u, res.store, res.cov) for u in res.ug.utgs]
            uidx = UnitigIndex.build(seqs)
            ug_cov = np.array([
                int(np.round(res.read_cov[(u.vs >> 1)].mean()))
                if len(u.vs) else 0 for u in res.ug.utgs], np.int64)
            hits4 = _mapped_hits(seqs, uidx)
        # Hi-C-guided tangle resolution before phasing
        # (~resolve_tangles_hic, hic.cpp:17069)
        from hifiasm_tpu_torch.phasing.hic import resolve_tangles_hic
        resolve_tangles_hic(res.ug, hits4)
        seq_cache.clear()             # tangle resolution can rewire paths
        hic_links = hic_link_matrix(
            len(res.ug), hits4,
            utg_lens=np.array([len(s) for s in seqs], np.int64),
            sc_weight=not cfg.unskew)
        from hifiasm_tpu_torch.trio import FATHER, MOTHER
        tf = np.asarray(res.store.trio_flags)
        if ((tf == FATHER) | (tf == MOTHER)).any():
            # trio + Hi-C together: the reference switches to the Hi-C
            # BENCHMARK mode (hic_benchmark, hic.cpp:18383; call gate
            # Overlaps.cpp:39621) — trio labels ground-truth the Hi-C
            # signal; we additionally keep the normal hic outputs
            from hifiasm_tpu_torch.phasing.hic import hic_benchmark_eval
            hap_of = np.zeros(len(res.ug), np.int8)
            for uid, u in enumerate(res.ug.utgs):
                fl = tf[(u.vs >> 1).astype(np.int64)]
                n_p = int((fl == FATHER).sum())
                n_m = int((fl == MOTHER).sum())
                hap_of[uid] = 1 if n_p > n_m else (2 if n_m > n_p else 0)
            hom: dict = {}
            if res.purge is not None:
                for a, b, _f in res.purge.hap_pairs:
                    hom[int(a)] = int(b)
                    hom[int(b)] = int(a)
            with open(f"{prefix}.bench.tsv", "w") as f:
                hic_benchmark_eval(hits4, hap_of, hom, f)
        hic_seqs, hic_hits4 = seqs, hits4
    hap1_ids, hap2_ids = [], []
    if not primary_mode and cfg.polyploidy > 2:
        # polyploid: k-hap labeling (~output_poly_trio, Overlaps.cpp:14682)
        from hifiasm_tpu_torch.graph.hap_output import phase_unitigs_k
        from hifiasm_tpu_torch.graph.gfa import _useq
        t0 = time.time()
        groups = phase_unitigs_k(res.ug, res.ec.reverse_paf,
                                 res.store.n_reads, cfg.polyploidy,
                                 n_perturb=cfg.n_perturb,
                                 f_perturb=cfg.f_perturb, seed=cfg.seed,
                                 hic_links=hic_links,
                                 utg_seqs=[
                                     _useq(u, res.store, res.cov,
                                           seq_cache)
                                     for u in res.ug.utgs])
        walls["phase"] += time.time() - t0
        for h, ids in enumerate(groups):
            hg = _sub_ug(res.ug, ids)
            ug_post_join(hg, res.cov)
            _gfa(f"{prefix}.{mode}.hap{h + 1}.p_ctg.gfa", hg,
                 f"h{h + 1}tg", _recov(hg) if len(hg.utgs) else None)
        hap1_ids, hap2_ids = groups[0], groups[1]
    elif not primary_mode:
        t0 = time.time()
        hap1_ids, hap2_ids = phase_unitigs(
            res.ug, res.ec.reverse_paf, res.store.n_reads,
            trio_flags=res.store.trio_flags, n_perturb=cfg.n_perturb,
            f_perturb=cfg.f_perturb, seed=cfg.seed, hic_links=hic_links,
            trio_occ_thres=cfg.trio_flag_occ_thres,
            trio_dual=cfg.trio_dual)
        walls["phase"] += time.time() - t0
        for name, ids in (("hap1", hap1_ids), ("hap2", hap2_ids)):
            hg = _sub_ug(res.ug, ids)
            ug_post_join(hg, res.cov)
            _gfa(f"{prefix}.{mode}.{name}.p_ctg.gfa", hg,
                 f"h{name[-1]}tg", _recov(hg) if len(hg.utgs) else None)
        if mode == "dip" and cfg.kpt_rate > 0:
            # --kpt-rate: extra ".kdp" graph of unitigs mostly UNUSED by
            # either haplotype output — a unitig is dropped when its
            # fraction of hap-used reads reaches the rate
            # (~filter_set_kug, Overlaps.cpp:21286: flag_occ >=
            # u.n * f_rate deletes; the remainder prints to "%s.kdp")
            used_reads = set()
            for ids in (hap1_ids, hap2_ids):
                for i in ids:
                    used_reads.update(
                        (res.ug.utgs[i].vs >> 1).astype(np.int64).tolist())
            kdp_ids = []
            for i, u in enumerate(res.ug.utgs):
                rs = (u.vs >> 1).astype(np.int64)
                if len(rs) == 0:
                    continue
                occ = sum(1 for r in rs if int(r) in used_reads)
                if not (occ == len(rs) or occ >= len(rs) * cfg.kpt_rate):
                    kdp_ids.append(i)
            kg = _sub_ug(res.ug, kdp_ids)
            ug_post_join(kg, res.cov)
            _gfa(f"{prefix}.kdp.p_ctg.gfa", kg, "ptg",
                 _recov(kg) if len(kg.utgs) else None)
            log("assemble", f"--kpt-rate: {len(kdp_ids)} unused unitigs "
                f"-> {prefix}.kdp.p_ctg.gfa")
        if mode == "hic" and not cfg.dual_scaf:
            # Hi-C scaffolding per haplotype (~ha_aware_order,
            # horder.cpp:4540): positioned PE hits -> end-proximity
            # order graph -> iterative join + weak-junction break rounds
            # (scaffold_ug/renew_scaffold horder.cpp:3871/:3790); hap1's
            # accepted layout seeds hap2's weights through the
            # purge homolog pairing (the trans-index hap-aware hook)
            from hifiasm_tpu_torch.io.readstore import codes_to_seq
            from hifiasm_tpu_torch.phasing.horder import (
                iterative_scaffold, scaffold_priors, scaffold_seqs,
            )
            lens_all = np.array([len(s) for s in hic_seqs], np.int64)
            homolog_g: dict = {}
            if res.purge is not None:
                for a, b, _frac in res.purge.hap_pairs:
                    homolog_g[int(a)] = int(b)
                    homolog_g[int(b)] = int(a)
            prior = None
            for name, ids in (("hap1", hap1_ids), ("hap2", hap2_ids)):
                idset = {int(i): k for k, i in enumerate(ids)}
                sub_hits = [
                    (idset[int(u1)], int(p1), idset[int(u2)], int(p2))
                    for u1, p1, u2, p2 in hic_hits4
                    if int(u1) in idset and int(u2) in idset]
                sub_lens = lens_all[np.asarray(ids, np.int64)] \
                    if ids else np.zeros(0, np.int64)
                t0 = time.time()
                scafs = iterative_scaffold(len(ids), sub_lens, sub_hits,
                                           rounds=3, prior=prior)
                walls["scaffold"] += time.time() - t0
                # hap-aware transfer into the next hap's local id space
                prior = None
                if homolog_g and name == "hap1":
                    other = {int(i): k for k, i in enumerate(hap2_ids)}
                    hmap = {idset[int(i)]: other[homolog_g[int(i)]]
                            for i in ids
                            if int(i) in homolog_g
                            and homolog_g[int(i)] in other}
                    prior = scaffold_priors(scafs, hmap)
                sseqs = scaffold_seqs(scafs, [hic_seqs[i] for i in ids])
                with open(f"{prefix}.hic.{name}.scaf.fa", "w") as f:
                    for i, s in enumerate(sseqs):
                        f.write(f">scaf{name}_{i + 1:06d}\n"
                                f"{codes_to_seq(s).decode()}\n")

    if cfg.dual_scaf:
        from hifiasm_tpu_torch.graph.unitig import unitig_seq
        from hifiasm_tpu_torch.io.readstore import codes_to_seq
        from hifiasm_tpu_torch.phasing.horder import scaffold_seqs
        from hifiasm_tpu_torch.phasing.selfscaf import self_scaffold

        seqs = [unitig_seq(u, res.store, res.cov) for u in res.ug.utgs]
        for name, own, other in (("hap1", hap1_ids, hap2_ids),
                                 ("hap2", hap2_ids, hap1_ids)):
            t0 = time.time()
            scafs = self_scaffold(res.ug, res.ec.reverse_paf,
                                  res.store.n_reads, own, other,
                                  gap_max=cfg.scaf_gap_max)
            walls["scaffold"] += time.time() - t0
            sseqs = scaffold_seqs(scafs, seqs)
            with open(f"{prefix}.{mode}.{name}.scaf.fa", "w") as f:
                for i, s in enumerate(sseqs):
                    f.write(f">scaf{name}_{i + 1:06d}\n"
                            f"{codes_to_seq(s).decode()}\n")
    log("assemble",
        f"wrote {prefix}.{mode}.[rp]_utg / .{mode}.p_ctg / {mode}.hap[12] "
        f"({len(prim_ids)} primary, {len(alt_ids)} alternate, "
        f"{len(hap1_ids)}+{len(hap2_ids)} hap contigs)")


def _drop_edges_by_trio(paf, trio_flags) -> None:
    """Remove overlaps connecting opposite-haplotype reads
    (~drop_edges_by_trio, Overlaps.cpp:39369)."""
    from hifiasm_tpu_torch.trio import FATHER, MOTHER

    n_drop = 0
    for rid in range(len(paf)):
        rec = paf[rid]
        if len(rec) == 0:
            continue
        fq = trio_flags[rid]
        ft = trio_flags[rec.tn.astype(np.int64)]
        bad = ((fq == FATHER) & (ft == MOTHER)) | \
              ((fq == MOTHER) & (ft == FATHER))
        if bad.any():
            paf[rid] = rec.take(np.flatnonzero(~bad))
            n_drop += int(bad.sum())
    log("drop_edges_by_trio", f"dropped {n_drop} cross-hap overlaps")


def _dump_ec_fasta(store: ReadStore, path: str) -> None:
    """--write-ec: corrected reads (~the prefix.ec.fa dump)."""
    from hifiasm_tpu_torch.io.readstore import codes_to_seq

    with open(path, "w") as f:
        for rid in range(store.n_reads):
            f.write(f">{store.names[rid]}\n"
                    f"{codes_to_seq(store.get_codes(rid)).decode()}\n")
    log("write_ec", f"wrote {path}")


def _dump_paf(store: ReadStore, paf, path: str) -> None:
    """--write-paf: overlaps in PAF format."""
    with open(path, "w") as f:
        for rid in range(len(paf)):
            rec = paf[rid]
            ql = int(store.lens[rid])
            for j in range(len(rec)):
                tn = int(rec.tn[j])
                f.write("\t".join(map(str, (
                    store.names[rid], ql, int(rec.qs[j]), int(rec.qe[j]),
                    "+-"[int(rec.rev[j])], store.names[tn],
                    int(store.lens[tn]), int(rec.ts[j]), int(rec.te[j]),
                    int(rec.ml[j]), int(rec.bl[j]), 255))) + "\n")
    log("write_paf", f"wrote {path}")


def _sub_ug(ug: UnitigGraph, ids) -> UnitigGraph:
    """Subset unitig graph (arcs restricted to kept unitigs, re-numbered)."""
    remap = {old: new for new, old in enumerate(ids)}
    sub = UnitigGraph([ug.utgs[i] for i in ids])
    if len(ug.a_src):
        keep = np.array([(int(s) >> 1 in remap) and (int(d) >> 1 in remap)
                         for s, d in zip(ug.a_src, ug.a_dst)], bool)
        sub.a_src = np.array([remap[int(s) >> 1] << 1 | (int(s) & 1)
                              for s in ug.a_src[keep]], np.uint32)
        sub.a_dst = np.array([remap[int(d) >> 1] << 1 | (int(d) & 1)
                              for d in ug.a_dst[keep]], np.uint32)
        sub.a_ol = ug.a_ol[keep]
    return sub
