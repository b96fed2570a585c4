"""Per-read candidate/overlap tracing (~extract.cpp, `-e/--ex-list`).

Dumps, for a named subset of reads: minimizer counts, per-target anchor
counts, chain scores, and final overlap records — the A/B debugging
surface the reference exposes via ``worker_ovec_related_reads`` and
``ha_extract_print_list`` (extract.cpp:165, Assembly.cpp:690-801).
"""

from __future__ import annotations

from typing import IO, List

import numpy as np

from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.index.pos_table import build_position_table
from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.ops.chain import ChainParams
from hifiasm_tpu_torch.overlap.anchors import chain_anchors, collect_anchors
from hifiasm_tpu_torch.utils.logging import log


def trace_reads(store: ReadStore, cfg: HifiasmConfig, names: List[str],
                out: IO[str]) -> None:
    name_to_rid = {n: i for i, n in enumerate(store.names)}
    rids = [name_to_rid[n] for n in names if n in name_to_rid]
    if not rids:
        log("trace_reads", "no matching read names")
        return
    codes = [store.get_codes(i) for i in range(store.n_reads)]
    pt, peak_hom, _, mzs = build_position_table(
        codes, cfg.k, cfg.w, min_hist_cnt=cfg.min_hist_kmer_cnt)
    hom_cov = peak_hom if peak_hom > 0 else cfg.hom_cov
    cp = ChainParams.for_k(cfg.k)
    for rid in rids:
        mz = mzs[rid]
        an = collect_anchors(mz, pt, rid, store.lens, hom_cov)
        out.write(f"READ\t{store.names[rid]}\tlen={store.lens[rid]}\t"
                  f"minimizers={len(mz)}\tanchors={len(an)}\n")
        if len(an):
            tids, cnts = np.unique(an.tid, return_counts=True)
            for t, c in zip(tids, cnts):
                out.write(f"ANCHORS\t{store.names[rid]}\t"
                          f"{store.names[int(t)]}\t{int(c)}\n")
        ov = chain_anchors(an, rid, int(store.lens[rid]), store.lens, cp,
                           max_n_chain=cfg.max_n_chain)
        for o in range(len(ov)):
            out.write(f"CHAIN\t{store.names[rid]}\t"
                      f"{store.names[int(ov.y_id[o])]}\t"
                      f"x={int(ov.x_s[o])}-{int(ov.x_e[o])}\t"
                      f"y={int(ov.y_s[o])}-{int(ov.y_e[o])}\t"
                      f"rev={int(ov.rev[o])}\tscore={int(ov.score[o])}\t"
                      f"hits={int(ov.n_hits[o])}\n")
    log("trace_reads", f"traced {len(rids)} reads")


def extract_print(store: ReadStore, paf, rev_paf, names: List[str],
                  n_rounds: int, out: IO[str]) -> None:
    """--ex-iter: expand the -e read set over the overlap graph for
    ``n_rounds`` BFS rounds, then dump every final-overlap record
    touching the expanded set as PAF-like lines
    (~ha_extract_print, extract.cpp:78-160; a read added in round m only
    recruits neighbours in rounds > m, matching the kh_val(h) < m gate)."""
    name_to_rid = {n: i for i, n in enumerate(store.names)}
    added = {name_to_rid[n]: -1 for n in names if n in name_to_rid}
    stores = (paf, rev_paf)
    for m in range(n_rounds):
        frontier = [r for r, rnd in added.items() if rnd < m]
        for rid in frontier:
            for st in stores:
                r = st.recs[rid]
                for t in np.asarray(r.tn, np.int64):
                    if int(t) not in added:
                        added[int(t)] = m
    for rid in range(store.n_reads):
        for li, st in enumerate(stores):
            r = st.recs[rid]
            for o in range(len(r)):
                t = int(r.tn[o])
                if rid not in added and t not in added:
                    continue
                out.write(
                    f"{store.names[rid]}\t{int(store.lens[rid])}\t"
                    f"{int(r.qs[o])}\t{int(r.qe[o])}\t"
                    f"{'-' if int(r.rev[o]) else '+'}\t"
                    f"{store.names[t]}\t{int(store.lens[t])}\t"
                    f"{int(r.ts[o])}\t{int(r.te[o])}\t"
                    f"{int(r.ml[o])}\t{int(r.bl[o])}\t{1 - li}\n")
    log("extract_print",
        f"dumped overlaps for {len(added)} reads ({n_rounds} rounds)")
