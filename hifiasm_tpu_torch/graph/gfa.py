"""GFA 1.0 output (~ma_ug_print / ma_ug_print_simple, Overlaps.h:1151).

S-lines carry LN:i: and rd:i: (coverage) tags; A-lines give the read layout
(utg, offset, strand, read name, coverage-cut start, contributed length),
matching the reference's format documented in
docs/source/interpreting-output.rst:16-41.
"""

from __future__ import annotations

from typing import IO, Optional

import numpy as np

from hifiasm_tpu_torch.graph.sg import CoverageCut
from hifiasm_tpu_torch.graph.unitig import UnitigGraph, unitig_seq
from hifiasm_tpu_torch.io.readstore import ReadStore, codes_to_seq


def _useq(u, store, cov, seq_cache):
    """unitig_seq with an optional caller-scoped memo (one output phase
    writes the same unitigs into several GFA/FASTA siblings)."""
    if seq_cache is None:
        return unitig_seq(u, store, cov)
    seq = seq_cache.get(id(u))
    if seq is None:
        seq = seq_cache[id(u)] = unitig_seq(u, store, cov)
    return seq


def write_gfa(f: IO[str], ug: UnitigGraph, store: ReadStore,
              cov: CoverageCut, name_prefix: str = "utg",
              coverage: Optional[np.ndarray] = None,
              noseq: bool = False, seq_cache: Optional[dict] = None
              ) -> None:
    """``noseq=True`` writes ``*`` S-line sequences
    (~ma_ug_print_simple, the reference's ``*.noseq.gfa`` siblings)."""
    names = [f"{name_prefix}{i + 1:06d}l" if not u.circ else
             f"{name_prefix}{i + 1:06d}c" for i, u in enumerate(ug.utgs)]
    for i, u in enumerate(ug.utgs):
        seq = _useq(u, store, cov, seq_cache)
        cov_i = int(coverage[i]) if coverage is not None else 0
        s_txt = "*" if noseq else codes_to_seq(seq).decode()
        lines = [f"S\t{names[i]}\t{s_txt}\t"
                 f"LN:i:{len(seq)}\trd:i:{cov_i}\n"]
        off = 0
        for k, v in enumerate(u.vs):
            rid, d = int(v) >> 1, int(v) & 1
            lines.append(
                f"A\t{names[i]}\t{off}\t{'+-'[d]}\t{store.names[rid]}\t"
                f"{int(cov.s[rid])}\t{int(cov.e[rid])}\n")
            off += int(u.node_len[k])
        f.write("".join(lines))
    f.write("".join(
        f"L\t{names[s >> 1]}\t{'+-'[int(s) & 1]}\t"
        f"{names[d >> 1]}\t{'+-'[int(d) & 1]}\t{int(ol)}M\n"
        for s, d, ol in zip(ug.a_src, ug.a_dst, ug.a_ol)))


def write_fasta(f: IO[str], ug: UnitigGraph, store: ReadStore,
                cov: CoverageCut, name_prefix: str = "ctg",
                seq_cache: Optional[dict] = None) -> None:
    for i, u in enumerate(ug.utgs):
        seq = _useq(u, store, cov, seq_cache)
        f.write(f">{name_prefix}{i + 1:06d}\n{codes_to_seq(seq).decode()}\n")


def write_lowq_bed(f: IO[str], ug: UnitigGraph, cov: CoverageCut,
                   name_prefix: str = "utg", min_cov: int = 2) -> None:
    """Low-quality regions: unitig spans covered by < min_cov reads
    (~ma_ug_print_bed; the reference flags inconsistent regions next to
    each GFA, docs/source/interpreting-output.rst)."""
    for i, u in enumerate(ug.utgs):
        name = f"{name_prefix}{i + 1:06d}l"
        rids = (u.vs >> np.uint32(1)).astype(np.int64)
        nl = np.asarray(u.node_len, np.int64)
        offs = np.concatenate([[0], np.cumsum(nl[:-1])]) if len(nl) else \
            np.zeros(0, np.int64)
        rl = (cov.e - cov.s)[rids]
        ends = np.minimum(offs + rl, u.len)
        depth = (np.bincount(offs, minlength=u.len + 1)
                 - np.bincount(ends, minlength=u.len + 1))
        prof = np.cumsum(depth[:-1])
        low = prof < min_cov
        if not low.any():
            continue
        bounds = np.flatnonzero(np.diff(low.astype(np.int8)))
        edges = np.concatenate([[0], bounds + 1, [u.len]])
        for s, e in zip(edges[:-1], edges[1:]):
            if low[s]:
                f.write(f"{name}\t{int(s)}\t{int(e)}\n")
