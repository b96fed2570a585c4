"""Checkpoint / resume: corrected reads + overlap dumps.

The reference's load-bearing resume contract (write_all_data_to_disk,
Overlaps.cpp:23567; loaded at Assembly.cpp:2062; `-i` ignores):
  prefix.ec.bin           corrected read sequences
  prefix.ovlp.source.bin  cis overlaps (paf)
  prefix.ovlp.reverse.bin trans overlaps (reverse_paf)

Same resume points, TPU-native container: one .npz per file
with columnar arrays (mmap-friendly, no struct-endianness issues).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from hifiasm_tpu_torch.io.readstore import ReadStore
from hifiasm_tpu_torch.overlap.paf import PafRecords, PafStore, _FIELDS
from hifiasm_tpu_torch.utils.logging import log

MAGIC = "hifiasm-tpu-bin-v1"


def _save_arrays(path: str, **arrs) -> None:
    """Columnar container: JSON index + raw array bytes (np.savez's zip
    CRC pass costs ~0.5 s per bench checkpoint; raw tofile doesn't)."""
    import json

    meta = []
    for name, a in arrs.items():
        if isinstance(a, str):
            meta.append([name, "str", [len(a.encode())]])
        else:
            a = np.ascontiguousarray(a)
            meta.append([name, a.dtype.str, list(a.shape)])
    hdr = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(b"HTBIN1\n")
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for name, a in arrs.items():
            if isinstance(a, str):
                f.write(a.encode())
            else:
                np.ascontiguousarray(a).tofile(f)


def _load_arrays(path: str):
    """Load a _save_arrays container (or a legacy .npz) -> dict|None."""
    import json

    try:
        with open(path, "rb") as f:
            tag = f.read(7)
            if tag != b"HTBIN1\n":
                try:
                    z = np.load(path, allow_pickle=False)
                    return {k: z[k] for k in z.files}
                except Exception:
                    return None
            n = int.from_bytes(f.read(8), "little")
            meta = json.loads(f.read(n).decode())
            out = {}
            for name, dt, shape in meta:
                if dt == "str":
                    out[name] = f.read(shape[0]).decode()
                else:
                    cnt = int(np.prod(shape)) if shape else 1
                    a = np.fromfile(f, dtype=np.dtype(dt), count=cnt)
                    out[name] = a.reshape(shape)
            return out
    except Exception:
        return None


def write_reads(path: str, store: ReadStore) -> None:
    flat = np.concatenate([store.get_codes(i)
                           for i in range(store.n_reads)]) \
        if store.n_reads else np.zeros(0, np.uint8)
    _save_arrays(
        path, magic=MAGIC, names="\n".join(store.names),
        lens=store.lens, codes=flat, trio_flags=store.trio_flags)


def load_reads(path: str) -> Optional[ReadStore]:
    if not os.path.exists(path):
        return None
    z = _load_arrays(path)
    if z is None or str(z["magic"]) != MAGIC:
        return None
    names = str(z["names"]).split("\n") if z["lens"].size else []
    lens = z["lens"]
    flat = z["codes"]
    offs = np.concatenate([[0], np.cumsum(lens)])
    seqs = [flat[offs[i]:offs[i + 1]] for i in range(len(lens))]
    store = ReadStore.from_arrays(names, seqs)
    store.trio_flags = z["trio_flags"].copy()
    return store


def write_paf(path: str, paf: PafStore) -> None:
    qn, cols = paf.flatten()
    _save_arrays(path, magic=MAGIC, n_reads=np.array(len(paf)), qn=qn,
                 **{f: cols[f] for f in _FIELDS})


def load_paf(path: str) -> Optional[PafStore]:
    if not os.path.exists(path):
        return None
    z = _load_arrays(path)
    if z is None or str(z["magic"]) != MAGIC:
        return None
    n_reads = int(np.asarray(z["n_reads"]).reshape(()))
    qn = z["qn"]
    paf = PafStore(n_reads)
    if len(qn) == 0:
        return paf
    order = np.argsort(qn, kind="stable")
    cols = {f: z[f][order] for f in _FIELDS}
    qs = qn[order]
    bounds = np.flatnonzero(np.diff(qs)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(qs)]])
    for s, e in zip(starts, ends):
        rid = int(qs[s])
        paf[rid] = PafRecords(**{f: cols[f][s:e] for f in _FIELDS})
    return paf


def write_graph(path: str, sg, cov, r_to_u: np.ndarray) -> None:
    """String-graph checkpoint (~write_debug_graph, Overlaps.cpp:39436;
    --dbg-gfa lets the graph phase re-run standalone)."""
    _save_arrays(
        path, magic=MAGIC, n_seq=np.array(sg.n_seq), seq_len=sg.seq_len,
        seq_del=sg.seq_del, ul=sg.ul, v=sg.v, ol=sg.ol, strong=sg.strong,
        el=sg.el, no_l_indel=sg.no_l_indel, del_=sg.del_,
        cov_s=cov.s, cov_e=cov.e, cov_del=cov.del_, r_to_u=r_to_u)
    log("write_graph", f"wrote {path}")


def load_graph(path: str):
    """Returns (StringGraph, CoverageCut, r_to_u) or None."""
    from hifiasm_tpu_torch.graph.sg import CoverageCut, StringGraph

    if not os.path.exists(path):
        return None
    z = _load_arrays(path)
    if z is None or str(z["magic"]) != MAGIC:
        return None
    sg = StringGraph(int(np.asarray(z["n_seq"]).reshape(())), z["seq_len"])
    sg.seq_del = z["seq_del"].copy()
    sg.set_arcs(z["ul"], z["v"], z["ol"], z["strong"], z["el"],
                z["no_l_indel"], z["del_"])
    cov = CoverageCut(z["cov_s"].copy(), z["cov_e"].copy(),
                      z["cov_del"].copy())
    return sg, cov, z["r_to_u"].copy()


def checkpoint_paths(prefix: str) -> Tuple[str, str, str]:
    return (f"{prefix}.ec.bin.npz", f"{prefix}.ovlp.source.bin.npz",
            f"{prefix}.ovlp.reverse.bin.npz")


def save_ec_state(prefix: str, store: ReadStore, paf: PafStore,
                  rev_paf: PafStore) -> None:
    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    p_ec, p_src, p_rev = checkpoint_paths(prefix)
    write_reads(p_ec, store)
    write_paf(p_src, paf)
    write_paf(p_rev, rev_paf)
    log("save_ec_state", f"wrote {p_ec} / {p_src} / {p_rev}")


def load_ec_state(prefix: str):
    """Returns (store, paf, rev_paf) or None (~load_all_data_from_disk)."""
    p_ec, p_src, p_rev = checkpoint_paths(prefix)
    store = load_reads(p_ec)
    if store is None:
        return None
    paf = load_paf(p_src)
    rev_paf = load_paf(p_rev)
    if paf is None or rev_paf is None or len(paf) != store.n_reads:
        return None
    log("load_ec_state", f"resumed from {p_ec} ({store.n_reads} reads, "
        f"{paf.total} + {rev_paf.total} overlaps)")
    return store, paf, rev_paf


# ---------------------------------------------------------------------------
# Auxiliary caches: the reference's remaining resume surface.
#   prefix.pt.bin      minimizer index + per-read sketches
#                      (~write_pt_index/load_pt_index, htab.cpp:1367/:1432)
#   prefix.hic.lk.bin  Hi-C PE hit cache (~hic.cpp:5239/:5403)
#   prefix.ul.aln.bin  UL-to-unitig alignment paths
#                      (~write_all_ul_t/load_all_ul_t, inter.cpp:20120/21705)
#   prefix.trans.bin   unitig trans-link cache (~Overlaps.cpp:16379/:16407)
# Every cache carries a fingerprint of its inputs; a stale cache is
# ignored (recomputed and overwritten), never trusted.


def save_pt_index(prefix: str, ft, pt, mzs, fingerprint: str,
                  peak_hom: int = 0, peak_het: int = -1024) -> None:
    """Dump the filter table, position table and per-read sketches."""
    mz_off = np.zeros(len(mzs) + 1, np.int64)
    for i, m in enumerate(mzs):
        mz_off[i + 1] = mz_off[i] + len(m)
    cat = lambda f, d: (np.concatenate([getattr(m, f) for m in mzs])
                        if mzs else np.zeros(0, d))
    _save_arrays(
        f"{prefix}.pt.bin", magic=MAGIC, fp=fingerprint,
        ft_hashes=ft.hashes if ft is not None else np.zeros(0, np.uint64),
        ft_counts=ft.counts if ft is not None else np.zeros(0, np.uint16),
        ft_cutoff=np.array([ft.cutoff if ft is not None else 0], np.int64),
        peaks=np.array([peak_hom, peak_het], np.int64),
        pt_hashes=pt.hashes, pt_start=pt.start, pt_count=pt.count,
        pt_rid=pt.rid, pt_pos=pt.pos, pt_rev=pt.rev, pt_span=pt.span,
        mz_off=mz_off, mz_hash=cat("hash", np.uint64),
        mz_pos=cat("pos", np.int64), mz_rev=cat("rev", np.uint8),
        mz_span=cat("span", np.int64), mz_cnt=cat("cnt", np.uint32))
    log("save_pt_index", f"wrote {prefix}.pt.bin "
        f"({pt.n_distinct} k-mers, {pt.tot_pos} positions)")


def load_pt_index(prefix: str, fingerprint: str):
    """-> (ft | None, pt, mzs) or None on miss / stale fingerprint."""
    from hifiasm_tpu_torch.index.pos_table import FilterTable, PositionTable
    from hifiasm_tpu_torch.ops.sketch import Minimizers

    d = _load_arrays(f"{prefix}.pt.bin")
    if d is None or d.get("fp") != fingerprint:
        return None
    ft = None
    if len(d["ft_hashes"]):
        ft = FilterTable(d["ft_hashes"], d["ft_counts"],
                         int(d["ft_cutoff"][0]))
    pt = PositionTable(d["pt_hashes"], d["pt_start"], d["pt_count"],
                       d["pt_rid"], d["pt_pos"], d["pt_rev"],
                       d["pt_span"])
    off = d["mz_off"]
    mzs = [Minimizers(d["mz_hash"][off[i]:off[i + 1]],
                      d["mz_pos"][off[i]:off[i + 1]],
                      d["mz_rev"][off[i]:off[i + 1]],
                      d["mz_span"][off[i]:off[i + 1]],
                      d["mz_cnt"][off[i]:off[i + 1]])
           for i in range(len(off) - 1)]
    peaks = d.get("peaks", np.array([0, -1024], np.int64))
    log("load_pt_index", f"resumed index from {prefix}.pt.bin "
        f"({pt.n_distinct} k-mers)")
    return ft, pt, mzs, int(peaks[0]), int(peaks[1])


def save_hic_hits(prefix: str, hits4: np.ndarray, fingerprint: str) -> None:
    _save_arrays(f"{prefix}.hic.lk.bin", magic=MAGIC, fp=fingerprint,
                 hits4=np.asarray(hits4, np.int64))
    log("save_hic_hits", f"wrote {prefix}.hic.lk.bin ({len(hits4)} hits)")


def load_hic_hits(prefix: str, fingerprint: str):
    d = _load_arrays(f"{prefix}.hic.lk.bin")
    if d is None or d.get("fp") != fingerprint:
        return None
    log("load_hic_hits",
        f"resumed {len(d['hits4'])} PE hits from {prefix}.hic.lk.bin")
    return d["hits4"].reshape(-1, 4)


def save_ul_paths(prefix: str, paths, fingerprint: str) -> None:
    """UL traversals: CSR of (uid, rev, q_start, q_end) blocks."""
    off = np.zeros(len(paths) + 1, np.int64)
    for i, p in enumerate(paths):
        off[i + 1] = off[i] + len(p.blocks)
    blocks = np.array([b for p in paths for b in p.blocks],
                      np.int64).reshape(-1, 4)
    _save_arrays(f"{prefix}.ul.aln.bin", magic=MAGIC, fp=fingerprint,
                 off=off, blocks=blocks)
    log("save_ul_paths", f"wrote {prefix}.ul.aln.bin ({len(paths)} paths)")


def load_ul_paths(prefix: str, fingerprint: str):
    from hifiasm_tpu_torch.ul import ULPath

    d = _load_arrays(f"{prefix}.ul.aln.bin")
    if d is None or d.get("fp") != fingerprint:
        return None
    off = d["off"]
    blocks = d["blocks"].reshape(-1, 4)
    paths = [ULPath([tuple(int(x) for x in b)
                     for b in blocks[off[i]:off[i + 1]]])
             for i in range(len(off) - 1)]
    log("load_ul_paths",
        f"resumed {len(paths)} UL paths from {prefix}.ul.aln.bin")
    return paths


def save_trans_links(prefix: str, confirmed, fingerprint: str) -> None:
    """Base-level trans-overlap cache: the alignment-confirmed purge
    pairs [(a, b, afrac, ident, span5|None)] (the kv_u_trans dump,
    Overlaps.cpp:16379 — the expensive base-level inference result)."""
    rows = []
    for a, b, afrac, ident, span in confirmed:
        sp = list(span[:5]) if span is not None else [0] * 5
        rows.append([a, b, afrac, ident,
                     1.0 if span is not None else 0.0] + sp)
    arr = np.array(rows, np.float64).reshape(-1, 10)
    _save_arrays(f"{prefix}.trans.bin", magic=MAGIC, fp=fingerprint,
                 links=arr)
    log("save_trans_links", f"wrote {prefix}.trans.bin ({len(arr)} pairs)")


def load_trans_links(prefix: str, fingerprint: str):
    d = _load_arrays(f"{prefix}.trans.bin")
    if d is None or d.get("fp") != fingerprint:
        return None
    arr = d["links"].reshape(-1, 10)
    out = []
    for r in arr:
        span = tuple(int(x) for x in r[5:10]) if r[4] > 0 else None
        out.append((int(r[0]), int(r[1]), float(r[2]), float(r[3]), span))
    log("load_trans_links",
        f"resumed {len(out)} trans pairs from {prefix}.trans.bin")
    return out
