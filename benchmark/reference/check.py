"""The numbers that decide ``correct``, for one assembly.

- ``ec_edit_ppm``: the corrected reads that error correction leaves in
  the store, every one, each against the sequence it was drawn from
  (``edits.edit_distance``): edits per million bases of truth;
- ``ctg_err_ppm``: every contig of the configuration's outputs, by
  ``Truth.err_ppm``;
- ``ctg_missed_pct``: the haplotypes' k-mers that no contig holds;
- ``phase_err_pct`` (phased outputs only): ``Truth.phase_err_pct`` over
  the haplotype outputs.

A number must not exceed its limit; a missing output file reads as the
worst value, so an assembly that writes nothing fails.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark.reference.edits import edit_distance
from benchmark.reference.kmers import Truth, codes_of


def ec_edits(pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    """Edits of each (corrected read, its truth) pair."""
    return np.array([edit_distance(r, t) for r, t in pairs], np.int64)


def ec_edit_ppm(edits: np.ndarray, truth_bases: int) -> float:
    return 1e6 * float(edits.sum()) / truth_bases if truth_bases else 1e6


def gfa_contigs(path: str) -> List[np.ndarray]:
    """The sequences of a GFA's segment (S) lines."""
    out = []
    with open(path, "rb") as f:
        for ln in f:
            if ln.startswith(b"S\t"):
                out.append(codes_of(ln.split(b"\t")[2]))
    return out


def numbers(haps: Sequence[np.ndarray],
            ec_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
            outputs: Sequence[str], phased: bool) -> Dict[str, float]:
    """The numbers of one assembly: ``ec_pairs`` holds each corrected
    read with its truth, ``outputs`` the contig files."""
    res = {"ec_edit_ppm": ec_edit_ppm(ec_edits(ec_pairs),
                                      sum(len(t) for _, t in ec_pairs))}
    if not all(os.path.exists(p) for p in outputs):
        res.update(ctg_err_ppm=1e6, ctg_missed_pct=100.0)
        if phased:
            res["phase_err_pct"] = 100.0
        return res
    truth = Truth(haps)
    per_output = [gfa_contigs(p) for p in outputs]
    contigs = [c for cs in per_output for c in cs]
    res["ctg_err_ppm"] = truth.err_ppm(contigs)
    res["ctg_missed_pct"] = truth.missed_pct(contigs)
    if phased:
        res["phase_err_pct"] = truth.phase_err_pct(per_output)
    return res


def verdict(per_assembly: List[Dict[str, float]],
            limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number's worst reading over the assemblies, beside its
    limit."""
    out = {}
    for name, lim in limits.items():
        vals = [a[name] for a in per_assembly if name in a]
        out[name] = {"value": max(vals) if vals else None, "limit": lim}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
