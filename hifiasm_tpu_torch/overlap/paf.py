"""Columnar overlap-record store (the ``ma_hit_t_alloc`` analog).

The reference keeps one fwd (``R_INF.paf``) and one reverse/trans
(``R_INF.reverse_paf``) vector of ``ma_hit_t`` per read
(Process_Read.h:90-113, 140-141).  Records here are columnar numpy arrays
grouped per query read so whole batches can move to device and graph build
can consume them wholesale.

Field semantics follow ``ma_hit_t`` (Overlaps.h:118-133):
  qs/qe  query start / one-past-end of the overlap region
  ts/te  target coordinates in the TARGET's forward frame
  rev    1 if the overlap is query-forward vs target-reverse
  ml     matched length (bl minus edit errors) -- used as arc quality
  bl     block (overlap) length on the query
  el     1 if the overlap is "exact"/strong (low error rate)
  no_l_indel  1 if no long indel detected inside the overlap
  del_   record deleted (filtered) flag
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

_FIELDS = ("qs", "qe", "tn", "ts", "te", "rev", "ml", "bl", "el",
           "no_l_indel", "del_")
_DTYPES = dict(qs=np.int64, qe=np.int64, tn=np.uint32, ts=np.int64,
               te=np.int64, rev=np.uint8, ml=np.int64, bl=np.int64,
               el=np.uint8, no_l_indel=np.uint8, del_=np.uint8)


@dataclass
class PafRecords:
    """Overlaps of ONE query read, columnar."""

    qs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    qe: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    tn: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    ts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    te: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    rev: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    ml: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    bl: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    el: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    no_l_indel: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    del_: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))

    def __len__(self):
        return len(self.tn)

    def take(self, idx) -> "PafRecords":
        return PafRecords(**{f: getattr(self, f)[idx] for f in _FIELDS})

    @classmethod
    def from_columns(cls, **cols) -> "PafRecords":
        n = len(next(iter(cols.values()))) if cols else 0
        out = {}
        for f in _FIELDS:
            if f in cols:
                out[f] = np.asarray(cols[f]).astype(_DTYPES[f])
            else:
                out[f] = np.zeros(n, _DTYPES[f])
        return cls(**out)


class PafStore:
    """Per-read overlap vectors for the whole read set (~R_INF.paf)."""

    def __init__(self, n_reads: int):
        self.recs: List[PafRecords] = [PafRecords() for _ in range(n_reads)]

    def __getitem__(self, rid: int) -> PafRecords:
        return self.recs[rid]

    def __setitem__(self, rid: int, v: PafRecords):
        self.recs[rid] = v

    def __len__(self):
        return len(self.recs)

    @property
    def total(self) -> int:
        return sum(len(r) for r in self.recs)

    def flatten(self):
        """(qn, columns...) flat view for graph build / serialization."""
        if not self.recs:
            return np.zeros(0, np.uint32), \
                {f: np.zeros(0, _DTYPES[f]) for f in _FIELDS}
        counts = np.fromiter((len(r) for r in self.recs), np.int64,
                             len(self.recs))
        qn = np.repeat(np.arange(len(self.recs), dtype=np.uint32), counts)
        cols = {f: np.concatenate([getattr(r, f) for r in self.recs])
                for f in _FIELDS}
        return qn, cols
