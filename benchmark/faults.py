"""The control and the planted faults that the comparison must catch.

None of these runs in a benchmark run.  ``calibrate.py`` reads them on
the card to set each limit's upper reading, and ``tests/`` drives a run
with each and needs ``correct`` false.  A variant may change the
configuration (``cfg``), replace a function of the program while the
assembly runs (``patch``), and rewrite the contigs the assembly wrote
(``post``).

- ``ec_rounds_1``, ``ec_rounds_2``, ``ec_off``: one, two and no rounds
  of error correction where the configurations state three (hifiasm's
  ``-r3``).  ``CONTROL`` names the one that sets the upper readings.
- ``ec_unchanged``: every EC round returns the reads unchanged (a step
  that returns its state unchanged).
- ``ec_half``: every EC round keeps its corrections of half the reads
  only (half of the batch left out).
- ``ctg_half``: the second half of every contig left out.
- ``ctg_altered``: one base in every 500 of every contig changed where
  the contig is written (an answer altered where it is produced).
- ``hic_unlinked``: the Hi-C contact matrix left empty, so phasing has
  no Hi-C signal.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


@dataclass
class Variant:
    cfg: Dict[str, object] = field(default_factory=dict)
    patch: Optional[Callable[[], contextlib.AbstractContextManager]] = None
    post: Optional[Callable[[str], None]] = None


@contextlib.contextmanager
def _ec_keep(share_kept: float):
    """Each EC round's corrections undone for all but ``share_kept`` of
    the reads (every read at 0, every other read at 0.5)."""
    import hifiasm_tpu_torch.ec.pipeline as P

    orig = P.ec_round

    def wrapped(store, *a, **kw):
        before = [store.get_codes(i).copy() for i in range(store.n_reads)]
        out = orig(store, *a, **kw)
        step = 2 if share_kept else 1
        for i in range(0, store.n_reads, step):
            store.set_codes(i, before[i])
        return out

    P.ec_round = wrapped
    try:
        yield
    finally:
        P.ec_round = orig


@contextlib.contextmanager
def _no_hic_links():
    import hifiasm_tpu_torch.phasing.hic as H

    orig = H.hic_link_matrix
    H.hic_link_matrix = lambda *a, **kw: {}
    try:
        yield
    finally:
        H.hic_link_matrix = orig


def _rewrite_segments(path: str, fn) -> None:
    with open(path, "rb") as f:
        lines = f.readlines()
    out = []
    for ln in lines:
        if ln.startswith(b"S\t"):
            cols = ln.split(b"\t")
            cols[2] = fn(cols[2])
            ln = b"\t".join(cols)
        out.append(ln)
    with open(path, "wb") as f:
        f.writelines(out)


def _drop_half(path: str) -> None:
    _rewrite_segments(path, lambda s: s[:len(s) // 2])


def _alter(path: str) -> None:
    swap = bytes.maketrans(b"ACGTacgt", b"CGTAcgta")

    def fn(s):
        b = bytearray(s)
        for p in range(250, len(b), 500):
            b[p:p + 1] = bytes(b[p:p + 1]).translate(swap)
        return bytes(b)
    _rewrite_segments(path, fn)


VARIANTS: Dict[str, Variant] = {
    "ec_rounds_1": Variant(cfg={"n_rounds_ec": 1}),
    "ec_rounds_2": Variant(cfg={"n_rounds_ec": 2}),
    "ec_off": Variant(cfg={"n_rounds_ec": 0}),
    "ec_unchanged": Variant(patch=lambda: _ec_keep(0.0)),
    "ec_half": Variant(patch=lambda: _ec_keep(0.5)),
    "ctg_half": Variant(post=_drop_half),
    "ctg_altered": Variant(post=_alter),
    "hic_unlinked": Variant(patch=_no_hic_links),
}

CONTROL = "ec_off"
