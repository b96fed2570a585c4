"""The port's one timer: a span around a stage, on the profiler's clock.

``span(name, stats, key)`` reads ``time.perf_counter()`` at entry and
exit and adds the difference to ``stats[key]``.  While a
``torch.profiler`` is collecting, it also opens a
``record_function(name)`` range around the same interval, so a stage's
seconds and its range in a trace are one interval on one clock.  With no
profiler, a span costs two clock reads and one flag test.  A span with
no name only times: it is for work repeated per read or per batch,
which would flood a trace with ranges.

Each module registers its counter dicts (``STATS``) here at import;
``reset()`` zeroes every registered dict.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function

_REGISTRY: Dict[str, dict] = {}


def register(name: str, stats: dict) -> dict:
    """Add ``stats`` to the dicts ``reset()`` zeroes; returns it."""
    _REGISTRY[name] = stats
    return stats


def reset() -> None:
    """Zero every registered dict: plain numbers to 0 of their type, and
    a dict of per-shard dicts emptied."""
    for st in _REGISTRY.values():
        if any(isinstance(v, dict) for v in st.values()):
            st.clear()
            continue
        for k, v in st.items():
            st[k] = type(v)(0)


class span:
    """``with span(name, stats, key):`` times the block into
    ``stats[key]`` (added to what is there; a missing key counts as 0)
    and, under a collecting profiler, records it as the range ``name``.
    ``s`` holds the block's seconds once it has run."""

    __slots__ = ("name", "stats", "key", "s", "_t0", "_range")

    def __init__(self, name: Optional[str], stats: Optional[dict] = None,
                 key: Optional[str] = None):
        self.name, self.stats, self.key = name, stats, key
        self.s = 0.0

    def __enter__(self) -> "span":
        # the clock reads lie just outside the range: a range's own
        # bookkeeping under the profiler falls inside both
        self._t0 = time.perf_counter()
        self._range = None
        if self.name is not None and _profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        self.s = time.perf_counter() - self._t0
        if self.stats is not None:
            self.stats[self.key] = self.stats.get(self.key, 0.0) + self.s
