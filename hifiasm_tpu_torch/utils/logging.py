"""Phase logging in the reference's ``[M::func::wall*cpu@GB]`` style (sys.cpp:9-59)."""

from __future__ import annotations

import os
import resource
import sys
import time

_T0 = time.time()


def _peak_rss_gb() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return ru / 1024.0 / 1024.0  # linux: KB


def log(fn: str, msg: str = "") -> None:
    wall = time.time() - _T0
    cpu = time.process_time()
    util = cpu / wall if wall > 0 else 0.0
    sys.stderr.write(f"[M::{fn}::{wall:.3f}*{util:.2f}@{_peak_rss_gb():.3f}GB] {msg}\n")
    sys.stderr.flush()
