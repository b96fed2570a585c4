"""The device's busy and idle time, kernel times and idle gaps, from a
``torch.profiler`` trace of the window.

The busy-interval arithmetic is ``scripts/trace_idle.py``'s: the union of
the device's kernel, copy and set intervals.  The window is the union of
the harness's own ``bench.assembly`` spans, one around each timed
assembly, so the bookkeeping between assemblies is not counted.  An idle
gap is named by the innermost ``ec.*`` span (``DeviceEC``'s
``record_function`` ranges) open on the host at its midpoint, or
"outside DeviceEC".
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import List, Optional, Tuple

ASSEMBLY_SPAN = "bench.assembly"

Interval = Tuple[str, float, float]        # name, start s, end s


def merge(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(merged, lo: float, hi: float) -> List[List[float]]:
    return [[max(s, lo), min(e, hi)] for s, e in merged if e > lo and s < hi]


@dataclass
class Trace:
    device: List[Interval]      # kernels, copies and sets on the device
    spans: List[Interval]       # host ranges: ec.* and bench.assembly

    def windows(self) -> List[Tuple[float, float]]:
        return [(s, e) for n, s, e in self.spans if n == ASSEMBLY_SPAN]

    def window_s(self) -> float:
        return sum(e - s for s, e in self.windows())

    def busy(self) -> List[List[float]]:
        merged = merge((s, e) for _, s, e in self.device)
        return [iv for lo, hi in self.windows()
                for iv in _clip(merged, lo, hi)]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def idle_pct(self) -> Optional[float]:
        """Per cent of the window with nothing on the device; None when
        the trace holds no device activity (a CPU run)."""
        w = self.window_s()
        if not self.device or w <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / w)

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of every kernel whose name holds ``fragment``."""
        return sum(e - s for n, s, e in self.device if fragment in n)

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for name, s, e in self.device:
            by[name] += e - s
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _label(self, t: float) -> str:
        inner = None
        for name, s, e in self.spans:
            if name.startswith("ec.") and s <= t < e and \
                    (inner is None or s > inner[1]):
                inner = (name, s)
        return inner[0] if inner else "outside DeviceEC"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches of a window with nothing on the
        device: [label (assembly, seconds into it), seconds]."""
        busy = merge((s, e) for _, s, e in self.device)
        gaps = []
        for k, (lo, hi) in enumerate(self.windows()):
            edges = [lo] + [x for iv in _clip(busy, lo, hi) for x in iv] + \
                [hi]
            for i in range(0, len(edges), 2):
                if edges[i + 1] > edges[i]:
                    gaps.append((edges[i + 1] - edges[i], edges[i], k, lo))
        gaps.sort(key=lambda g: -g[0])
        return [[f"{self._label(t + d / 2)} (assembly {k}, at {t - lo:.2f} s)",
                 d] for d, t, k, lo in gaps[:n]]


def _is_span(name: str) -> bool:
    return name == ASSEMBLY_SPAN or name.startswith("ec.")


def from_profiler(prof) -> Trace:
    """The device intervals and the host ranges of a finished
    ``torch.profiler.profile``, read from its Kineto events: an event on
    the CUDA device is a kernel, copy or set unless it carries a span's
    name (the device's copy of a ``record_function`` range)."""
    import torch

    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and not _is_span(name):
            device.append((name, s, e))
        elif not on_device and _is_span(name):
            spans.append((name, s, e))
    return Trace(device, spans)
