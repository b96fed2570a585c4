#!/usr/bin/env python3
"""Device idle share of a torch.profiler Chrome trace (``--profile DIR``
writes one, ``ec_r<round>.json``, per EC round).

    python3 scripts/trace_idle.py TRACE.json [TRACE.json ...]

Per trace it prints one JSON line:

- ``window_us``: the traced window (first event start to last event end);
- ``device_busy_us`` and ``idle_share``: the union of the device's kernel,
  copy and set intervals, and 1 - busy / window;
- ``gaps``: the largest stretches with nothing on the device (start
  offset into the window and length, us);
- ``stages``: per ``ec.*`` span of the round (``utils/trace.py``:
  ec.round, ec.index, ec.frontend and its parts, ec.device_ec, DeviceEC's
  ec.L1 ... ec.L5, ec.consensus): the range's host wall time, the
  kernels launched inside it (matched through the launch's correlation
  id, each to the innermost range open at its launch), their summed
  device time, and the host time those kernels do not cover (wall -
  device), an upper bound on what launch and host overhead cost the
  stage;
- ``vote``: the L2-L5 ranges together (ec.L2, ec.het, ec.L3, ec.L4,
  ec.L5: ``vote_s``): their host wall time, the device's busy time
  inside that wall and the share it is busy; 1 - busy share is the part
  of ``vote_s`` the device spends waiting on the host (launches, host
  work, syncs).  Kernels run after their launch, so a stage's own
  ``uncovered_us`` can be negative; the union is the measure;
- ``kernels_top``: the kernels with the most device time.

A trace of a CPU run has no device events; its device numbers are 0.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
VOTE = ("ec.L2", "ec.het", "ec.L3", "ec.L4", "ec.L5")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def analyse(path: str, n_gaps: int = 5, n_top: int = 8) -> dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("cat") != "Trace"]
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(e - s for s, e in busy)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = sorted(((edges[i], edges[i + 1] - edges[i])
                   for i in range(0, len(edges), 2)),
                  key=lambda g: -g[1])[:n_gaps]
    # kernel -> the host launch that issued it -> the ec.* range around it
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("ec.")]
    stages = defaultdict(lambda: {"wall_us": 0.0, "kernels": 0,
                                  "device_us": 0.0})
    for r in ranges:
        stages[r["name"]]["wall_us"] += r["dur"]
    for k in dev:
        if k.get("cat") != "kernel":
            continue
        ln = launch.get(k.get("args", {}).get("correlation"))
        if ln is None:
            continue
        # the innermost: the latest start, the shortest of equal starts
        inner = None
        for r in ranges:
            if r["tid"] == ln["tid"] and \
                    r["ts"] <= ln["ts"] <= r["ts"] + r["dur"] and \
                    (inner is None or (r["ts"], -r["dur"]) >
                     (inner["ts"], -inner["dur"])):
                inner = r
        if inner is not None:
            stages[inner["name"]]["kernels"] += 1
            stages[inner["name"]]["device_us"] += k["dur"]
    for st in stages.values():
        st["uncovered_us"] = st["wall_us"] - st["device_us"]
    vote_wall = _merge([(r["ts"], r["ts"] + r["dur"]) for r in ranges
                        if r["name"] in VOTE])
    v_wall = sum(e - s for s, e in vote_wall)
    v_busy = _overlap(vote_wall, busy)
    vote = {"wall_us": v_wall, "device_busy_us": v_busy,
            "busy_share": v_busy / v_wall if v_wall else 0.0,
            "kernels": sum(stages[n]["kernels"] for n in VOTE
                           if n in stages),
            "kernel_us": sum(stages[n]["device_us"] for n in VOTE
                             if n in stages)}
    by_name = defaultdict(lambda: [0, 0.0])
    for k in dev:
        if k.get("cat") == "kernel":
            by_name[k["name"]][0] += 1
            by_name[k["name"]][1] += k["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n_top]
    window = t1 - t0
    return {"trace": path, "window_us": window,
            "device_events": len(dev), "device_busy_us": busy_us,
            "idle_share": 1.0 - busy_us / window if window else 0.0,
            "gaps": [{"at_us": s - t0, "us": d} for s, d in gaps],
            "stages": dict(sorted(stages.items())), "vote": vote,
            "kernels_top": [{"name": n[:120], "launches": c, "us": us}
                            for n, (c, us) in top]}


def main(argv) -> int:
    if not argv:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    for p in argv:
        print(json.dumps(analyse(p)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
