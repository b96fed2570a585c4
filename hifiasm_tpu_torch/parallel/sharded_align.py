"""Data-parallel device steps over a mesh.

The port of hifiasm_tpu/parallel/sharded_align.py.  The per-read
``kt_for`` fan-out of the reference (ecovlp.cpp:6078) becomes batch
sharding: problems split into one equal slice per shard, each shard runs
its slice on its own device, and the per-step statistics (aligned
windows, total errors: the ``b->cnt[]`` aggregation of
Assembly.cpp:1111) are summed as integers.  The window alignment is K1
(ops/banded_tb.banded_tb) on every shard.
"""

from __future__ import annotations

from typing import List

import torch

from hifiasm_tpu_torch.ops.banded_tb import banded_tb
from hifiasm_tpu_torch.ops.chain_dev import chain_scores_batch
from hifiasm_tpu_torch.parallel.mesh import Mesh


def shard_rows(mesh: Mesh, *arrs) -> List[tuple]:
    """Split host arrays on their first axis into one equal slice per
    shard, each on its shard's device (the ``P("data")`` layout)."""
    S = len(mesh)
    n = len(arrs[0])
    if n % S:
        raise ValueError(f"a batch of {n} does not split over {S} shards")
    per = n // S
    return [tuple(torch.as_tensor(a[d * per:(d + 1) * per]).contiguous()
                  .to(dev) for a in arrs)
            for d, dev in enumerate(mesh.devices)]


def _on(dev: torch.device, ts) -> None:
    for t in ts:
        if t.device != dev:
            raise ValueError(f"a shard input is on {t.device}, its shard "
                             f"on {dev}")


def make_sharded_align_step(mesh: Mesh, e: int):
    """Returns step(x, xlen, y, ylen) over host arrays -> (err, y_start,
    y_end, tb, ic, ib, stats): outputs per window on the mesh's first
    device, stats = [aligned windows, error sum] summed over shards."""

    def step(x, xlen, y, ylen):
        outs = []
        for dev, args in zip(mesh.devices, shard_rows(mesh, x, xlen, y,
                                                      ylen)):
            _on(dev, args)
            res = banded_tb(*args, e)
            ok = res[0] >= 0
            st = torch.stack([ok.sum(), torch.where(ok, res[0], 0).sum()])
            outs.append(res + (st,))
        dev0 = mesh.devices[0]
        cols = [torch.cat([o[k].to(dev0) for o in outs]) for k in range(6)]
        stats = sum(o[6].to(dev0) for o in outs).int()
        return (*cols, stats)

    return step


def make_sharded_chain_step(mesh: Mesh):
    """Returns step(self_off, t_off, span, weight, n, xl, yl) over padded
    [B, N] anchor groups -> (best chain score, its end index)
    per group (the device half of lchain_qdp, Hash_Table.cpp:1841), each
    shard scoring its slice on its device."""

    def step(self_off, t_off, span, weight, n, xl, yl):
        outs = []
        for dev, args in zip(mesh.devices, shard_rows(
                mesh, self_off, t_off, span, weight, n, xl, yl)):
            _on(dev, args)
            f, _ = chain_scores_batch(*args)
            best = torch.argmax(f, dim=1)
            outs.append((f.gather(1, best[:, None])[:, 0], best.int()))
        dev0 = mesh.devices[0]
        return tuple(torch.cat([o[k].to(dev0) for o in outs])
                     for k in range(2))

    return step
