"""State carried over from the JAX package.

This system has no weights; what carries over is configuration and data.
``config_from_reference`` builds the port's ``HifiasmConfig`` from
``dataclasses.asdict`` of the JAX package's config (the two dataclasses
have the same fields).  Reads carry over as the numpy code arrays of
``io.readstore.ReadStore.from_arrays``, and EC checkpoints
(``*.bin.npz``) through ``io.binfiles``.  The device index carries over
through ``minimizers_from_reference`` (the columns of a JAX
``Minimizers``) and ``table_from_reference`` (the padded (hi, lo)
uint32 columns of a JAX ``DevicePositionTable``, as numpy arrays).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hifiasm_tpu_torch.config import HifiasmConfig
from hifiasm_tpu_torch.index.pos_table_dev import DevicePositionTable, flip_u64
from hifiasm_tpu_torch.ops.sketch import Minimizers


def config_from_reference(d: dict) -> HifiasmConfig:
    names = {f.name for f in dataclasses.fields(HifiasmConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"fields unknown to the port's config: {unknown}")
    return HifiasmConfig(**{k: (list(v) if isinstance(v, list) else v)
                            for k, v in d.items()})


def minimizers_from_reference(hash, pos, rev, span, cnt) -> Minimizers:
    """The port's Minimizers from the columns of a JAX ``Minimizers``,
    with the host dtypes (uint64, int64, uint8, int64, uint32)."""
    return Minimizers(np.asarray(hash, np.uint64), np.asarray(pos, np.int64),
                      np.asarray(rev, np.uint8), np.asarray(span, np.int64),
                      np.asarray(cnt, np.uint32))


def table_from_reference(h_hi, h_lo, start, count, rid, pos, rev, span,
                         n_distinct: int, tot_pos: int,
                         device="cpu") -> DevicePositionTable:
    """The port's DevicePositionTable from a JAX ``DevicePositionTable``'s
    columns: trimmed to ``n_distinct`` keys and ``tot_pos`` postings, the
    (hi, lo) hash halves joined into flipped int64 keys."""
    H, P = int(n_distinct), int(tot_pos)
    h = (np.asarray(h_hi, np.uint64)[:H] << np.uint64(32)) | \
        np.asarray(h_lo, np.uint64)[:H]

    def up(a, n, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a)[:n]).astype(dtype)).to(device)

    return DevicePositionTable(
        keys=up(flip_u64(h), H, np.int64), start=up(start, H, np.int64),
        count=up(count, H, np.int64), rid=up(rid, P, np.int64),
        pos=up(pos, P, np.int64), rev=up(rev, P, np.uint8),
        span=up(span, P, np.int64))
