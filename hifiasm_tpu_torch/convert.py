"""State carried over from the JAX package.

This system has no weights; what carries over is configuration and data.
``config_from_reference`` builds the port's ``HifiasmConfig`` from
``dataclasses.asdict`` of the JAX package's config (the two dataclasses
have the same fields).  Reads carry over as the numpy code arrays of
``io.readstore.ReadStore.from_arrays``, and EC checkpoints
(``*.bin.npz``) through ``io.binfiles``.
"""

from __future__ import annotations

import dataclasses

from hifiasm_tpu_torch.config import HifiasmConfig


def config_from_reference(d: dict) -> HifiasmConfig:
    names = {f.name for f in dataclasses.fields(HifiasmConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"fields unknown to the port's config: {unknown}")
    return HifiasmConfig(**{k: (list(v) if isinstance(v, list) else v)
                            for k, v in d.items()})
