"""Device mesh of the multi-device path (port of hifiasm_tpu/parallel/mesh.py).

The JAX package runs its multi-chip path as one program over a 1-D
``data`` mesh (``shard_map`` bodies, ``all_to_all`` routing, ``psum``
reductions).  The port keeps that single-controller design: one process
drives an ordered list of devices.  A shard's stage runs on its device;
an ``all_to_all`` becomes one tensor copy per (source, destination)
pair, and a ``psum`` becomes an integer sum on the first device.

A mesh may list one device more than once ("logical shards"): every
shard then runs on that device, with its own row block and lanes, which
is how the CPU tests run an 8-shard mesh and how one card runs the
routed path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from hifiasm_tpu_torch.device import resolve_device


def device_of(device) -> torch.device:
    """A device with its index: tensors report ``cuda:0``, never ``cuda``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An ordered list of devices on the ``data`` axis; repeats allowed."""

    def __init__(self, devices: Sequence):
        devs = tuple(device_of(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh holds one device type, got {devs}")
        self.devices: Tuple[torch.device, ...] = devs

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The first ``n_devices`` cards (all visible cards when None), as
    ``jax.devices()[:n]``; for the CPU, ``n_devices`` logical shards."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * (n_devices or 1))
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs)
