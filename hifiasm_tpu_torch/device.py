"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` whose default is
``"cuda"``.  The CPU runs only when the caller asks for it; a request
for CUDA on a machine without a CUDA device raises instead of carrying
on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
