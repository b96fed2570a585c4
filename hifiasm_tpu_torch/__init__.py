"""hifiasm-tpu-torch: the PyTorch/CUDA port of hifiasm_tpu.

The default ``bp`` assembly of HiFi reads runs end to end: host index,
chaining, graph and writers (copied from hifiasm_tpu), and error
correction on one CUDA card (ec/device_ec.py), whose window alignment is
the hand-written kernel csrc/banded_tb.cu.  The package imports torch and
numpy, never jax and nothing of hifiasm_tpu.
"""

__version__ = "0.1.0"

from hifiasm_tpu_torch.config import HifiasmConfig  # noqa: F401,E402
