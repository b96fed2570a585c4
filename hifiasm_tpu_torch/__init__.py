"""hifiasm-tpu-torch: the PyTorch/CUDA port of hifiasm_tpu.

Every entry point and mode of the JAX package runs: the default ``bp``
assembly of HiFi reads, ultralong integration (``--ul``), trio binning
(``dip.*``), Hi-C phasing and scaffolding (``hic.*``), polyploid output,
``--dual-scaf`` and the debug surfaces.  Host stages (index, chaining,
graph, phasing, writers) are copied from hifiasm_tpu.  Error correction
runs on one CUDA card, or on a mesh of cards (every visible card unless
``mesh_devices`` caps it: parallel/), with its anchor gather, quick
chaining and window plans on the card and its window alignment on the
hand-written kernel csrc/banded_tb.cu (K1), on every shard of a mesh.
The Hi-C rescue and the UL screen and junction checks score on
csrc/banded_fwd.cu (K2).  ``--profile DIR`` writes a profiler trace of
each EC round.  The package imports torch and numpy, never jax and
nothing of hifiasm_tpu.
"""

__version__ = "0.1.0"

from hifiasm_tpu_torch.config import HifiasmConfig  # noqa: F401,E402
