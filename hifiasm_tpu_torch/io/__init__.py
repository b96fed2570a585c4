from hifiasm_tpu_torch.io.fastx import iter_fastx  # noqa: F401
from hifiasm_tpu_torch.io.readstore import ReadStore, hpc_compress  # noqa: F401
