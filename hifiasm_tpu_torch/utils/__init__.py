from hifiasm_tpu_torch.utils.logging import log  # noqa: F401
