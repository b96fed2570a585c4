from hifiasm_tpu_torch.utils.logging import log, phase_timer  # noqa: F401
