"""K1 (csrc/banded_tb.cu) against its roofline: the least time the
card could take for the windows the window aligned (``roofline.k1_work``
on ``device_ec.STATS["windows"] + ["retry_windows"]``), over the device
time of every ``banded_tb_kernel`` launch in the trace, in per cent.
Nothing without a traced K1 launch."""

from benchmark import roofline

KERNEL = "banded_tb_kernel"


def read(w):
    if w.trace is None:
        return None
    t = w.trace.kernel_s(KERNEL)
    if t <= 0:
        return None
    windows = sum(a["device_ec"]["windows"] + a["device_ec"]["retry_windows"]
                  for a in w.assemblies)
    least, _ = roofline.bound_s(roofline.k1_work(windows))
    return 100.0 * least / t
