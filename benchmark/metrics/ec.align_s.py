"""EC L1, window gather and K1 (ec/device_ec.py, ops/banded_tb.py):
``device_ec.STATS["align_s"]``, seconds an assembly."""


def read(w):
    return w.per_assembly(lambda a: a["device_ec"]["align_s"])
