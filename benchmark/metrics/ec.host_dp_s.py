"""The front end's host chain DP (overlap/chain_device.py):
``chain_device.STATS["host_dp_s"]``, seconds an assembly."""


def read(w):
    return w.per_assembly(lambda a: a["chain"]["host_dp_s"])
