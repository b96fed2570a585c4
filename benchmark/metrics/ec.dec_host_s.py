"""DeviceEC's host work (ec/device_ec.py): the bank upload, the window
planning, and the host work between and after the device stages (seam
evidence, per-overlap stats, chunk uploads, unpacking and packaging):
``device_ec.STATS`` bank_s + plan_s + host_s, seconds an assembly."""

KEYS = ("bank_s", "plan_s", "host_s")


def read(w):
    if any(k not in a["device_ec"] for a in w.assemblies for k in KEYS):
        return None
    return w.per_assembly(lambda a: sum(a["device_ec"][k] for k in KEYS))
