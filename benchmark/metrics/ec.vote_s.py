"""EC L2-L5 votes on the card (ec/device_ec.py):
``device_ec.STATS["vote_s"]``, seconds an assembly."""


def read(w):
    return w.per_assembly(lambda a: a["device_ec"]["vote_s"])
