"""The share of the entries given to the L2, L4 and seam vote
scatter-adds (ec/device_ec.py ``_scatter_count``) that the mask dropped
into a spare slot: 100 x the window's ``vote_dropped_adds`` over its
``vote_adds`` (``device_ec.STATS``).  Nothing where the program does
not count them, or made no vote."""


def read(w):
    recs = [a["device_ec"] for a in w.assemblies]
    if not recs or any("vote_adds" not in r for r in recs):
        return None
    n = sum(r["vote_adds"] for r in recs)
    if n == 0:
        return None
    return 100.0 * sum(r["vote_dropped_adds"] for r in recs) / n
