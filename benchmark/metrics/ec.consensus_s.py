"""Consensus and the host DAG re-run (ec/pipeline.py, ec/consensus.py):
``pipeline.STATS["consensus_s"]``, seconds an assembly."""


def read(w):
    return w.per_assembly(lambda a: a["ec"]["consensus_s"])
