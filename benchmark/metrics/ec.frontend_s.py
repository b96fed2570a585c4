"""EC front end (ec/pipeline.py ``_chain_all_reads_device``,
index/pos_table_dev.py, overlap/chain_device.py, ops/chain_batch.py):
``pipeline.STATS["chain_s"]``, seconds an assembly."""


def read(w):
    return w.per_assembly(lambda a: a["ec"]["chain_s"])
