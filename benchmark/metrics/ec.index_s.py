"""EC index build on the host (index/pos_table.py):
``pipeline.STATS["index_s"]`` over the EC rounds, seconds an assembly."""


def read(w):
    return w.per_assembly(lambda a: a["ec"]["index_s"])
