"""Filter table (index/pos_table.py via assemble.py): the stage wall
``stage_s["filter_table"]``, seconds an assembly."""


def read(w):
    return w.per_assembly(lambda a: a["stage_s"]["filter_table"])
