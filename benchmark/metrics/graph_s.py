"""Graph stages (graph/*): the stage walls string_graph, clean_unitig,
purge and write, less the Hi-C map, phasing and scaffolding that run
inside write, seconds an assembly."""

GRAPH = ("string_graph", "clean_unitig", "purge", "write")
INSIDE_WRITE = ("hic_map", "phase", "scaffold")


def read(w):
    return w.per_assembly(
        lambda a: sum(a["stage_s"].get(k, 0.0) for k in GRAPH) -
        sum(a["stage_s"].get(k, 0.0) for k in INSIDE_WRITE))
