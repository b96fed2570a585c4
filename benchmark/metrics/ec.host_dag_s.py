"""The host DAG re-run inside consensus (ec/pipeline.py ``_host_dag``):
``pipeline.STATS["host_dag_s"]``, seconds an assembly.  Nothing where
the program keeps no such timer."""


def read(w):
    if any("host_dag_s" not in a["ec"] for a in w.assemblies):
        return None
    return w.per_assembly(lambda a: a["ec"]["host_dag_s"])
