"""The share of the reads through consensus (ec/pipeline.py) that re-ran
on the host DAG path: 100 x the window's ``host_dag_reads`` over its
``consensus_reads`` (``pipeline.STATS``).  Nothing where the program
does not count the reads through consensus, or none went through."""


def read(w):
    recs = [a["ec"] for a in w.assemblies]
    if not recs or any("consensus_reads" not in r for r in recs):
        return None
    n = sum(r["consensus_reads"] for r in recs)
    if n == 0:
        return None
    return 100.0 * sum(r["host_dag_reads"] for r in recs) / n
