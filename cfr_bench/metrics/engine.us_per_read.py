"""Classify engine: the serving thread's seconds inside the engine's
generators (query_pipelined_packed, serve_tsv_prepacked), less the waits on
the read queue and the CLI's conversion of reads into queries that run
inside them, per read, in microseconds."""

UNIT, LAYER, MOVES = "us/read", "classify engine", "reads_per_s"


def read(run):
    by = {}
    for name, t0, t1 in run.spans.serving:
        by[name] = by.get(name, 0.0) + (t1 - t0)
    if not run.reads or "engine" not in by:
        return None
    own = by["engine"] - by.get("wait", 0.0) - by.get("batch_queries", 0.0)
    return own / run.reads * 1e6
