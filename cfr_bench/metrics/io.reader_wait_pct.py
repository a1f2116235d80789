"""Read parse: the share of the window the serving thread waited on an
empty read queue, in percent.  High: the reader sets the pace; near 0: the
engine does."""

UNIT, LAYER, MOVES = "%", "read parse", "reads_per_s"


def read(run):
    waits = sum(t1 - t0 for name, t0, t1 in run.spans.serving if name == "wait")
    return 100.0 * waits / run.window_s
