"""Reads classified per second: reads whose TSV rows the window wrote (a
pair is one read, as in the TSV), over all of the window's time, the drain
of the batches in flight included."""

UNIT, LAYER, MOVES = "reads/s", None, None


def read(run):
    return run.reads / run.window_s if run.reads else None
