"""Device: the share of the window in which no operation ran on the card,
in percent: 1 - (union of the profiler's device intervals) / window."""

UNIT, LAYER, MOVES = "%", "device", "reads_per_s"


def read(run):
    if run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
