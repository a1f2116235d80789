"""Classify engine: the share of the window the serving thread blocked on a
finish worker's result (the span engine.finish_wait), in percent.  High:
the finish workers set the pace; near 0: the serving thread does.  Read
from ClassifierTorch.stats "engine.finish_wait_s", after the window less
before it; nothing where the engine has no such counter."""

UNIT, LAYER, MOVES = "%", "classify engine", "reads_per_s"


def read(run):
    key = "engine.finish_wait_s"
    if key not in run.stats1 or not run.window_s:
        return None
    return 100.0 * (run.stats1[key] - run.stats0.get(key, 0.0)) / run.window_s
