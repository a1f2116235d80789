"""Finish workers: their seconds on the exact host path of the units the
card flagged (the span finish.fallback: _finish_fallback_units, with its
batched prefix searches and SA resolves on the card), per read, in
microseconds; 0 in a window with no flagged unit.  Work on the workers, not
wall time.  Read from ClassifierTorch.stats "finish.fallback_s", after the
window less before it; nothing where the engine has no such counter."""

UNIT, LAYER, MOVES = "us/read", "finish workers", "reads_per_s"


def read(run):
    key = "finish.fallback_s"
    if key not in run.stats1 or not run.reads:
        return None
    return (run.stats1[key] - run.stats0.get(key, 0.0)) / run.reads * 1e6
