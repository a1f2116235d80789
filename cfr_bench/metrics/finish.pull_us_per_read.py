"""Finish workers: their seconds pulling the window's batches' results (the
span finish.pull: _pull_results, the wait for the card, the copy of the one
result blob to the host and its unpacking), per read, in microseconds.  The
workers overlap the serving thread and each other, so this is work, not
wall time.  Read from ClassifierTorch.stats "finish.pull_s", after the
window less before it; nothing where the engine has no such counter."""

UNIT, LAYER, MOVES = "us/read", "finish workers", "reads_per_s"


def read(run):
    key = "finish.pull_s"
    if key not in run.stats1 or not run.reads:
        return None
    return (run.stats1[key] - run.stats0.get(key, 0.0)) / run.reads * 1e6
