"""Classify engine: the serving thread's seconds in the call of the device
program (the span engine.launch: fused_classify or fused_classify_protein,
the kernels' enqueue and the wait for the card inside pack_results'
nonzero()), per read, in microseconds.  Read from ClassifierTorch.stats
"engine.launch_s", after the window less before it; nothing where the
engine has no such counter."""

UNIT, LAYER, MOVES = "us/read", "classify engine", "reads_per_s"


def read(run):
    key = "engine.launch_s"
    if key not in run.stats1 or not run.reads:
        return None
    return (run.stats1[key] - run.stats0.get(key, 0.0)) / run.reads * 1e6
