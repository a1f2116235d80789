"""Classify engine: the serving thread's seconds uploading the window's
batches (the span engine.upload: every ClassifierTorch._upload of a batch,
each a pinned host copy and a non-blocking copy to the card), per read, in
microseconds.  Read from ClassifierTorch.stats "engine.upload_s", after the
window less before it; nothing where the engine has no such counter."""

UNIT, LAYER, MOVES = "us/read", "classify engine", "reads_per_s"


def read(run):
    key = "engine.upload_s"
    if key not in run.stats1 or not run.reads:
        return None
    return (run.stats1[key] - run.stats0.get(key, 0.0)) / run.reads * 1e6
