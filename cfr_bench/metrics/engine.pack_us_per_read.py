"""Classify engine: the serving thread's seconds packing the window's
batches (the span engine.pack: _pack_reads, or _pack_reads_protein with its
six-frame translation), per read, in microseconds.  Read from the engine's
own counter, ClassifierTorch.stats "engine.pack_s", after the window less
before it; nothing where the engine has no such counter.  The bulk route
packs on its producer thread, in the native parse, and reads 0 here."""

UNIT, LAYER, MOVES = "us/read", "classify engine", "reads_per_s"


def read(run):
    key = "engine.pack_s"
    if key not in run.stats1 or not run.reads:
        return None
    return (run.stats1[key] - run.stats0.get(key, 0.0)) / run.reads * 1e6
