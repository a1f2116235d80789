"""Classify engine: units (reads or pairs) the device flagged for the
host's exact path, over all units the engine counted in the window, in
percent (ClassifierTorch.stats: fallback_units of the fused engine,
slow_units of the unfused one, fast_units)."""

UNIT, LAYER, MOVES = "%", "classify engine", "reads_per_s"


def read(run):
    def delta(key):
        return run.stats1.get(key, 0) - run.stats0.get(key, 0)
    slow = delta("fallback_units") + delta("slow_units")
    total = slow + delta("fast_units")
    return 100.0 * slow / total if total else None
