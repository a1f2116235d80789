"""Set-up seconds: from the run's first line to the window's start (the
imports, the database and the index where a checkout has none yet, the
index load, the classifier, the read generator and one warm-up batch)."""

UNIT, LAYER, MOVES = "s", None, None


def read(run):
    return run.setup_s
