"""The run process's peak resident memory (getrusage ru_maxrss) at the
window's end, before the reference runs, in GiB.  The index build is a
child process and does not count."""

UNIT, LAYER, MOVES = "GiB", None, None


def read(run):
    return run.host_rss_gib
