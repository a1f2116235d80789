"""Kernels: device milliseconds of the port's hand-written kernels
(profiler names `<name>_kernel<...>`) per 1,000 reads of the window."""

UNIT, LAYER, MOVES = "ms/kread", "kernels", "reads_per_s"


def read(run):
    if run.kernel_s is None or not run.reads:
        return None
    return run.kernel_s * 1e3 / (run.reads / 1e3)
