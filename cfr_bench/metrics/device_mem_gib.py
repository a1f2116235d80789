"""The card memory the index and the batches in flight took:
torch.cuda.max_memory_allocated() over set-up and window, in GiB (the
port's kernels allocate nothing outside torch's allocator)."""

UNIT, LAYER, MOVES = "GiB", None, None


def read(run):
    return run.device_mem_gib
