"""Index load: the seconds of set-up in the port's load of the index files
into host memory (the span load.index: build.load_index, or
interop/cfr.py load_cfr_index for a reference-built index), from the
process totals of centrifuger_tpu_torch/spans.py.  A run is one process,
which loads its index once; nothing where the port has no such span."""

import sys

UNIT, LAYER, MOVES = "s", "index load", "setup_s"


def read(run):
    spans = sys.modules.get("centrifuger_tpu_torch.spans")
    if spans is None:
        return None
    seconds, count = spans.totals().get("load.index", (0.0, 0))
    return seconds if count else None
