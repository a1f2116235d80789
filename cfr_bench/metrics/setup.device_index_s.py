"""Index load: the seconds of set-up in the making of the device index from
the loaded one (the span load.device_index: TorchFM.from_index as the
classifier is made, with the wide rank rows decoded or read from their
cache file, and the uploads to the card), from the process totals of
centrifuger_tpu_torch/spans.py.  A run is one process, which makes one
classifier; nothing where the port has no such span."""

import sys

UNIT, LAYER, MOVES = "s", "index load", "setup_s"


def read(run):
    spans = sys.modules.get("centrifuger_tpu_torch.spans")
    if spans is None:
        return None
    seconds, count = spans.totals().get("load.device_index", (0.0, 0))
    return seconds if count else None
