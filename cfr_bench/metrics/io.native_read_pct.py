"""Read parse: the share of the reads ReadFiles gave through its native
pass (native/fastqpack.cpp fqp_records) against its line parser
(parse_fastx), in percent, from the process counters io.native_reads and
io.line_reads of centrifuger_tpu_torch/spans.py.  A run is one process:
the counts take in the warm-up batch's reads as well as the window's.
Nothing where the port has no such counters, or its ReadFiles gave no
read (the bulk route)."""

import sys

UNIT, LAYER, MOVES = "%", "read parse", "reads_per_s"


def read(run):
    spans = sys.modules.get("centrifuger_tpu_torch.spans")
    if spans is None:
        return None
    totals = spans.totals()
    native = totals.get("io.native_reads", (0.0, 0))[1]
    lines = totals.get("io.line_reads", (0.0, 0))[1]
    return 100.0 * native / (native + lines) if native + lines else None
