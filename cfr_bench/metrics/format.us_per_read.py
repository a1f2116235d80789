"""TSV format and write: the serving thread's seconds in format_tsv_batch
and the write, per read, in microseconds.  Only the object route formats
on the serving thread; the bulk route formats on the engine's finish
workers, where no span of the harness reaches, and reports nothing."""

UNIT, LAYER, MOVES = "us/read", "TSV format and write", "reads_per_s"


def read(run):
    t = sum(t1 - t0 for name, t0, t1 in run.spans.serving if name == "format")
    return t / run.reads * 1e6 if t and run.reads else None
