"""Read parse: the producer thread's seconds inside the port's reader
(ReadFiles on the object route; iter_prepacked's native parse and pack on
the bulk route), per read, in microseconds.  On the bulk route the
seconds from the reader's open of each chunk FIFO to the generator's
close of it (the most the reader can have waited on the generator inside
that read) are left out, and its waits for the next file are outside the
span.  On the object route nothing is left out: the generator's writers
keep a full pipe ahead of the reader, and the run's log gives the seconds
a writer had nothing made to write."""

UNIT, LAYER, MOVES = "us/read", "read parse", "reads_per_s"


def read(run):
    sp = run.spans
    if not sp.per_read or not sp.parsed:
        return None
    return max(sp.parse_s - run.feed_wait_s, 0.0) / sp.parsed * 1e6
