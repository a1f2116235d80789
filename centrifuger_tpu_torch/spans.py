"""Spans and counters of the port's own work, on time.perf_counter's clock.

A span times one stage of the program.  Inside a batch it adds its seconds
to the batch's Tally (``with tally.span("engine.pack"): ...``), which the
classifier folds into its stats (classify/engine.py); before any classifier
exists, ``with span("load.index"): ...`` adds its seconds and a count to
the process totals (totals()).  Both always count, at two perf_counter reads
a span.  count(name, n) adds n to a process total's count with no time:
a counter (io.native_reads and io.line_reads, the reads each of
ReadFiles' two parsers gave, io/readers.py).

After enable(), every span is also kept in memory as a Record: its name,
t0 and t1 in perf_counter seconds, the thread's name, the batch number and
the name of the span open around it on the same thread.  perf_counter is
the clock cfr_bench/trace.py ties to torch.profiler's, so a record lands on
a device trace's timeline with one subtraction.  write_chrome_trace(path)
writes the records as a Chrome trace (Perfetto, chrome://tracing).

No profiler range and no device synchronisation: a span costs the same
with or without a card, and nothing here runs per read.
"""

import json
import os
import threading
import time
from collections import namedtuple

pc = time.perf_counter

Record = namedtuple("Record", "name t0 t1 thread batch parent")

_on = False
_records = []
_local = threading.local()   # .top: the innermost recording span of the thread
_lock = threading.Lock()
_totals = {}                 # name -> [seconds, count] of the spans with no tally, and counters


def enable(on=True):
    """Keep a Record of every span from now on (a fresh list), or stop."""
    global _on
    if on:
        del _records[:]
    _on = bool(on)


def records():
    """The Records kept since enable(), in the order the spans ended."""
    return list(_records)


def totals():
    """{name: (seconds, count)} of the spans counted into the process."""
    with _lock:
        return {k: tuple(v) for k, v in _totals.items()}


class Span:
    """One timed stage: a context manager.  `seconds` is the dict its time
    is added to (None: the process totals; a dict without the span's name:
    nowhere, a span that only groups others in the records); `batch` the
    batch's number, or None to take the enclosing span's."""

    __slots__ = ("name", "seconds", "batch", "t0", "parent", "recording")

    def __init__(self, name, seconds=None, batch=None):
        self.name = name
        self.seconds = seconds
        self.batch = batch

    def __enter__(self):
        self.recording = _on
        if self.recording:
            self.parent = getattr(_local, "top", None)
            if self.batch is None and self.parent is not None:
                self.batch = self.parent.batch
            _local.top = self
        self.t0 = pc()
        return self

    def __exit__(self, *exc):
        t1 = pc()
        dt = t1 - self.t0
        if self.seconds is None:
            with _lock:
                tot = _totals.setdefault(self.name, [0.0, 0])
                tot[0] += dt
                tot[1] += 1
        elif self.name in self.seconds:
            self.seconds[self.name] += dt
        if self.recording:
            parent = self.parent
            _local.top = parent
            _records.append(Record(self.name, self.t0, t1,
                                   threading.current_thread().name, self.batch,
                                   parent.name if parent is not None else None))
        return False


def span(name):
    """A span counted into the process totals (set-up stages)."""
    return Span(name)


def count(name, n):
    """Add n to the count of the process total `name` (a counter: its
    seconds stay 0)."""
    with _lock:
        _totals.setdefault(name, [0.0, 0])[1] += n


class Tally:
    """Seconds by stage name (every name starts at 0) and counts of one
    numbered batch.  Spans of one batch on several threads share it; a
    thread hands it on through a queue or a future, so no two write it at
    once.  A span of a name the tally does not hold is only recorded."""

    __slots__ = ("number", "seconds", "counts")

    def __init__(self, names, number):
        self.number = number
        self.seconds = dict.fromkeys(names, 0.0)
        self.counts = {}

    def span(self, name):
        return Span(name, self.seconds, self.number)


def write_chrome_trace(path):
    """The Records as a Chrome trace: one complete event a span (args: its
    batch and parent), one row a thread."""
    pid = os.getpid()
    tids, events = {}, []
    for r in records():
        tid = tids.setdefault(r.thread, len(tids) + 1)
        args = {k: v for k, v in (("batch", r.batch), ("parent", r.parent)) if v is not None}
        events.append({"name": r.name, "cat": r.name.split(".")[0], "ph": "X",
                       "ts": r.t0 * 1e6, "dur": (r.t1 - r.t0) * 1e6,
                       "pid": pid, "tid": tid, "args": args})
    for thread, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                       "args": {"name": thread}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
