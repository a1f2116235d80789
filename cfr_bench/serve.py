"""A frozen copy of cfr-classify-torch's serving loop (the port's
cli/classify_cli.py: main's default-column object route and _serve_bulk),
with the harness's spans around each call into a layer.

The CLI writes its two routes inline, so the window cannot drive them
through a callable and still stop at a deadline: this copy calls the
port's public pieces only (ReadFiles, ClassifierTorch.iter_prepacked,
query_pipelined_packed, format_tsv_batch, serve_tsv_prepacked, the bulk
route's iter_fastq_batches), in the CLI's order, with its queue depths.
A change to the CLI's loop itself is not measured until that loop is a
callable the benchmark can drive.

Spans (Spans.serving, on the serving thread): "engine" around each next()
on the engine's generator, "wait" around each get on the read queue
(inside an engine span), "batch_queries" around the CLI's conversion of
Read objects into engine queries (inside an engine span), "format" around
format_tsv_batch and the write (object route), "write" around the write
(bulk route).  The producer thread adds its time inside the port's
reader to Spans.parse_s when Spans.per_read is on, and its waits for the
next input file to Spans.feed_s.
"""

import queue
import threading
import time
from collections import deque

import numpy as np

pc = time.perf_counter


class Spans:
    def __init__(self, per_read):
        self.per_read = per_read
        self.serving = []          # (name, t0, t1) on the serving thread
        self.parse_s = 0.0
        self.parsed = 0            # reads the producer took from the reader
        self.feed_s = 0.0          # the producer's waits for the next input file

    def feed(self, paths):
        """The input files, each next() timed into feed_s."""
        while True:
            t0 = pc()
            path = next(paths, None)
            self.feed_s += pc() - t0
            if path is None:
                return
            yield path

    def add(self, name, t0):
        t1 = pc()
        self.serving.append((name, t0, t1))
        return t1

    def timed(self, it):
        """The reader's items, each next() timed into parse_s."""
        it = iter(it)
        while True:
            t0 = pc()
            try:
                item = next(it)
            except StopIteration:
                self.parse_s += pc() - t0
                return
            self.parse_s += pc() - t0
            yield item


class TsvOut:
    """The CLI's _write_lines over a file: the reads written."""

    def __init__(self, fp):
        self.fp = fp
        self.reads = 0

    def write(self, lines, n_reads):
        if lines:
            self.fp.write("\n".join(lines) + "\n")
        self.reads += n_reads


def batch_queries(batch):
    """The CLI's _batch_queries (no read-pair merger: default flags)."""
    queries = []
    for r1, r2, *_ in batch:
        raw1 = np.frombuffer(r1.seq.encode(), dtype=np.uint8)
        raw2 = np.frombuffer(r2.seq.encode(), dtype=np.uint8) if r2 is not None else None
        queries.append((raw1, raw2))
    return queries


def serve_object(classifier, read_files, mate_files, batch_size, out, spans, failed):
    """main's default-column route: a reader thread batches ReadFiles units,
    the serving thread dispatches and formats."""
    batch_q = queue.Queue(maxsize=2)

    def iter_units():
        """The CLI's iter_units with no barcode or UMI file."""
        it1 = iter(read_files)
        it2 = iter(mate_files) if mate_files is not None else None
        if spans.per_read:
            it1 = spans.timed(it1)
            it2 = spans.timed(it2) if it2 is not None else None
        for r1 in it1:
            yield r1, next(it2) if it2 is not None else None, None, None

    def formatted_units():
        """The CLI's formatted_units with the default flags: no sample
        sheet, read format, barcode or UMI."""
        for r1, r2, rb, ru in iter_units():
            yield r1, r2, None, None

    def producer():
        try:
            batch = []
            for unit in formatted_units():
                batch.append(unit)
                if len(batch) >= batch_size:
                    spans.parsed += len(batch)
                    batch_q.put(batch)
                    batch = []
            if batch:
                spans.parsed += len(batch)
                batch_q.put(batch)
        except Exception as e:      # a reader fault ends the window, reported
            failed.append(e)
        batch_q.put(None)

    pending = deque()

    def batches():
        while True:
            t0 = pc()
            b = batch_q.get()
            t1 = spans.add("wait", t0)
            if b is None:
                return
            pending.append(b)
            q = batch_queries(b)
            spans.add("batch_queries", t1)
            yield q

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    gen = classifier.query_pipelined_packed(batches())
    while True:
        t0 = pc()
        try:
            packed, fb, queries = next(gen)
        except StopIteration:
            spans.add("engine", t0)
            break
        t1 = spans.add("engine", t0)
        batch = pending.popleft()
        lines, _ = classifier.format_tsv_batch(packed, fb, queries,
                                                  [u[0].id for u in batch])
        out.write(lines, len(batch))
        spans.add("format", t1)
    t.join()


def serve_bulk(classifier, paths, batch_size, out, spans, failed):
    """_serve_bulk: a producer thread parses (and on a nucleotide index
    packs) batch_size reads at a time, file by file; the serving thread
    dispatches and writes.  `paths` yields the input files."""
    from centrifuger_tpu_torch.io.fastq_fast import iter_fastq_batches
    prepacked = not classifier.protein
    bq = queue.Queue(maxsize=4)

    def producer():
        try:
            for path in paths:
                it = classifier.iter_prepacked(path, batch_size) if prepacked \
                    else iter_fastq_batches(path, batch_size)
                if spans.per_read:
                    it = spans.timed(it)
                for item in it:
                    spans.parsed += len(item[0])
                    bq.put(item)
        except Exception as e:
            failed.append(e)
        bq.put(None)

    def items():
        while True:
            t0 = pc()
            item = bq.get()
            spans.add("wait", t0)
            if item is None:
                return
            yield item

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    if prepacked:
        gen = classifier.serve_tsv_prepacked(items())
        while True:
            t0 = pc()
            try:
                lines, _, nq = next(gen)
            except StopIteration:
                spans.add("engine", t0)
                break
            t1 = spans.add("engine", t0)
            out.write(lines, nq)
            spans.add("write", t1)
    else:
        ids = deque()

        def batches():
            for rids, queries in items():
                ids.append(rids)
                yield queries
        gen = classifier.query_pipelined_packed(batches())
        while True:
            t0 = pc()
            try:
                packed, fb, queries = next(gen)
            except StopIteration:
                spans.add("engine", t0)
                break
            t1 = spans.add("engine", t0)
            lines, _ = classifier.format_tsv_batch(packed, fb, queries, ids.popleft())
            out.write(lines, len(queries))
            spans.add("format", t1)
    t.join()
