"""The read generator: processes of their own (no share of the program's
interpreter lock) that write the cell's reads into FIFOs, so that nothing
goes to disk and no read repeats in a window.  They run on cores of their
own (`cores`; the harness keeps the program off them).

Object route (paired or otherwise not bulk): one process, one FIFO a mate
stream, each fed by a writer thread of its own, the main thread making
blocks ahead of them (main).

Bulk route: the port's bulk reader reads a whole file before its first
batch (io/fastq_fast.py iter_packed_batches), so the sample comes as a
series of FIFOs of chunk_batches batches each, as a run over many `-u`
files does (bulk).  One process a generator core, each with one thread:
process k of P makes chunks k, k + P, k + 2P, ..., holds the next one made
while the program reads the others, and writes each into its FIFO with no
other thread to wait on.  Each chunk's (index, path) goes to the harness
on a queue before the FIFO is opened; the harness hands them to the
program in order (Chunks).

Once `stop` is set no process makes another chunk or block; what was made
goes through, and the FIFOs close.  Each process reports: reads written;
made_s, the seconds it spent making them; starved_s, the seconds in which
a writer whose FIFO the program had opened had nothing made to write
(object route); fifo_s, the seconds from the program's open of each chunk
FIFO to its close (bulk route: the most the port's reader can have waited
on the generator inside its read of that file).
"""

import os
import queue
import threading
import time

from .gen.db import Database
from .gen.reads import ReadGen

F_SETPIPE_SZ = 1031
pc = time.perf_counter


def _widen(fd):
    """The pipe's size: the largest of 16, 8, 4 and 1 MiB the kernel takes."""
    import fcntl
    for mib in (16, 8, 4, 1):
        try:
            return fcntl.fcntl(fd, F_SETPIPE_SZ, mib << 20)
        except OSError:
            pass
    return 0


class Writer:
    """Writes each queued bytes object to the FIFO `path` until None,
    keeping the seconds it waited on the queue once the reader had opened
    the FIFO (starved_s)."""

    def __init__(self, path, q):
        self.path, self.q = path, q
        self.starved_s = 0.0
        self.pipe = 0

    def __call__(self):
        with open(self.path, "wb") as f:
            self.pipe = _widen(f.fileno())
            while True:
                t0 = pc()
                data = self.q.get()
                self.starved_s += pc() - t0
                if data is None:
                    break
                f.write(data)
                f.flush()


def _start(db_dir, traffic, seed, cores):
    if cores:
        os.sched_setaffinity(0, cores)
    return ReadGen(Database.load(db_dir), traffic, seed)


def main(db_dir, traffic, seed, fifo_dir, stop, report, cores):
    """The object route's generator; its report goes to `report`."""
    gen = _start(db_dir, traffic, seed, cores)
    made = 0.0
    blocks = 0
    mates = 2 if gen.paired else 1
    qs = [queue.Queue(maxsize=2) for _ in range(mates)]
    writers = [Writer(os.path.join(fifo_dir, "r%d.fq" % (m + 1)), qs[m]) for m in range(mates)]
    threads = [threading.Thread(target=w, daemon=True) for w in writers]
    for t in threads:
        t.start()
    while not stop.is_set():
        t0 = pc()
        blk = gen.block(blocks)
        data = [blk.fastq(m + 1) for m in range(mates)]
        made += pc() - t0
        for q, d in zip(qs, data):
            q.put(d)
        blocks += 1
    for q in qs:
        q.put(None)
    for t in threads:
        t.join()
    report.send(dict(reads=blocks * gen.block_reads, made_s=made,
                     starved_s=max(w.starved_s for w in writers), fifo_s=0.0,
                     pipe_bytes=writers[0].pipe))
    report.close()


def chunk_blocks(traffic, batch_size):
    """Blocks a bulk chunk holds: chunk_batches batches' worth."""
    return max(1, int(traffic["chunk_batches"]) * batch_size // int(traffic["block_reads"]))


def bulk(db_dir, traffic, seed, fifo_dir, batch_size, stop, paths, k, nproc, cores):
    """Process k of nproc of the bulk route's generator; its report goes to
    `paths` as (None, report) after its last chunk."""
    gen = _start(db_dir, traffic, seed, cores)
    per_chunk = chunk_blocks(traffic, batch_size)
    made = fifo = 0.0
    pipe = written = 0

    def make(i):
        nonlocal made
        t0 = pc()
        data = b"".join(gen.block(b).fastq(1)
                        for b in range(i * per_chunk, (i + 1) * per_chunk))
        made += pc() - t0
        return data

    i = k
    data = make(i)
    while True:
        path = os.path.join(fifo_dir, "chunk%07d.fq" % i)
        os.mkfifo(path)
        paths.put((i, path))
        with open(path, "wb") as f:         # waits for the program to open it
            t0 = pc()
            pipe = _widen(f.fileno())
            f.write(data)
        fifo += pc() - t0
        os.unlink(path)
        written += 1
        # a process that sees `stop` after writing chunk i leaves no gap:
        # the program opened chunk i only after every chunk before it
        if stop.is_set():
            break
        i += nproc
        data = make(i)
    paths.put((None, dict(reads=written * per_chunk * gen.block_reads, made_s=made,
                          starved_s=0.0, fifo_s=fifo, pipe_bytes=pipe)))


class Chunks:
    """The bulk route's chunk FIFOs in order, from the generator processes'
    queue; ends when every process has reported and the next chunk is not
    there.  `reports` holds the processes' reports."""

    def __init__(self, q, procs):
        self.q, self.procs = q, procs
        self.got, self.want, self.reports = {}, 0, []

    def __iter__(self):
        return self

    def __next__(self):
        while self.want not in self.got:
            if len(self.reports) == len(self.procs):
                raise StopIteration
            try:
                i, item = self.q.get(timeout=5)
            except queue.Empty:
                if sum(not p.is_alive() for p in self.procs) > len(self.reports):
                    raise RuntimeError("a read generator ended without closing its stream")
                continue
            if i is None:
                self.reports.append(item)
            else:
                self.got[i] = item
        self.want += 1
        return self.got.pop(self.want - 1)

    def report(self):
        """The processes' reports as one: made_s is the longest process's,
        the others sum."""
        rs = self.reports
        return dict(reads=sum(r["reads"] for r in rs), made_s=max(r["made_s"] for r in rs),
                    starved_s=0.0, fifo_s=sum(r["fifo_s"] for r in rs),
                    pipe_bytes=rs[0]["pipe_bytes"] if rs else 0)
