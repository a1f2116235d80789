# Port copy of centrifuger_tpu.io.readers (host code, no accelerator).
"""FASTA/FASTQ streaming: multi-file, gzip, stdin '-', glob expansion,
interleaved pairs, sample-sheet sentinel reads.

Mirrors ReadFiles (reference ReadFiles.hpp): ids and comments split as
kseq.h splits a header, read-id '/1' '/2' suffix stripping (:82-90),
wildcard glob expansion (:139-172), interleaved mode, and the special
sentinel read injected between files for sample sheets (:195-200).

ReadFiles reads each file in chunks of CHUNK_BYTES, one read of the source
at a time, and splits a chunk's strict 4-line FASTQ records in one native
call (native/fastqpack.cpp fqp_records, which runs without the interpreter
lock); Python then only cuts each Read's fields from the chunk's text.
From the first record the native pass refuses (FASTA, multi-line records,
whitespace the line parser would strip, non-ASCII bytes) or an unfinished
one at the end of the file, parse_fastx reads the rest of that file, and
where the library cannot be built it reads every file: both give the same
Reads.  The process counters io.native_reads and io.line_reads (spans.py)
count the reads each gave.
"""

import ctypes
import glob as _glob
import gzip
import io
import os
import subprocess
import sys

import numpy as np

from .. import spans
from ..native import load

SAMPLE_SHEET_SEPARATOR_READ_ID = "__centrifuger_sample_sheet_separator__"

CHUNK_BYTES = 1 << 18    # a read of the source asks for this, or for an unfinished record's length


class Read:
    __slots__ = ("id", "comment", "seq", "qual")

    def __init__(self, rid=None, comment=None, seq=None, qual=None):
        self.id = rid
        self.comment = comment
        self.seq = seq
        self.qual = qual


def _open_any(path):
    if path == "-":
        return io.BufferedReader(sys.stdin.buffer)
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else b""
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


def _strip_pair_suffix(rid):
    if len(rid) >= 2 and rid[-2] == "/" and rid[-1] in "12":
        return rid[:-2]
    return rid


def _split_header(line):
    """kseq.h's name and comment of a header line without its '@' or '>':
    the name is the bytes up to the first space or tab (so a line that starts
    with one has the name ""), the comment the rest of the line after that one
    separator (None where there is no separator)."""
    header = line.decode()
    cut = min((i for i in (header.find(" "), header.find("\t")) if i >= 0),
              default=len(header))
    comment = header[cut + 1:] if cut < len(header) else None
    return _strip_pair_suffix(header[:cut]), comment


def parse_fastx(stream):
    """Yield Read objects from a FASTA or FASTQ byte stream."""
    line = stream.readline()
    while line:
        line = line.rstrip(b"\n").rstrip(b"\r")
        if not line:
            line = stream.readline()
            continue
        if line.startswith(b"@"):  # fastq (sequence/quality may span lines, kseq.h)
            rid, comment = _split_header(line[1:])
            chunks = []
            line = stream.readline()
            while line and not line.startswith(b"+"):
                chunks.append(line.strip().decode())
                line = stream.readline()
            seq = "".join(chunks)
            qchunks = []
            qlen = 0
            while qlen < len(seq):   # quality: read until it covers the sequence
                line = stream.readline()
                if not line:
                    break
                s = line.rstrip(b"\n").rstrip(b"\r").decode()
                qchunks.append(s)
                qlen += len(s)
            qual = "".join(qchunks)
            yield Read(rid, comment, seq, qual)
            line = stream.readline()
        elif line.startswith(b">"):  # fasta (possibly multi-line)
            rid, comment = _split_header(line[1:])
            chunks = []
            line = stream.readline()
            while line and not line.startswith(b">") and not line.startswith(b"@"):
                chunks.append(line.strip().decode())
                line = stream.readline()
            yield Read(rid, comment, "".join(chunks), None)
        else:
            line = stream.readline()


def _line_reads(stream):
    """parse_fastx's Reads, counted into io.line_reads when it ends."""
    n = 0
    try:
        for read in parse_fastx(stream):
            n += 1
            yield read
    finally:
        spans.count("io.line_reads", n)


class _Chain:
    """readline over `head` and then the rest of `stream`."""

    def __init__(self, head, stream):
        self._head = io.BytesIO(head)
        self._stream = stream

    def readline(self):
        line = self._head.readline()
        if not line.endswith(b"\n"):
            line += self._stream.readline()
        return line


def _fqp_records():
    """The native splitter with its prototype, or None where the library
    cannot be built (then parse_fastx reads every file)."""
    try:
        fn = load("fastqpack").fqp_records
    except (OSError, subprocess.SubprocessError):
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   i64p, i64p]
    fn.restype = ctypes.c_int64
    return fn


def _one_read(stream):
    """A read1 that makes one read of the file's source: _open_any wraps
    gzip and stdin, whose own readinto waits for a full buffer, in a
    BufferedReader nothing has read through, so read from what it wraps."""
    inner = getattr(stream, "raw", None)
    return inner.read1 if hasattr(inner, "read1") else stream.read1


def _chunk_reads(buf, bounds):
    """The Reads whose fields fqp_records found in buf, 8 offsets a record."""
    text = buf.decode("latin-1")   # the records found are ASCII
    it = iter(bounds)
    return [Read(text[i0:i1], None if c0 < 0 else text[c0:c1], text[s0:s1], text[q0:q1])
            for i0, i1, c0, c1, s0, s1, q0, q1 in zip(it, it, it, it, it, it, it, it)]


def _reads(stream):
    """The Reads of one open file: the native pass, then parse_fastx from
    the first record it refuses or an unfinished one at the end."""
    fqp = _fqp_records()
    if fqp is None:
        yield from _line_reads(stream)
        return
    read1 = _one_read(stream)
    consumed, refused = ctypes.c_int64(), ctypes.c_int64()
    bounds = np.empty(0, np.int64)
    tail = b""
    while True:
        data = read1(max(CHUNK_BYTES, len(tail)))
        if not data:
            break
        buf = tail + data if tail else data
        cap = len(buf) // 8 + 1        # a record takes 8 bytes or more
        if len(bounds) < 8 * cap:
            bounds = np.empty(8 * cap, np.int64)
        n = fqp(buf, len(buf), cap, bounds.ctypes.data, ctypes.byref(consumed),
                ctypes.byref(refused))
        tail = buf[consumed.value:]
        if n:
            spans.count("io.native_reads", n)
            reads = _chunk_reads(buf, bounds[:8 * n].tolist())
            data = buf = None      # the chunk's bytes are not held while its reads are taken
            yield from reads
        if refused.value:
            break
    if tail:
        yield from _line_reads(_Chain(tail, stream))


class ReadFiles:
    """Multi-file read streamer with optional end-of-file sentinel injection."""

    def __init__(self):
        self.file_names = []
        self._gen = None
        self._current_file = -1
        self.special_read_id = None
        self.interleaved = False

    def add_read_file(self, path, interleaved=False):
        matched = sorted(_glob.glob(path)) if any(ch in path for ch in "*?[") else [path]
        if not matched:
            matched = [path]
        for m in matched:
            self.file_names.append(m)
        self.interleaved = self.interleaved or interleaved

    def set_special_read_to_mark_file_end(self, rid):
        self.special_read_id = rid

    @property
    def file_count(self):
        return len(self.file_names)

    def __iter__(self):
        for fi, fn in enumerate(self.file_names):
            self._current_file = fi
            with _open_any(fn) as stream:
                yield from _reads(stream)
            if self.special_read_id is not None:
                yield Read(self.special_read_id, None, "A", None)

    def batches(self, batch_size):
        """Yield lists of Read (or (r1, r2) pairs when interleaved)."""
        batch = []
        if self.interleaved:
            it = iter(self)
            while True:
                try:
                    r1 = next(it)
                except StopIteration:
                    break
                if self.special_read_id is not None and r1.id == self.special_read_id:
                    pair = (r1, Read(self.special_read_id, None, "A", None))
                else:
                    try:
                        r2 = next(it)
                    except StopIteration:
                        r2 = Read(r1.id, None, "", None)
                    pair = (r1, r2)
                batch.append(pair)
                if len(batch) >= batch_size:
                    yield batch
                    batch = []
        else:
            for read in self:
                batch.append(read)
                if len(batch) >= batch_size:
                    yield batch
                    batch = []
        if batch:
            yield batch
