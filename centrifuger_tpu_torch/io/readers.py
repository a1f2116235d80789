# Port copy of centrifuger_tpu.io.readers (host code, no accelerator).
"""FASTA/FASTQ streaming: multi-file, gzip, stdin '-', glob expansion,
interleaved pairs, sample-sheet sentinel reads.

Mirrors ReadFiles (reference ReadFiles.hpp): ids and comments split as
kseq.h splits a header, read-id '/1' '/2' suffix stripping (:82-90),
wildcard glob expansion (:139-172), interleaved mode, and the special
sentinel read injected between files for sample sheets (:195-200).
"""

import glob as _glob
import gzip
import io
import os
import sys

SAMPLE_SHEET_SEPARATOR_READ_ID = "__centrifuger_sample_sheet_separator__"


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
                for read in parse_fastx(stream):
                    yield read
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
