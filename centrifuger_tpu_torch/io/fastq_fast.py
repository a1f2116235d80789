# Port copy of centrifuger_tpu.io.fastq_fast (host code, no accelerator).
"""Bulk FASTQ batch reader for the TSV serving fast path.

Parses strict 4-line FASTQ (plain or gzip) in large chunks, yielding
(read_ids, queries) batches where queries are (np.uint8 array, None) tuples
ready for ClassifierTorch._pack_reads — no per-read object construction.
Read-id semantics match io.readers.ReadFiles (token up to first whitespace,
trailing /1 or /2 stripped; reference ReadFiles.hpp:82-90).  CRLF line
endings are normalized (kseq strips the '\\r').

Multi-line FASTQ records (legal per kseq) are detected by the '+' separator
check; from that point on the file is parsed with a kseq-style state machine
(seq lines until '+', qual lines until len(qual) >= len(seq)) so the fast
path degrades gracefully instead of erroring.

iter_packed_batches is the native route (native/fastqpack.cpp): one C pass a
batch parses and 2-bit packs the reads.  Unlike the JAX package's, it pads no
batch to a bucket (the port compiles nothing per shape) and it has no
pure-Python fallback for a missing compiler: native.load raises.  A record
the C parser refuses still sends the rest of the file through the Python
reader, as there.
"""

import ctypes
import gzip
from io import BytesIO

import numpy as np

from ..native import load


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _rid(header):
    rid = header[1:]
    i = rid.find(b" ")
    j = rid.find(b"\t")
    if j != -1 and (i == -1 or j < i):
        i = j
    if i != -1:
        rid = rid[:i]
    if rid[-2:] in (b"/1", b"/2"):
        rid = rid[:-2]
    return rid.decode()


def _iter_lines(f, leftover, chunk_bytes):
    """Yield complete lines (no trailing newline, CRLF normalized) starting
    from `leftover` + the rest of the open file."""
    while True:
        chunk = f.read(chunk_bytes)
        if not chunk:
            break
        data = leftover + chunk
        if b"\r" in data:
            data = data.replace(b"\r\n", b"\n")
        lines = data.split(b"\n")
        leftover = lines.pop()
        for ln in lines:
            yield ln
    if leftover:
        if leftover.endswith(b"\r"):
            leftover = leftover[:-1]
        yield leftover


def _slow_records(line_iter, carry):
    """kseq-style record parser over a line stream: header '@...'; seq lines
    until a line starting with '+'; qual lines until len(qual) >= len(seq)
    (reference kseq.h record grammar).  `carry` is a list of already-read
    lines to consume first."""
    def lines():
        for ln in carry:
            yield ln
        for ln in line_iter:
            yield ln

    it = lines()
    header = None
    for ln in it:
        if ln[:1] == b"@":
            header = ln
            break
    while header is not None:
        seq_parts = []
        nxt_header = None
        for ln in it:
            if ln[:1] == b"+":
                break
            seq_parts.append(ln)
        else:
            ln = None
        seq = b"".join(seq_parts)
        qual_len = 0
        for qln in it:
            qual_len += len(qln)
            if qual_len >= len(seq):
                break
        # find the next record header
        nxt_header = None
        for ln in it:
            if ln[:1] == b"@":
                nxt_header = ln
                break
        yield header, seq
        header = nxt_header


def iter_fastq_batches(path, batch_size, chunk_bytes=1 << 24):
    """Yield (ids list[str], queries list[(uint8 ndarray, None)]) batches."""
    with _open(path) as f:
        line_iter = _iter_lines(f, b"", chunk_bytes)
        yield from _batches_from_lines(line_iter, batch_size)


def _batches_from_lines(line_iter, batch_size):
    ids, queries = [], []
    if True:
        buf = []
        slow_carry = None
        for ln in line_iter:
            buf.append(ln)
            if len(buf) < 4:
                continue
            if buf[2][:1] != b"+":
                # multi-line or malformed record: switch to the kseq-style
                # state machine for the rest of this file
                slow_carry = buf
                break
            ids.append(_rid(buf[0]))
            queries.append((np.frombuffer(buf[1], np.uint8), None))
            buf = []
            if len(ids) >= batch_size:
                yield ids, queries
                ids, queries = [], []
        if slow_carry is not None:
            for header, seq in _slow_records(line_iter, slow_carry):
                ids.append(_rid(header))
                queries.append((np.frombuffer(seq, np.uint8), None))
                if len(ids) >= batch_size:
                    yield ids, queries
                    ids, queries = [], []
        elif buf and buf[0][:1] == b"@" and len(buf) >= 2:
            # trailing record missing its quality lines (truncated file):
            # keep parity with the general reader, which still yields the seq
            ids.append(_rid(buf[0]))
            queries.append((np.frombuffer(buf[1], np.uint8), None))
    if ids:
        yield ids, queries


class LazyQueries:
    """List-like view of (read, None) pairs backed by sequence byte spans in
    the raw file buffer — the serving fast path only materializes the raw
    bytes of the rare host-fallback reads (boundary adjustment), while
    len()/iteration (for the queryLength TSV column) stay allocation-free."""

    class _Span:
        __slots__ = ("n",)

        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

    def __init__(self, buf, sq_ofs, lens):
        self._buf = buf
        self._ofs = sq_ofs
        self._lens = lens

    def __len__(self):
        return len(self._ofs)

    def __getitem__(self, i):
        o = int(self._ofs[i])
        ln = int(self._lens[i])
        return (np.frombuffer(self._buf, np.uint8, ln, o), None)

    def __iter__(self):
        for ln in self._lens:
            yield (self._Span(int(ln)), None)


def iter_packed_batches(path, batch_size, l_cap=4096, chunk_bytes=1 << 25):
    """Native route: one C pass (native/fastqpack.cpp) a batch parses strict
    4-line FASTQ and emits device-ready (pack2, vmask) arrays in the layout
    of ClassifierTorch._pack_reads: n rows (no padding), L the longest read
    rounded as there (max(maxlen, 32) up to a multiple of 64).  Yields
    (ids, queries, (pack2, vmask), lengths, nr=1) producer tuples, queries a
    LazyQueries over the file's bytes.  Any record the C parser refuses
    (multi-line, longer than l_cap, truncated) sends the rest of the file
    through the Python reader, whose batches come as (ids, queries, None,
    None, 1) for the caller to pack; the batch boundaries stay those of
    batch_size reads from the start of the file."""
    lib = _fqp_lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    with _open(path) as f:
        buf = np.frombuffer(bytearray(f.read()), np.uint8)
    bufp = buf.ctypes.data_as(u8p)
    off = 0
    while off < len(buf):
        # the C pass zero-fills every row it writes; the rest is never read
        pack2 = np.empty((batch_size, l_cap // 4), np.uint8)
        vmask = np.empty((batch_size, l_cap // 8), np.uint8)
        lengths = np.zeros(batch_size, np.int32)
        id_ofs = np.zeros(batch_size, np.int64)
        id_len = np.zeros(batch_size, np.int64)
        sq_ofs = np.zeros(batch_size, np.int64)
        consumed = ctypes.c_int64()
        maxlen = ctypes.c_int64()
        n = lib.fqp_batch(
            bufp, len(buf), off, batch_size, l_cap,
            pack2.ctypes.data_as(u8p), vmask.ctypes.data_as(u8p),
            lengths.ctypes.data_as(i32p),
            id_ofs.ctypes.data_as(i64p), id_len.ctypes.data_as(i64p),
            sq_ofs.ctypes.data_as(i64p),
            ctypes.byref(consumed), ctypes.byref(maxlen))
        if n < 0 or (n == 0 and consumed.value == 0):
            # unusual input from here on (multi-line records, overlong
            # reads, truncation): the Python reader for the remainder
            line_iter = _iter_lines(BytesIO(bytes(buf[off:])), b"", chunk_bytes)
            for ids, queries in _batches_from_lines(line_iter, batch_size):
                yield ids, queries, None, None, 1
            return
        off += consumed.value
        mv = memoryview(buf)
        ids = [str(mv[int(o):int(o) + int(ln)], "ascii")
               for o, ln in zip(id_ofs[:n], id_len[:n])]
        L = ((max(int(maxlen.value), 32) + 63) // 64) * 64
        reads = (np.ascontiguousarray(pack2[:n, :L // 4]),
                 np.ascontiguousarray(vmask[:n, :L // 8]))
        yield ids, LazyQueries(buf, sq_ofs[:n], lengths[:n]), reads, lengths[:n], 1


def _fqp_lib():
    """The fastqpack library with its prototype set (built on first use;
    raises where it cannot be built)."""
    lib = load("fastqpack")
    if not getattr(lib, "_fqp_configured", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fqp_batch.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64,
                                  u8p, u8p, i32p, i64p, i64p, i64p,
                                  i64p, i64p]
        lib.fqp_batch.restype = ctypes.c_int64
        lib._fqp_configured = True
    return lib
