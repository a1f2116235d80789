"""ReadFiles' native pass (native/fastqpack.cpp fqp_records, io/readers.py)
held to the port's line parser (parse_fastx) on the same bytes: every
record's (id, comment, seq, qual), and which parser gave each read, from
the counters io.native_reads and io.line_reads (spans.py).  A file's
native reads come first, so the two counts place every read."""

import gzip
import io
import os
import sys
import threading

import pytest

from centrifuger_tpu_torch import spans
from centrifuger_tpu_torch.io import readers
from centrifuger_tpu_torch.io.readers import (ReadFiles, SAMPLE_SHEET_SEPARATOR_READ_ID,
                                              _open_any, parse_fastx)
from test_torch_fastq_fast import READER_CASES

# READER_CASES name -> the reads the native pass gives (the rest: the line parser)
READER_CASES_NATIVE = {
    "basic_batches_and_ids": 10, "chunk_boundary_records": 50, "gzip": 9,
    "mate_suffix_strip": 2, "crlf_stripped": 2, "crlf_across_chunk_boundary": 40,
    "multiline_fallback": 0, "multiline_after_plain_prefix": 8, "empty_id_header": 2,
    "no_trailing_newline": 1, "queries_are_uint8_arrays": 3,
}

R = "@a x\nACGT\n+\nIIII\n"          # a plain record
# name -> (file bytes, the reads the native pass gives)
CASES = {
    # a quality line as long as the sequence line with its whitespace
    "seq_leading_space": (R + "@b\n ACGT\n+\nIIIII\n" + R, 1),
    "seq_trailing_space": (R + "@b\nACGT \n+\nIIIII\n" + R, 1),
    "seq_trailing_tab_before_cr": (R + "@b\nACGT\t\r\n+\nIIIII\n" + R, 1),
    "seq_two_crs": (R + "@b\nACGT\r\r\n+\nIIIII\n" + R, 1),
    "seq_trailing_vt": (R + "@b\nACGT\x0b\n+\nIIIII\n" + R, 1),
    "seq_leading_ff": (R + "@b\n\x0cACGT\n+\nIIIII\n" + R, 1),
    "blank_lines_between_records": (R + "\n\r\n\n" + R + "\r\r\n" + R, 3),
    "leading_blank_lines": ("\n\r\n" + R + R, 2),
    "trailing_blank_lines": (R + R + "\n\n", 2),
    "qual_starts_with_at": (R + "@b\nACGT\n+\n@III\n" + R, 3),
    "qual_longer": (R + "@b\nACGT\n+\nIIIII\n" + R, 1),
    "qual_shorter": (R + "@b\nACGT\n+\nII\nII\n" + R, 1),
    "empty_sequence": (R + "@b\n\n+\n\n" + R, 1),
    "seq_starts_with_plus": (R + "@b\n+CGT\n+\nIIII\n" + R, 1),
    "third_line_not_plus": (R + "@b\nACGT\n-\nIIII\n" + R, 1),
    # UTF-8 bytes (the files are written as latin-1 text)
    "non_ascii_header": ("@r\xc3\xa9 c\xc3\xa9\nACGT\n+\nIIII\n" + R, 0),
    "non_ascii_header_later": (R + "@r\xc3\xa9 c\xc3\xa9\nACGT\n+\nIIII\n" + R, 1),
    "non_ascii_sequence": (R + "@b\nAC\xc3\xa9\n+\nIII\n" + R, 1),
    "non_ascii_quality": (R + "@b\nACGT\n+\nII\xc3\xa9\n" + R, 1),
    "headers_tabs_and_double_spaces": ("@r0\tc1  c2\nACGT\n+\nIIII\n@r1  c\tt\nAC\n+\nII\n"
                                       "@r2/2\t\tx\nA\n+\nI\n@\t\nC\n+\nI\n@r3/1 \nG\n+\nI\n", 5),
    "cr_on_some_lines": ("@a\r\nACGT\n+\r\nIIII\r\n@b c\r\r\nAC\r\n+\nII\n@c\nGG\n+ x\r\nII\r\r\n", 3),
    "cr_inside_header": ("@a\rb c\rd\nACGT\n+\nIIII\n" + R, 2),
    "no_trailing_newline": (R + "@b\nAC\n+\nII", 1),
    "truncated_in_quality_line": (R + R + "@b\nACGT\n+\nII", 2),
    "truncated_after_plus": (R + "@b\nACGT\n+\n", 1),
    "truncated_in_sequence": (R + "@b\nAC", 1),
    "truncated_header": (R + "@b x", 1),
    "fasta": (">a x\nACGT\nAC\n>b\nGG\n", 0),
    "fastq_then_fasta": (R + R + ">b y\nACGT\nGG\n>c\nT\n", 2),
    "stray_line_first": ("junk\n" + R + R, 0),
    "pair_suffixes": ("@r/1\nA\n+\nI\n@r/2 c\nA\n+\nI\n@r/3\nA\n+\nI\n@/1\nA\n+\nI\n@1\nA\n+\nI\n", 5),
    "long_read": ("@long\n%s\n+\n%s\n" % ("ACGT" * 5000, "I" * 20000) + R, 2),
}


def _write(tmp_path, text, name="r.fq", gz=False):
    p = str(tmp_path / name)
    data = text.encode("latin-1") if isinstance(text, str) else text
    with (gzip.open if gz else open)(p, "wb") as f:
        f.write(data)
    return p


def _fields(reads):
    return [(r.id, r.comment, r.seq, r.qual) for r in reads]


def _line_parser(path):
    with _open_any(path) as stream:
        return _fields(parse_fastx(stream))


def _counts():
    t = spans.totals()
    return tuple(t.get(k, (0.0, 0))[1] for k in ("io.native_reads", "io.line_reads"))


def _read_files(paths, special=None):
    """ReadFiles' reads over `paths`, and the (native, line) reads it counted."""
    rf = ReadFiles()
    for p in paths:
        rf.add_read_file(p)
    if special is not None:
        rf.set_special_read_to_mark_file_end(special)
    c0 = _counts()
    got = _fields(rf)
    c1 = _counts()
    return got, (c1[0] - c0[0], c1[1] - c0[1])


def _check(path, n_native):
    want = _line_parser(path)
    got, counted = _read_files([path])
    assert got == want
    assert counted == (n_native, len(want) - n_native)


@pytest.mark.parametrize("chunk", [3, 1 << 20])
@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_cases_match_the_line_parser(tmp_path, monkeypatch, case, chunk):
    text, gz, _, _ = READER_CASES[case]
    monkeypatch.setattr(readers, "CHUNK_BYTES", chunk)
    _check(_write(tmp_path, text, "r.fq.gz" if gz else "r.fq", gz), READER_CASES_NATIVE[case])


@pytest.mark.parametrize("chunk", [5, 1 << 20])
@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_cases_match_the_line_parser(tmp_path, monkeypatch, case, chunk):
    text, n_native = CASES[case]
    monkeypatch.setattr(readers, "CHUNK_BYTES", chunk)
    _check(_write(tmp_path, text), n_native)


# a small file with most of what the native pass handles, and a refusal at the end
SMALL = ("@r0 c d\r\nACGTA\r\n+\r\nIIIII\r\n\n@r1/1\tx\nAC\n+ r1\nI@\n"
         "@r2\nGATTACA\n+\nIIIIIII\n@r3/2\nT\n+\nI\n@m\nAC\nGT\n+\nIIII\n")


@pytest.mark.parametrize("chunk", range(1, 65))
def test_every_chunk_boundary(tmp_path, monkeypatch, chunk):
    monkeypatch.setattr(readers, "CHUNK_BYTES", chunk)
    _check(_write(tmp_path, SMALL), 4)


def test_invalid_utf8_raises_as_the_line_parser_does(tmp_path):
    """A header that is not UTF-8: both raise, after the same reads."""
    path = _write(tmp_path, R + R + "@r\xe9\nACGT\n+\nIIII\n" + R)
    with pytest.raises(UnicodeDecodeError):
        _line_parser(path)
    rf = ReadFiles()
    rf.add_read_file(path)
    got = []
    with pytest.raises(UnicodeDecodeError):
        for r in rf:
            got.append(r)
    assert _fields(got) == [("a", "x", "ACGT", "IIII")] * 2


def test_gzip_and_sample_sheet_sentinel_across_two_files(tmp_path, monkeypatch):
    monkeypatch.setattr(readers, "CHUNK_BYTES", 16)
    a = _write(tmp_path, SMALL, "a.fq.gz", gz=True)
    b = _write(tmp_path, R + ">f\nAC\n", "b.fq")
    got, counted = _read_files([a, b], special=SAMPLE_SHEET_SEPARATOR_READ_ID)
    mark = [(SAMPLE_SHEET_SEPARATOR_READ_ID, None, "A", None)]
    assert got == _line_parser(a) + mark + _line_parser(b) + mark
    assert counted == (4 + 1, 1 + 1)


@pytest.mark.parametrize("source", ["bytes", "pipe"])
def test_stdin(monkeypatch, source):
    """'-' reads standard input: from bytes, and from a pipe whose writer
    keeps it open (the reader takes the records it holds and waits for no
    full chunk)."""
    data = (SMALL + R).encode()
    if source == "bytes":
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
        got, counted = _read_files(["-"])
        assert got == _fields(parse_fastx(io.BytesIO(data)))
        assert counted == (4, 2)
        return
    rfd, wfd = os.pipe()
    os.write(wfd, (R * 10).encode())
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BufferedReader(io.FileIO(rfd, "r"))))
    rf = ReadFiles()
    rf.add_read_file("-")
    it = iter(rf)
    first, done = [], threading.Event()

    def take():
        first.extend(next(it) for _ in range(10))
        done.set()
    t = threading.Thread(target=take, daemon=True)
    t.start()
    ok = done.wait(30)
    os.close(wfd)
    t.join(30)
    assert ok, "the reader waited for more than the pipe held"
    assert _fields(first) == [("a", "x", "ACGT", "IIII")] * 10
    assert list(it) == []


def test_fifo_yields_what_the_writer_wrote(tmp_path):
    """A FIFO whose writer writes 10 records and then waits: ReadFiles gives
    the 10 reads before the writer goes on (a reader that waited for a full
    chunk would hang here)."""
    path = str(tmp_path / "r.fq")
    os.mkfifo(path)
    go_on = threading.Event()

    def writer():
        with open(path, "wb") as f:
            f.write(("@w%d c\nACGTN\n+\nIIIII\n" % 0).encode())
            f.write("".join("@w%d c\nACGTN\n+\nIIIII\n" % i for i in range(1, 10)).encode())
            f.flush()
            go_on.wait(60)
            f.write(b"@last\nA\n+\nI\n")
    w = threading.Thread(target=writer, daemon=True)
    w.start()
    rf = ReadFiles()
    rf.add_read_file(path)
    it = iter(rf)
    first, done = [], threading.Event()

    def take():
        first.extend(next(it) for _ in range(10))
        done.set()
    t = threading.Thread(target=take, daemon=True)
    t.start()
    ok = done.wait(30)
    go_on.set()
    t.join(30)
    w.join(30)
    assert ok, "the reader waited for more than the FIFO held"
    assert _fields(first) == [("w%d" % i, "c", "ACGTN", "IIIII") for i in range(10)]
    assert _fields(it) == [("last", None, "A", "I")]


def test_counters_generator_reads_native_and_multiline_reads_by_line(tmp_path):
    """The benchmark generator's FASTQ (cfr_bench/gen) is all native pass; a
    file of multi-line records all line parser."""
    from cfr_bench.gen.db import Database
    from cfr_bench.gen.reads import ReadGen
    from cfr_bench.spec import load_json
    from cfr_bench.tests.tiny import BENCH, TINY_NT
    cfg = dict(load_json(os.path.join(BENCH, "configs", "nt256-plain.json")), **TINY_NT)
    gen = ReadGen(Database.make(cfg, cfg["db_seed"]),
                  load_json(os.path.join(BENCH, "traffic", "pe150.json")), 2 ** 31 + 5)
    blocks = [gen.block(b) for b in range(3)]
    n = sum(blk.n for blk in blocks)
    for m in (1, 2):
        path = _write(tmp_path, b"".join(blk.fastq(m) for blk in blocks), "m%d.fq" % m)
        got, counted = _read_files([path])
        assert got == _line_parser(path) and len(got) == n
        assert counted == (n, 0)
    multi = "".join("@m%d\nACGTAC\nGTAC\n+\nIIIIII\nIIII\n" % i for i in range(7))
    got, counted = _read_files([_write(tmp_path, multi, "multi.fq")])
    assert [r[2] for r in got] == ["ACGTACGTAC"] * 7
    assert counted == (0, 7)


def test_without_the_library_every_read_is_a_line_read(tmp_path, monkeypatch):
    """Where the native library cannot be built, parse_fastx reads every
    file and its reads are counted as line reads."""
    def no_compiler(name):
        raise FileNotFoundError("g++")
    monkeypatch.setattr(readers, "load", no_compiler)
    path = _write(tmp_path, SMALL)
    got, counted = _read_files([path])
    assert got == _line_parser(path)
    assert counted == (0, len(got))
