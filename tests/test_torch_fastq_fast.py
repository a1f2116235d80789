"""The port's bulk FASTQ reader (io/fastq_fast.py) and native parse-and-pack
(native/fastqpack.cpp) against the JAX package's on the same files: ids and
query bytes equal centrifuger_tpu's iter_fastq_batches / iter_packed_batches
(whose arrays are padded to a bucket: their first n rows), and the native
(pack2, vmask) equal the port's own _pack_reads on the same reads."""

import gzip
import os

import numpy as np
import pytest
import torch

from centrifuger_tpu.io import fastq_fast as jax_ff
from centrifuger_tpu_torch.io import fastq_fast as ff
from centrifuger_tpu_torch.io.readers import ReadFiles
from test_torch_golden import port_index

torch.set_num_threads(1)   # the suite runs in several worker processes


def _fastq(n, lens=None):
    out = []
    for i in range(n):
        ln = 60 if lens is None else lens[i % len(lens)]
        seq = "ACGT" * (ln // 4) + "ACGT"[:ln % 4]
        out.append("@r%d some comment\n%s\n+\n%s\n" % (i, seq, "I" * ln))
    return "".join(out)


# name -> (file text, gzip?, batch size, chunk bytes)
READER_CASES = {
    "basic_batches_and_ids": (_fastq(10), False, 4, 1 << 24),
    "chunk_boundary_records": (_fastq(50, lens=[1, 7, 60, 129, 3]), False, 7, 64),
    "gzip": (_fastq(9), True, 3, 1 << 24),
    "mate_suffix_strip": ("@x/1\nACGTACGT\n+\nIIIIIIII\n@y/2 c\nTTTT\n+\nIIII\n", False, 3,
                          1 << 24),
    "crlf_stripped": ("@r0 c\r\nACGTACGTAA\r\n+\r\nIIIIIIIIII\r\n@r1\r\nTTTTT\r\n+\r\nIIIII\r\n",
                      False, 3, 1 << 24),
    "crlf_across_chunk_boundary": ("".join("@r%d\r\nACGTACGTAA\r\n+\r\nIIIIIIIIII\r\n" % i
                                           for i in range(40)), False, 6, 37),
    "multiline_fallback": ("@r0\nACGTAC\nGTACGT\n+\nIIIIII\nIIIIII\n@r1\nAAAA\n+\nIIII\n"
                           "@r2\nCC\nCC\nCC\n+ comment\nIII\nIII\n", False, 2, 1 << 24),
    "multiline_after_plain_prefix": (_fastq(8) + "@m0\nAAAA\nCCCC\n+\nIIIIIIII\n" + _fastq(3),
                                     False, 4, 1 << 24),
    "empty_id_header": ("@\nACGT\n+\nIIII\n@ onlycomment\nTTTT\n+\nIIII\n", False, 3, 1 << 24),
    "no_trailing_newline": ("@r0\nACGT\n+\nIIII\n@r1\nTTTTT\n+\nIIIII", False, 3, 1 << 24),
    "queries_are_uint8_arrays": (_fastq(3), False, 8, 1 << 24),
}


# the cases the JAX package's tests hold to its general reader as well (in
# the JAX package a header "@ comment" gives the id "" on the bulk route and
# "comment" on the object route; the port's object route gives "" as kseq.h
# does, test_object_route_ids_match_the_bulk_route)
GENERAL_READER_CASES = ("basic_batches_and_ids", "chunk_boundary_records", "gzip",
                        "mate_suffix_strip", "crlf_stripped", "no_trailing_newline")


def _write(tmp_path, name, text, gz=False):
    p = str(tmp_path / name)
    data = text.encode() if isinstance(text, str) else text
    with (gzip.open if gz else open)(p, "wb") as f:
        f.write(data)
    return p


def _batches(module, path, bs, chunk):
    return [(ids, [bytes(q[0]) for q in queries], [type(q[0]) for q in queries],
             [q[1] for q in queries])
            for ids, queries in module.iter_fastq_batches(path, bs, chunk_bytes=chunk)]


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_bulk_reader_matches_jax(tmp_path, case):
    text, gz, bs, chunk = READER_CASES[case]
    p = _write(tmp_path, "r.fq.gz" if gz else "r.fq", text, gz)
    got = _batches(ff, p, bs, chunk)
    assert got == _batches(jax_ff, p, bs, chunk)
    assert all(t is np.ndarray for _, _, types, _ in got for t in types)
    assert all(m is None for _, _, _, mates in got for m in mates)
    assert all(len(ids) == bs for ids, _, _, _ in got[:-1])
    if case in GENERAL_READER_CASES:   # the general reader: the same ids and reads
        rf = ReadFiles()
        rf.add_read_file(p)
        assert [(r.id, r.seq.encode()) for r in rf] == \
            [(i, s) for ids, seqs, _, _ in got for i, s in zip(ids, seqs)]


def _object_route(path):
    rf = ReadFiles()
    rf.add_read_file(path)
    return [(r.id, r.comment, r.seq.encode()) for r in rf]


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_object_route_ids_match_the_bulk_route(tmp_path, case):
    """ReadFiles (the object route) gives the bulk route's ids and reads on
    every reader case."""
    text, gz, bs, chunk = READER_CASES[case]
    p = _write(tmp_path, "r.fq.gz" if gz else "r.fq", text, gz)
    got = [(rid, seq) for rid, _, seq in _object_route(p)]
    assert got == [(i, s) for ids, seqs, _, _ in _batches(ff, p, bs, chunk)
                   for i, s in zip(ids, seqs)]


def test_object_route_reads_an_empty_id_as_kseq(tmp_path):
    """A header "@ onlycomment": kseq.h's name is the bytes up to the first
    space, "", and its comment the rest of the line. The port's object route
    gives that and the bulk route's id; the JAX package's object route gives
    the id "onlycomment" and no comment."""
    from centrifuger_tpu.io.readers import ReadFiles as JaxReadFiles
    text, _, bs, chunk = READER_CASES["empty_id_header"]
    p = _write(tmp_path, "r.fq", text)
    assert _object_route(p) == [("", None, b"ACGT"), ("", "onlycomment", b"TTTT")]
    assert [i for ids, _, _, _ in _batches(ff, p, bs, chunk) for i in ids] == ["", ""]
    jrf = JaxReadFiles()
    jrf.add_read_file(p)
    assert [(r.id, r.comment) for r in jrf] == [("", None), ("onlycomment", None)]


@pytest.mark.parametrize("header,rid,comment", [
    ("@r0 some comment", "r0", "some comment"),
    ("@r1/1", "r1", None),
    ("@r2/2\tbc:ACGT extra", "r2", "bc:ACGT extra"),
    ("@r3  two spaces", "r3", " two spaces"),
    ("@r4 ", "r4", ""),
    ("@\tlead tab", "", "lead tab"),
])
def test_object_route_header_split(tmp_path, header, rid, comment):
    """kseq.h's split: the name up to the first space or tab, the '/1' '/2'
    strip on the name, the comment after that one separator."""
    p = _write(tmp_path, "r.fq", "%s\nACGT\n+\nIIII\n>f%s\nAC\nGT\n" % (header, header[1:]))
    fq, fa = _object_route(p)
    assert (fq[0], fq[1]) == (rid, comment)
    assert (fa[0], fa[1], fa[2]) == ("f" + rid, comment, b"ACGT")


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """The port's engine on the CPU (its _pack_reads and iter_prepacked)."""
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    fm, tax, _, _ = load_index(port_index("tiny", tmp_path_factory))
    return ClassifierTorch(fm, tax, ClassifierParam(), device="cpu")


def _mk_fastq(tmp, records, trailing_nl=True, crlf=False, gz=False):
    out = []
    for rid, seq in records:
        out += ["@" + rid, seq, "+", "I" * len(seq)]
    data = "\n".join(out) + ("\n" if trailing_nl else "")
    if crlf:
        data = data.replace("\n", "\r\n")
    return _write(tmp, "r.fq.gz" if gz else "r.fq", data, gz)


RECORDS = [
    ("r0 extra words", "ACGTACGTACGTACGTNNACGT"),
    ("r1/1", "acgtacgtACGTACGT"),
    ("r2\textra", "TTTTGGGGCCCCAAAA" * 3),
    ("r3", "A"),
    ("r4", "ACGTXACGTRYACGT"),
]


def check_packed(engine, path, bs):
    """The port's native batches against the JAX package's (first n rows) and
    against the port's Python reader + _pack_reads; returns the port's
    iter_prepacked batches."""
    got = list(ff.iter_packed_batches(path, bs))
    want = list(jax_ff.iter_packed_batches(path, bs))
    ref = [(ids, engine._pack_reads(queries)) for ids, queries in
           ff.iter_fastq_batches(path, bs)]
    prepacked = list(engine.iter_prepacked(path, bs))
    assert len(got) == len(want) == len(ref) == len(prepacked)
    for g, w, (rids, ((p2, vm), lens, nr, _)), pp in zip(got, want, ref, prepacked):
        ids, queries, reads, lengths, g_nr = g
        n = len(ids)
        assert ids == w[0] == rids == pp[0]
        assert g_nr == nr == pp[4] == 1
        for i in range(n):
            assert bytes(queries[i][0]) == bytes(w[1][i][0]) and queries[i][1] is None
        assert [len(q[0]) for q in queries] == lens.tolist()
        if reads is None:      # a batch the C parser refused: the caller packs it
            assert w[2] is None
            reads, lengths = pp[2], pp[3]
        else:
            assert w[2][0].shape[1] == reads[0].shape[1]   # the same L rounding
            assert np.array_equal(reads[0], w[2][0][:n])
            assert np.array_equal(reads[1], w[2][1][:n])
            assert reads[0].flags.c_contiguous and reads[0].shape[0] == n
        assert np.array_equal(reads[0], p2) and np.array_equal(reads[1], vm)
        assert np.array_equal(lengths, lens)
        assert all(np.array_equal(a, b) for a, b in zip(pp[2], (p2, vm)))
    return prepacked


@pytest.mark.parametrize("crlf", [False, True])
@pytest.mark.parametrize("trailing_nl", [True, False])
def test_native_pack_parity(engine, tmp_path, crlf, trailing_nl):
    path = _mk_fastq(tmp_path, RECORDS, trailing_nl=trailing_nl, crlf=crlf)
    [(ids, _, _, _, _)] = check_packed(engine, path, 8)
    assert ids == ["r0", "r1", "r2", "r3", "r4"]


def test_native_pack_gzip_and_batching(engine, tmp_path):
    recs = [("q%03d" % i, "ACGT" * (5 + i % 7)) for i in range(11)]
    got = check_packed(engine, _mk_fastq(tmp_path, recs, gz=True), 4)
    assert [len(g[0]) for g in got] == [4, 4, 3]
    assert got[0][0] == ["q000", "q001", "q002", "q003"]
    assert got[2][2][0].shape[0] == 3      # no padding to a bucket


def test_native_pack_multiline_fallback(engine, tmp_path):
    p = _write(tmp_path, "m.fq", "@a\nACGTACGT\nACGT\n+\nIIIIIIII\nIIII\n"
                                 "@b\nTTTT\n+\nIIII\n")
    got = check_packed(engine, p, 4)
    assert [i for g in got for i in g[0]] == ["a", "b"]
    assert [len(q[0]) for g in got for q in g[1]] == [12, 4]


def test_native_pack_overlong_read_keeps_batch_boundaries(engine, tmp_path):
    """A read over the C parser's 4,096 codes sends the rest of the file
    through the Python reader from the start of its batch: the batches stay
    batch_size reads from the start of the file (what --n-ranks stripes)."""
    recs = [("s%d" % i, "ACGT" * 25) for i in range(10)]
    recs[6] = ("long", "ACGTTGCA" * 700)
    got = check_packed(engine, _mk_fastq(tmp_path, recs), 4)
    assert [g[0] for g in got] == [["s0", "s1", "s2", "s3"], ["s4", "s5", "long", "s7"],
                                   ["s8", "s9"]]
    assert got[0][2][0].shape == (4, 32) and got[1][2][0].shape == (4, 5632 // 4)


def test_prepacked_route_refuses_a_protein_index(engine):
    engine.protein = True
    try:
        with pytest.raises(ValueError, match="nucleotide"):
            next(engine.iter_prepacked(os.devnull, 4))
    finally:
        engine.protein = False
