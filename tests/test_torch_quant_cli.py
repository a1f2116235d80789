"""The port's downstream CLIs against the JAX package's and the goldens:
the quantifier (quant/quantifier.py, quant/tree.py, native/tsvquant.cpp) and
cfr-quant-torch, cfr-kreport-torch, cfr-promote-torch and cfr-inspect-torch,
byte for byte on the same inputs."""

import contextlib
import gzip
import io
import os
import sys

import pytest

from conftest import FIXTURE_DIR
from test_golden_classify import get_index
from test_torch_build_chunked import jax_native
from test_torch_golden import port_index

PROTEIN = "tiny_protein"
QUANT_FIXTURES = ["tiny", "small", "tiny_single", PROTEIN]
_PROTEIN_IDX = {}


@pytest.fixture(scope="module", autouse=True)
def _jax_tsvquant(tmp_path_factory):
    jax_native("tsvquant", tmp_path_factory)


def index(pkg, fx, tmp_path_factory):
    """The fixture's index built by one package (the protein one with
    --protein, cached per process)."""
    if fx != PROTEIN:
        return (port_index if pkg == "port" else get_index)(fx, tmp_path_factory)
    if pkg not in _PROTEIN_IDX:
        if pkg == "port":
            from centrifuger_tpu_torch.build import build_index
        else:
            from centrifuger_tpu.build import build_index
        d = os.path.join(FIXTURE_DIR, fx)
        prefix = str(tmp_path_factory.mktemp("%s_%s" % (pkg, fx)) / "idx")
        with contextlib.redirect_stderr(io.StringIO()):
            build_index([os.path.join(d, "ref.fa")], os.path.join(d, "nodes.dmp"),
                        os.path.join(d, "names.dmp"), os.path.join(d, "ref_seqid.map"),
                        conversion_at_file_level=False, output_prefix=prefix,
                        protein=True)
        _PROTEIN_IDX[pkg] = prefix
    return _PROTEIN_IDX[pkg]


def run(main, argv, stdin=None):
    """(return code, stdout, stderr) of a CLI's main in-process."""
    out, err = io.StringIO(), io.StringIO()
    old_stdin = sys.stdin
    if stdin is not None:
        sys.stdin = stdin
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(argv)
            except SystemExit as e:
                rc = e.code
    finally:
        sys.stdin = old_stdin
    return rc, out.getvalue(), err.getvalue()


def golden(fx, name):
    with open(os.path.join(FIXTURE_DIR, fx, name)) as f:
        return f.read()


# ------------------------------------------------------------ the quantifier

def quant_text(mod, prefix, tsv, fmt, **load_kw):
    q = mod.Quantifier()
    q.init_from_index(prefix)
    q.load_read_assignments(tsv, **load_kw)
    q.quantification()
    buf = io.StringIO()
    q.output(buf, fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", [0, 1, 2, 3])
@pytest.mark.parametrize("fx", QUANT_FIXTURES)
def test_quantifier_matches_jax_and_goldens(tmp_path_factory, fx, fmt):
    from centrifuger_tpu.quant import quantifier as jq
    from centrifuger_tpu_torch.quant import quantifier as pq
    tsv = os.path.join(FIXTURE_DIR, fx, "golden_class_k1.tsv")
    ours = quant_text(pq, index("port", fx, tmp_path_factory), tsv, fmt)
    theirs = quant_text(jq, index("jax", fx, tmp_path_factory), tsv, fmt)
    assert ours == theirs
    assert ours.count("\n") > 1
    if fmt in (0, 3):
        name = "golden_quant_centrifuger.tsv" if fmt == 0 else "golden_quant_kreport.tsv"
        assert ours == golden(fx, name)


@pytest.mark.parametrize("src", ["golden_class_k5.tsv", "golden_class_k2.tsv"])
@pytest.mark.parametrize("fx", ["tiny", "small"])
def test_quantifier_multi_assignment_matches_jax(tmp_path_factory, fx, src):
    from centrifuger_tpu.quant import quantifier as jq
    from centrifuger_tpu_torch.quant import quantifier as pq
    tsv = os.path.join(FIXTURE_DIR, fx, src)
    for fmt in (0, 3):
        assert quant_text(pq, index("port", fx, tmp_path_factory), tsv, fmt) == \
            quant_text(jq, index("jax", fx, tmp_path_factory), tsv, fmt)


ROWS = [
    ("r1", "s", "100", "4225", "4225", "80", "100", "2"),
    ("r1", "s", "200", "4225", "4225", "80", "100", "2"),
    ("r2", "s", "100", "1000", "900", "50", "100", "1"),
    ("r3", "s", "0", "0", "0", "0", "100", "1"),
    ("r4", "s", "200", "3000", "100", "30", "100", "1"),
    ("r5", "s", "100", "4225", "4225", "85", "100", "2"),
    ("r5", "s", "200", "4225", "4225", "85", "100", "2"),
    ("r6", "s", "100", "900", "900", "99", "100", "1"),
]
HEADER = ("readID\tseqID\ttaxID\tscore\t2ndBestScore\thitLength\t"
          "queryLength\tnumMatches\n")


def _empty_quantifier(mod, tax_mod):
    fx = os.path.join(FIXTURE_DIR, "tiny")
    q = mod.Quantifier()
    q.tax = tax_mod.Taxonomy.from_dumps(os.path.join(fx, "nodes.dmp"),
                                        os.path.join(fx, "names.dmp"), None,
                                        presence_from_nodes=True)
    q._alloc()
    return q


def _state(q):
    return (q.unclassified_cnt,
            [(a.targets, a.weight, a.count, a.uniq_count) for a in q.assignments])


def _quantifiers():
    from centrifuger_tpu import taxonomy as jt
    from centrifuger_tpu.quant import quantifier as jq
    from centrifuger_tpu_torch import taxonomy as pt
    from centrifuger_tpu_torch.quant import quantifier as pq
    return (lambda: _empty_quantifier(pq, pt)), (lambda: _empty_quantifier(jq, jt))


@pytest.mark.parametrize("min_score,min_hitlen", [(0, 0), (1000, 0), (0, 60), (4000, 80)])
@pytest.mark.parametrize("trailing_nl", [True, False])
def test_native_ingest_matches_line_loop_and_jax(tmp_path, min_score, min_hitlen,
                                                 trailing_nl):
    tsv = HEADER + "\n".join("\t".join(r) for r in ROWS) + ("\n" if trailing_nl else "")
    p = tmp_path / "cls.tsv"
    p.write_text(tsv)
    port, jax = _quantifiers()
    qn, ql, qj = port(), port(), jax()
    qn._load_read_assignments_native(str(p), min_score, min_hitlen)
    ql._load_read_assignments_lines(str(p), min_score, min_hitlen)
    qj._load_read_assignments_native(str(p), min_score, min_hitlen)
    assert _state(qn) == _state(ql) == _state(qj)
    assert qn.assignments or min_score == 4000


def test_native_ingest_gzip_matches_line_loop(tmp_path):
    p = tmp_path / "cls.tsv.gz"
    with gzip.open(p, "wt") as f:
        f.write(HEADER + "\n".join("\t".join(r) for r in ROWS) + "\n")
    port, jax = _quantifiers()
    qn, ql, qj = port(), port(), jax()
    qn.load_read_assignments(str(p))
    ql._load_read_assignments_lines(str(p))
    qj.load_read_assignments(str(p))
    assert _state(qn) == _state(ql) == _state(qj)
    assert qn.assignments


@pytest.mark.parametrize("content", ["", HEADER])
def test_native_ingest_empty_and_header_only(tmp_path, content):
    p = tmp_path / "e.tsv"
    p.write_text(content)
    port, _ = _quantifiers()
    for load in ("load_read_assignments", "_load_read_assignments_lines"):
        q = port()
        getattr(q, load)(str(p))
        assert _state(q) == (0, [])


def test_native_ingest_on_a_classified_golden_matches_line_loop(tmp_path_factory):
    from centrifuger_tpu_torch.quant import quantifier as pq
    prefix = index("port", "small", tmp_path_factory)
    tsv = os.path.join(FIXTURE_DIR, "small", "golden_class_k5.tsv")
    for kw in ({}, dict(min_score=300, min_hit_length=30)):
        a, b = pq.Quantifier(), pq.Quantifier()
        a.init_from_index(prefix)
        b.init_from_index(prefix)
        a._load_read_assignments_native(tsv, kw.get("min_score", 0),
                                        kw.get("min_hit_length", 0))
        b._load_read_assignments_lines(tsv, **kw)
        assert _state(a) == _state(b)


def test_ragged_input_takes_the_line_loop(tmp_path):
    """A TSV the native pass refuses (a non-numeric field) is read by the
    line loop: the input picks the route, as in the JAX package."""
    rows = [list(r) for r in ROWS]
    rows[2][6] = "10x"
    p = tmp_path / "ragged.tsv"
    p.write_text(HEADER + "\n".join("\t".join(r) for r in rows) + "\n")
    port, jax = _quantifiers()
    q, qj = port(), jax()
    try:
        q.load_read_assignments(str(p))
        got = ("ok", _state(q))
    except ValueError as e:
        got = ("ValueError", str(e))
    try:
        qj.load_read_assignments(str(p))
        want = ("ok", _state(qj))
    except ValueError as e:
        want = ("ValueError", str(e))
    assert got == want


# ------------------------------------------------------------ cfr-quant-torch

def _size_table(tmp_path, prefix):
    from centrifuger_tpu_torch.cli import inspect_cli
    rc, out, _ = run(inspect_cli.main, ["-x", prefix, "--size-table"])
    assert rc == 0 and out
    p = tmp_path / "size.tsv"
    p.write_text(out)
    return str(p)


@pytest.mark.parametrize("fmt", [0, 1, 2, 3])
def test_quant_cli_matches_jax_cli(tmp_path_factory, tmp_path, fmt):
    from centrifuger_tpu.cli import quant_cli as jax_cli
    from centrifuger_tpu_torch.cli import quant_cli
    d = os.path.join(FIXTURE_DIR, "small")
    tsv = os.path.join(d, "golden_class_k1.tsv")
    prefix = index("port", "small", tmp_path_factory)
    dumps = ["--taxonomy-tree", os.path.join(d, "nodes.dmp"),
             "--name-table", os.path.join(d, "names.dmp")]
    runs = {
        "index": ["-x", prefix, "-c", tsv],
        "stdin": ["-x", prefix, "-c", "-"],
        "filters": ["-x", prefix, "-c", tsv, "--min-score", "500", "--min-length", "40"],
        "dumps": dumps + ["-c", tsv],
        "size table": dumps + ["--size-table", _size_table(tmp_path, prefix), "-c", tsv],
    }
    got = {}
    for name, argv in runs.items():
        argv = argv + ["--output-format", str(fmt)]
        with open(tsv) as a, open(tsv) as b:
            ours = run(quant_cli.main, argv, stdin=a if name == "stdin" else None)
            theirs = run(jax_cli.main, argv, stdin=b if name == "stdin" else None)
        assert ours == theirs, name
        assert ours[0] == 0 and ours[1]
        got[name] = ours[1]
    assert got["stdin"] == got["index"]
    if fmt == 0:
        assert got["index"] == golden("small", "golden_quant_centrifuger.tsv")
    if fmt == 3:
        assert got["index"] == golden("small", "golden_quant_kreport.tsv")


def test_quant_cli_needs_an_index_or_dumps():
    from centrifuger_tpu_torch.cli import quant_cli
    rc, out, err = run(quant_cli.main, ["-c", "x.tsv"])
    assert (rc, out, err) == (1, "", "Need -x or --taxonomy-tree/--name-table.\n")


# ------------------------------------------------------------ cfr-kreport-torch

@pytest.mark.parametrize("name,extra,src", [
    ("golden_kreport_script.tsv", [], "golden_class_k1.tsv"),
    ("golden_kreport_nolca.tsv", ["--no-lca"], "golden_class_k5.tsv"),
])
def test_kreport_goldens(tmp_path_factory, name, extra, src):
    from centrifuger_tpu_torch.cli import kreport_cli
    rc, out, _ = run(kreport_cli.main, ["-x", index("port", "tiny", tmp_path_factory)] + extra
                     + [os.path.join(FIXTURE_DIR, "tiny", src)])
    assert rc == 0
    assert out == golden("tiny", name)


def _count_table(tmp_path):
    p = tmp_path / "counts.tsv"
    p.write_text("562\t10\n1000\t3.5\n99999999\t1\n\n10\n")
    return str(p)


@pytest.mark.parametrize("case", ["show-zeros", "count-table", "min-score", "min-length",
                                  "score-data", "no-lca score-data", "stdin",
                                  "count tables"])
@pytest.mark.parametrize("fx", ["tiny", "small"])
def test_kreport_matches_jax_cli(tmp_path_factory, tmp_path, fx, case):
    from centrifuger_tpu.cli import kreport_cli as jax_cli
    from centrifuger_tpu_torch.cli import kreport_cli
    d = os.path.join(FIXTURE_DIR, fx)
    k5 = os.path.join(d, "golden_class_k5.tsv")
    flags = {
        "show-zeros": ["--show-zeros", k5],
        "count-table": ["--is-count-table", _count_table(tmp_path)],
        "min-score": ["--min-score", "400", k5],
        "min-length": ["--min-length", "60", k5],
        "score-data": ["--report-score-data", k5],
        "no-lca score-data": ["--no-lca", "--report-score-data", k5],
        "stdin": [],
        "count tables": ["--is-count-table", _count_table(tmp_path), _count_table(tmp_path)],
    }[case]
    argv = ["-x", index("port", fx, tmp_path_factory)] + flags
    with open(k5) as a, open(k5) as b:
        ours = run(kreport_cli.main, argv, stdin=a if case == "stdin" else None)
        theirs = run(jax_cli.main, argv, stdin=b if case == "stdin" else None)
    assert ours == theirs
    assert ours[0] == 0 and ours[1].split("\n")[0].endswith("\tU\t0\tunclassified" +
                                                          ("\t0" if "score-data" in case else ""))
    assert ours[1].count("\n") >= 2


def test_kreport_no_match_exits_1_as_the_jax_cli(tmp_path_factory):
    from centrifuger_tpu.cli import kreport_cli as jax_cli
    from centrifuger_tpu_torch.cli import kreport_cli
    argv = ["-x", index("port", "tiny", tmp_path_factory), "--min-score", "100000000",
            os.path.join(FIXTURE_DIR, "tiny", "golden_class_k1.tsv")]
    ours, theirs = run(kreport_cli.main, argv), run(jax_cli.main, argv)
    assert ours == theirs
    assert ours[0] == 1 and ours[2] == "No sequence matches with given settings\n"


# ------------------------------------------------------------ cfr-promote-torch

@pytest.mark.parametrize("name,level", [("golden_promote_genus.tsv", "genus"),
                                        ("golden_promote_lca.tsv", "lca")])
def test_promote_goldens(tmp_path_factory, name, level):
    from centrifuger_tpu_torch.cli import promote_cli
    rc, out, _ = run(promote_cli.main, [index("port", "tiny", tmp_path_factory),
                                        os.path.join(FIXTURE_DIR, "tiny",
                                                     "golden_class_k5.tsv"), level])
    assert rc == 0
    assert out == golden("tiny", name)


@pytest.mark.parametrize("level", ["species", "phylum", "strain", "genus", "lca"])
@pytest.mark.parametrize("fx", ["tiny", "small"])
def test_promote_matches_jax_cli(tmp_path_factory, fx, level):
    from centrifuger_tpu.cli import promote_cli as jax_cli
    from centrifuger_tpu_torch.cli import promote_cli
    argv = [index("port", fx, tmp_path_factory),
            os.path.join(FIXTURE_DIR, fx, "golden_class_k5.tsv"), level]
    ours = run(promote_cli.main, argv)
    assert ours == run(jax_cli.main, argv)
    assert ours[0] == 0 and ours[1].startswith("readID\t")


# ------------------------------------------------------------ cfr-inspect-torch

@pytest.mark.parametrize("flag", ["--summary", "--conversion-table", "--taxonomy-tree",
                                  "--name-table", "--size-table", "--index-size", None])
@pytest.mark.parametrize("fx", ["tiny", "small", PROTEIN])
def test_inspect_matches_jax_cli(tmp_path_factory, fx, flag):
    from centrifuger_tpu.cli import inspect_cli as jax_cli
    from centrifuger_tpu_torch.cli import inspect_cli
    argv = ["-x", index("port", fx, tmp_path_factory)] + ([flag] if flag else [])
    ours = run(inspect_cli.main, argv)
    assert ours == run(jax_cli.main, argv)
    if flag is None:
        assert ours[0] == 1
    elif flag == "--index-size":
        assert ours[0] == 0 and ours[1] == "" and ours[2].count("\n") == 4
    else:
        assert ours[0] == 0 and ours[1].count("\n") >= 1 and ours[2] == ""


def test_toolchain_failure_raises_in_the_quantifier(tmp_path, monkeypatch):
    """A file the native pass would read: when g++ fails the ingest raises
    (the JAX package would take the line loop)."""
    from centrifuger_tpu_torch import native

    def broken(name):
        raise OSError("g++: command not found")
    monkeypatch.setattr(native, "_build_lib", broken)
    monkeypatch.setattr(native, "_LIBS", {})
    p = tmp_path / "cls.tsv"
    p.write_text(HEADER + "\n".join("\t".join(r) for r in ROWS) + "\n")
    port, _ = _quantifiers()
    with pytest.raises(OSError, match="g\\+\\+"):
        port().load_read_assignments(str(p))
