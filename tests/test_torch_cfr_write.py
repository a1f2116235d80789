"""The port's .cfr writer (interop/cfr_write.py, cfr-build-torch --emit-cfr)
against the reference-built fixtures and the JAX package's writer: the
.1.cfr of the port's own build equals tests/fixtures/*/refidx.1.cfr byte for
byte (the JAX writer differs at the offsets recorded below), the .2/.3.cfr
bytes and the .4.cfr but for its build_date equal the JAX writer's; the
port's reader loads what it wrote, and the CLI classifies a .cfr-only prefix
to the goldens."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from conftest import FIXTURE_DIR
from test_golden_classify import assert_tsv_equal
from test_torch_golden import port_index

# The offsets at which the JAX writer's .1.cfr of the same index differs from
# the reference-built refidx.1.cfr: the low two bytes of the `_space` fields
# of Sequence_RunBlock (offset 25) and of each non-empty wavelet tree, which
# it writes as 0, and in tiny the rank9 sub-block words of the two final
# one-word blocks, which it fills and the reference leaves 0.
JAX_WRITER_DIFFS = {
    "tiny": [25, 26, 4197, 4198] + list(range(8025, 8033)) + [10421, 10422]
    + [14321, 14322, 14323, 14324, 14325, 14327, 14328],
    "small": [25, 26, 11077, 11078, 29085, 29086],
    "tiny_single": [25, 26, 1709, 1710],
}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _diff_offsets(a, b):
    assert len(a) == len(b)
    return np.flatnonzero(np.frombuffer(a, np.uint8) != np.frombuffer(b, np.uint8)).tolist()


def _assert_reference_bytes(ours, theirs, fx):
    """`ours` (.1.cfr) equals the fixture's reference-built file; `theirs`,
    the JAX writer's, differs from it exactly at JAX_WRITER_DIFFS[fx]."""
    ref = _read(os.path.join(FIXTURE_DIR, fx, "refidx.1.cfr"))
    assert _read(ours) == ref
    assert _diff_offsets(_read(theirs), ref) == JAX_WRITER_DIFFS[fx]


def _write_both(prefix, out_dir):
    """The port's index files at `prefix`, loaded by each package and written
    by each package's writer."""
    from centrifuger_tpu.build import load_index as jax_load
    from centrifuger_tpu.interop.cfr_write import save_cfr_index as jax_save
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.interop.cfr_write import save_cfr_index
    fm, tax, seq_length, _ = load_index(prefix)
    ours = os.path.join(out_dir, "port")
    save_cfr_index(fm, tax, seq_length, ours)
    fm, tax, seq_length, _ = jax_load(prefix)
    theirs = os.path.join(out_dir, "jax")
    jax_save(fm, tax, seq_length, theirs)
    return ours, theirs


def _meta_lines(path):
    with open(path) as f:
        return [line for line in f.read().split("\n") if not line.startswith("build_date\t")]


@pytest.mark.parametrize("fx", ["tiny", "small", "tiny_single"])
def test_writer_bytes_match_jax_writer(tmp_path_factory, tmp_path, fx):
    ours, theirs = _write_both(port_index(fx, tmp_path_factory), str(tmp_path))
    _assert_reference_bytes(ours + ".1.cfr", theirs + ".1.cfr", fx)
    for part in (2, 3):
        with open("%s.%d.cfr" % (ours, part), "rb") as a, \
                open("%s.%d.cfr" % (theirs, part), "rb") as b:
            assert a.read() == b.read(), part
    assert _meta_lines(ours + ".4.cfr") == _meta_lines(theirs + ".4.cfr")
    with open(ours + ".4.cfr") as f:
        assert f.read().splitlines()[-1].startswith("build_date\t")


@pytest.mark.parametrize("fx", ["tiny", "small", "tiny_single"])
def test_writer_bytes_match_the_reference_file(tmp_path, fx):
    """save_cfr_fm on the index build_index returns (no reload) writes the
    fixture's reference-built refidx.1.cfr byte for byte."""
    from centrifuger_tpu_torch.build import build_index
    from centrifuger_tpu_torch.interop.cfr_write import save_cfr_fm
    d = os.path.join(FIXTURE_DIR, fx)
    with contextlib.redirect_stderr(io.StringIO()):
        fm, _, _ = build_index([os.path.join(d, "ref.fa")], os.path.join(d, "nodes.dmp"),
                               os.path.join(d, "names.dmp"), os.path.join(d, "ref_seqid.map"),
                               conversion_at_file_level=False,
                               output_prefix=str(tmp_path / "idx"))
    save_cfr_fm(fm, str(tmp_path / "idx.1.cfr"))
    got, want = _read(str(tmp_path / "idx.1.cfr")), _read(os.path.join(d, "refidx.1.cfr"))
    assert len(got) == len(want)
    assert _diff_offsets(got, want) == []


def test_writer_bytes_of_a_chunked_build_match(tmp_path):
    """The chunked build's index gives the SA-IS build's .cfr bytes."""
    from centrifuger_tpu_torch.build import build_index
    from centrifuger_tpu_torch.interop.cfr_write import save_cfr_fm
    d = os.path.join(FIXTURE_DIR, "small")
    args = ([os.path.join(d, "ref.fa")], os.path.join(d, "nodes.dmp"),
            os.path.join(d, "names.dmp"), os.path.join(d, "ref_seqid.map"))
    got = []
    for name, kw in (("sais", {}), ("chunked", dict(threads=2, bmax=2048, dcv=64))):
        with contextlib.redirect_stderr(io.StringIO()):
            fm, _, _ = build_index(*args, conversion_at_file_level=False,
                                   output_prefix=str(tmp_path / name), **kw)
        save_cfr_fm(fm, str(tmp_path / (name + ".1.cfr")))
        with open(str(tmp_path / (name + ".1.cfr")), "rb") as f:
            got.append(f.read())
    assert got[0] == got[1]


@pytest.mark.parametrize("fx", ["tiny", "small"])
def test_reader_loads_what_the_writer_wrote(tmp_path_factory, tmp_path, fx):
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.interop.cfr import load_cfr_index
    prefix = port_index(fx, tmp_path_factory)
    ours, _ = _write_both(prefix, str(tmp_path))
    fm, _, seq_length, _ = load_index(prefix)
    fm2, _, seq_length2, meta = load_cfr_index(ours)
    assert fm2.n == fm.n
    assert fm2.first_isa == fm.first_isa
    assert seq_length2 == seq_length
    assert np.array_equal(np.asarray(fm2.sampled_sa), np.asarray(fm.sampled_sa))
    assert np.array_equal(fm2.bwt.decode(), fm.bwt.decode())
    assert meta["sequence_type"] == "nucleotide"
    assert int(meta["SA_sample_rate"]) == fm.sample_rate


def _cli_build(prefix, fx, extra):
    from centrifuger_tpu_torch.cli import build_cli
    d = os.path.join(FIXTURE_DIR, fx)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = build_cli.main(["-r", os.path.join(d, "ref.fa"),
                             "--taxonomy-tree", os.path.join(d, "nodes.dmp"),
                             "--name-table", os.path.join(d, "names.dmp"),
                             "--conversion-table", os.path.join(d, "ref_seqid.map"),
                             "-o", prefix] + extra)
    return rc, err.getvalue()


@pytest.fixture(scope="module")
def emitted(tmp_path_factory):
    """cfr-build-torch --emit-cfr on tiny, the four .cfr files copied to a
    prefix of their own (the CLI reads .cfr only where no .fm.npz is)."""
    d = tmp_path_factory.mktemp("emit")
    prefix = str(d / "idx")
    rc, _ = _cli_build(prefix, "tiny", ["--emit-cfr"])
    assert rc == 0
    os.makedirs(str(d / "cfr_only"))
    only = str(d / "cfr_only" / "idx")
    for part in (1, 2, 3, 4):
        shutil.copy("%s.%d.cfr" % (prefix, part), "%s.%d.cfr" % (only, part))
    return prefix, only


@pytest.mark.parametrize("tag,extra", [("k1", []), ("k2", ["-k", "2"])])
def test_emit_cfr_classifies_to_the_goldens(emitted, tag, extra):
    from centrifuger_tpu_torch.cli import classify_cli
    _, only = emitted
    d = os.path.join(FIXTURE_DIR, "tiny")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert classify_cli.main(["-x", only, "--device", "cpu",
                                  "-1", os.path.join(d, "reads_1.fq"),
                                  "-2", os.path.join(d, "reads_2.fq")] + extra) == 0
    assert_tsv_equal(buf.getvalue(), os.path.join(d, "golden_class_%s.tsv" % tag))


def test_emit_cfr_matches_the_jax_writer_on_the_cli_index(emitted, tmp_path):
    prefix, only = emitted
    _, theirs = _write_both(prefix, str(tmp_path))
    _assert_reference_bytes(only + ".1.cfr", theirs + ".1.cfr", "tiny")
    for part in (2, 3):
        with open("%s.%d.cfr" % (only, part), "rb") as a, \
                open("%s.%d.cfr" % (theirs, part), "rb") as b:
            assert a.read() == b.read(), part
    assert _meta_lines(only + ".4.cfr") == _meta_lines(theirs + ".4.cfr")


def test_emit_cfr_protein_returns_1_as_the_jax_cli(tmp_path):
    from centrifuger_tpu.cli import build_cli as jax_build_cli
    rc, err = _cli_build(str(tmp_path / "p"), "tiny_protein", ["--protein", "--emit-cfr"])
    d = os.path.join(FIXTURE_DIR, "tiny_protein")
    jerr = io.StringIO()
    with contextlib.redirect_stderr(jerr):
        jrc = jax_build_cli.main(["-r", os.path.join(d, "ref.fa"),
                                  "--taxonomy-tree", os.path.join(d, "nodes.dmp"),
                                  "--name-table", os.path.join(d, "names.dmp"),
                                  "--conversion-table", os.path.join(d, "ref_seqid.map"),
                                  "-o", str(tmp_path / "j"), "--protein", "--emit-cfr"])
    assert rc == jrc == 1
    msg = "--emit-cfr: protein (one-tree) layout not supported; skipping .cfr emission.\n"
    assert err.endswith(msg) and jerr.getvalue().endswith(msg)
    assert not os.path.exists(str(tmp_path / "p.1.cfr"))
