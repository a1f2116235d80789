"""The port end to end on the CPU (the kernels' plain twins): its builder
writes the same index files as centrifuger_tpu's, and its CLI writes TSVs
byte-identical, in order, to the reference goldens; random units agree with
the exact host engine."""

import contextlib
import io
import os
import random

import numpy as np
import pytest
import torch

from conftest import FIXTURE_DIR
from test_golden_classify import get_index, assert_tsv_equal
from test_engine_fused import _rand_reads, _results_equal

torch.set_num_threads(1)   # the suite runs in several worker processes

_PORT_IDX = {}


def port_index(fx, tmp_path_factory):
    """The fixture's index built by the port's builder (cached per process)."""
    if fx not in _PORT_IDX:
        from centrifuger_tpu_torch.build import build_index
        d = os.path.join(FIXTURE_DIR, fx)
        prefix = str(tmp_path_factory.mktemp("port_" + fx) / "idx")
        with contextlib.redirect_stderr(io.StringIO()):
            build_index([os.path.join(d, "ref.fa")], os.path.join(d, "nodes.dmp"),
                        os.path.join(d, "names.dmp"), os.path.join(d, "ref_seqid.map"),
                        conversion_at_file_level=False, output_prefix=prefix)
        _PORT_IDX[fx] = prefix
    return _PORT_IDX[fx]


def run_port_cli(fx, prefix, extra, paired=True):
    from centrifuger_tpu_torch.cli import classify_cli
    d = os.path.join(FIXTURE_DIR, fx)
    rargs = (["-1", os.path.join(d, "reads_1.fq"), "-2", os.path.join(d, "reads_2.fq")]
             if paired else ["-u", os.path.join(d, "reads_1.fq")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert classify_cli.main(["-x", prefix, "--device", "cpu"] + rargs + extra) == 0
    return buf.getvalue()


@pytest.mark.parametrize("fx", ["tiny", "tiny_single", "small"])
def test_build_matches_jax_build(tmp_path_factory, fx):
    ours = port_index(fx, tmp_path_factory)
    theirs = get_index(fx, tmp_path_factory)
    for ext in (".fm.npz", ".rowmap.npz", ".tax.npz", ".seqlen.npz"):
        a, b = np.load(ours + ext), np.load(theirs + ext)
        assert a.files == b.files, ext
        for k in a.files:
            assert np.array_equal(a[k], b[k]), (ext, k)


KS = [("k1", []), ("k2", ["-k", "2"]), ("k5", ["-k", "5"])]


@pytest.mark.parametrize("tag,extra", KS)
@pytest.mark.parametrize("fx,paired", [("tiny", True), ("tiny_single", False),
                                       ("small", True)])
def test_cli_goldens(tmp_path_factory, fx, paired, tag, extra):
    got = run_port_cli(fx, port_index(fx, tmp_path_factory), extra, paired)
    assert_tsv_equal(got, os.path.join(FIXTURE_DIR, fx, "golden_class_%s.tsv" % tag))


@pytest.mark.parametrize("tag,extra", KS)
def test_cli_goldens_lf_walk(tmp_path_factory, tag, extra):
    """--no-rowmap: every SA resolve walks LF; the TSV must not change."""
    batches = ["--batch-size", "128"] if tag == "k1" else []   # 3 batches
    got = run_port_cli("small", port_index("small", tmp_path_factory),
                       extra + ["--no-rowmap"] + batches)
    assert_tsv_equal(got, os.path.join(FIXTURE_DIR, "small", "golden_class_%s.tsv" % tag))


def test_expand_taxid_matches_jax_cli(tmp_path_factory):
    """The materialized-result path (--expand-taxid) against the JAX CLI."""
    from test_golden_classify import run_classify
    prefix = port_index("tiny", tmp_path_factory)
    got = run_port_cli("tiny", prefix, ["-k", "2", "--expand-taxid"])
    with contextlib.redirect_stderr(io.StringIO()):
        want = run_classify(os.path.join(FIXTURE_DIR, "tiny"), prefix,
                            ["-k", "2", "--expand-taxid"], engine="fused")
    assert got == want


def tiny_genomes():
    genomes = []
    with open(os.path.join(FIXTURE_DIR, "tiny", "ref.fa")) as f:
        for line in f:
            if line.startswith(">"):
                genomes.append([])
            else:
                genomes[-1].append(line.strip())
    return ["".join(g) for g in genomes]


def engines(prefix, k):
    """(the JAX package's exact host engine, the port's engine on the CPU),
    each on its own package's load of the same index files."""
    from centrifuger_tpu.build import load_index as jax_load_index
    from centrifuger_tpu.classify.engine_np import ClassifierNP
    from centrifuger_tpu.classify.params import ClassifierParam as JaxParam
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    jfm, jtax, _, _ = jax_load_index(prefix)
    fm, tax, _, _ = load_index(prefix)
    return (ClassifierNP(jfm, jtax, JaxParam(max_result=k)),
            ClassifierTorch(fm, tax, ClassifierParam(max_result=k), device="cpu"))


@pytest.mark.parametrize("paired,k", [(False, 1), (True, 1), (False, 2), (True, 3)])
def test_engine_vs_host_oracle_random(tmp_path_factory, paired, k):
    oracle, port = engines(port_index("tiny", tmp_path_factory), k)
    queries = _rand_reads(random.Random(97 + k + paired), tiny_genomes(), 30, 60, paired)
    want = [oracle.query(r1, r2) for r1, r2 in queries]
    got = port.query_batch(queries)
    for i, (w, g) in enumerate(zip(want, got)):
        assert _results_equal(w, g), i


def test_read_over_l_max(tmp_path_factory):
    """A read over L_MAX goes to the non-fused engine on the engine's own
    device, as the JAX package's fused engine hands it to ClassifierJax, and
    agrees with the JAX package's host engine.  The read is mostly N, which
    keeps the host engine's work small."""
    oracle, port = engines(port_index("tiny", tmp_path_factory), 1)
    read = np.frombuffer(("N" * 8100 + tiny_genomes()[0][500:600]).encode(), np.uint8)
    assert len(read) > port.L_MAX
    want = oracle.query(read, None)
    assert _results_equal(want, port.query_batch([(read, None)])[0])
    [(packed, fb, _)] = port.query_pipelined_packed(iter([[(read, None)]]))
    assert packed is None and _results_equal(want, fb[0])
    assert port.stats["fast_units"] + port.stats["slow_units"] == 2


@pytest.mark.parametrize("flag", [["--barcode-whitelist", "{wl}"],
                                  ["--UMI", "{umi}"], ["--merge-readpair"],
                                  ["--read-format", "r1:0:-1"], ["--un", "{out}/x"],
                                  ["--barcode", "{bc}"], ["--sample-sheet", "{sheet}"]])
def test_read_prep_flags_match_jax_cli(tmp_path_factory, tmp_path, flag):
    """Each read-prep flag alone on the tiny pairs (a sample sheet of two
    samples of them): the port's TSV, dumps and per-sample files equal the
    JAX CLI's byte for byte."""
    from test_torch_cli_features import (PAIRED, make_read_prep_files, outputs, run_jax,
                                         run_port, sheet_for)
    prefix = port_index("tiny", tmp_path_factory)
    files = make_read_prep_files(tmp_path_factory.mktemp("flags"))
    res = []
    for name, run in (("jax", run_jax), ("port", run_port)):
        d = tmp_path / name
        d.mkdir()
        if flag[0] == "--sample-sheet":
            args = ["--sample-sheet", sheet_for(files, d)]
        else:
            args = PAIRED + [a.replace("{out}", str(d)).format(**files) for a in flag]
        tsv = run(prefix, args)
        res.append((tsv, {k: v for k, v in outputs(d).items() if k != "sheet.tsv"}))
    assert res[1] == res[0]
    assert res[0][0] or len(res[0][1]) >= 2   # a TSV, or the two samples' files
