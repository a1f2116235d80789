"""The port's cfr-classify-torch against the JAX package's cfr-classify on the
read-prep surface, both on the CPU (the port at --device cpu, the JAX CLI
with its non-fused engine, --engine jax, which the goldens hold too): --read-format, interleaved input,
--merge-readpair, barcodes and UMIs with whitelist correction and
translation, --un / --cl dumps, sample sheets, --expand-taxid, --engine jax;
the single-end bulk FASTQ route; --n-ranks with cfr-merge-shards-torch; a
reference-built .cfr index; and the option strings of the two parsers.  Every
TSV, dump and per-sample file must be byte-identical."""

import argparse
import contextlib
import gzip
import io
import os
import random
import sys

import pytest
import torch

from conftest import FIXTURE_DIR
from test_golden_classify import assert_tsv_equal
from test_torch_golden import port_index

torch.set_num_threads(1)   # the suite runs in several worker processes

FX = os.path.join(FIXTURE_DIR, "tiny")
R1, R2 = os.path.join(FX, "reads_1.fq"), os.path.join(FX, "reads_2.fq")
SINGLE = os.path.join(FIXTURE_DIR, "tiny_single", "reads_1.fq")
PAIRED = ["-1", R1, "-2", R2]


def run_jax(prefix, args, engine="jax"):
    from centrifuger_tpu.cli import classify_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        classify_cli.main(["-x", prefix, "--engine", engine] + args)
    return buf.getvalue()


def run_port(prefix, args):
    from centrifuger_tpu_torch.cli import classify_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert classify_cli.main(["-x", prefix, "--device", "cpu"] + args) == 0
    return buf.getvalue()


def outputs(d):
    """{file name: bytes} of a run's output directory, gzip files read
    through."""
    got = {}
    for name in sorted(os.listdir(d)):
        op = gzip.open if name.endswith(".gz") else open
        with op(os.path.join(d, name), "rb") as f:
            got[name] = f.read()
    return got


def run_both(prefix, tmp, args, port_extra=()):
    """The JAX CLI and the port's CLI on the same arguments,
    port_extra added to the port's; "{out}" in an argument is each run's own
    output directory.  Returns ((TSV, files) of the JAX run, (TSV, files) of
    the port's)."""
    res = []
    for name, run in (("jax", lambda a: run_jax(prefix, a)),
                      ("port", lambda a: run_port(prefix, a + list(port_extra)))):
        d = tmp / name
        d.mkdir()
        tsv = run([a.replace("{out}", str(d)) for a in args])
        res.append((tsv, outputs(d)))
    return res


def make_read_prep_files(d):
    """Seeded barcode reads (a 1-bp error in 30% of them), their whitelist and
    a translation table, the tiny pairs interleaved, and a two-sample sheet
    (its outputs under "{out}")."""
    rng = random.Random(5)
    whitelist = ["".join(rng.choice("ACGT") for _ in range(12)) for _ in range(20)]
    n_reads = sum(1 for _ in open(R1)) // 4
    files = {k: str(d / v) for k, v in (
        ("bc", "barcodes.fq"), ("umi", "umis.fq"), ("wl", "whitelist.txt"),
        ("tr", "translate.tsv"), ("inter", "inter.fq"), ("sheet", "sheet.tsv"))}
    with open(files["bc"], "w") as f:
        for i in range(n_reads):
            bc = rng.choice(whitelist)
            if rng.random() < 0.3:
                p = rng.randrange(12)
                bc = bc[:p] + rng.choice("ACGT") + bc[p + 1:]
            f.write("@bc%d\n%s\n+\n%s\n" % (i, bc, "".join(rng.choice("#5?I")
                                                          for _ in range(12))))
    with open(files["umi"], "w") as f:
        for i in range(n_reads):
            f.write("@um%d\n%s\n+\n%s\n" % (
                i, "".join(rng.choice("ACGT") for _ in range(8)), "I" * 8))
    with open(files["wl"], "w") as f:
        f.write("\n".join(whitelist) + "\n")
    with open(files["tr"], "w") as f:
        f.write("".join("cell%02d,%s\n" % (i, bc) for i, bc in enumerate(whitelist)))
    with open(R1) as f1, open(R2) as f2, open(files["inter"], "w") as out:
        while True:
            a = [f1.readline() for _ in range(4)]
            b = [f2.readline() for _ in range(4)]
            if not a[0]:
                break
            out.writelines(a + b)
    with open(files["sheet"], "w") as f:
        f.write("%s %s . . {out}/s1.tsv\n%s %s . . {out}/s2.tsv\n" % (R1, R2, R1, R2))
    return files


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    return port_index("tiny", tmp_path_factory)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_read_prep_files(tmp_path_factory.mktemp("read_prep"))


def sheet_for(files, d):
    """The sample sheet with its outputs under d (the CLI reads the paths
    from the file, so each run gets its own sheet)."""
    path = d / "sheet.tsv"
    with open(files["sheet"]) as f:
        path.write_text(f.read().replace("{out}", str(d)))
    return str(path)


# name -> (arguments of both CLIs, arguments of the port's only)
CASES = {
    "read_format_trim": (PAIRED + ["--read-format", "r1:0:49,r2:10:-1"], []),
    "interleaved": (["-i", "{inter}"], []),
    "merge_readpair": (PAIRED + ["--merge-readpair"], []),
    "barcode_umi_columns": (PAIRED + ["--barcode", "{bc}", "--UMI", "{umi}"], []),
    "whitelist_translate": (PAIRED + ["--barcode", "{bc}", "--barcode-whitelist", "{wl}",
                                      "--barcode-translate", "{tr}"], []),
    "whitelist_only": (PAIRED + ["--barcode", "{bc}", "--barcode-whitelist", "{wl}"], []),
    "un_cl_dumps": (PAIRED + ["--barcode", "{bc}", "--UMI", "{umi}",
                              "--un", "{out}/un", "--cl", "{out}/cl"], []),
    "un_single": (["-u", R1, "--un", "{out}/un"], []),
    "barcode_in_read": (PAIRED + ["--read-format", "r1:10:-1,bc:0:9,um:hd:1:0:3"], []),
    "expand_taxid_barcode": (PAIRED + ["-k", "2", "--expand-taxid", "--barcode", "{bc}"],
                             []),
    # the non-fused engine's query_pipelined
    "engine_jax_barcode": (PAIRED + ["--barcode", "{bc}"], ["--engine", "jax"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flags_match_jax_cli(prefix, files, tmp_path, case):
    args, port_extra = CASES[case]
    args = [a if "{out}" in a else a.format(**files) for a in args]
    (jt, jf), (pt, pf) = run_both(prefix, tmp_path, args, port_extra)
    assert pt == jt
    assert pf == jf
    assert bool(pf) == ("--un" in args)


def test_sample_sheet_matches_jax_cli(prefix, files, tmp_path):
    res = []
    for name, run in (("jax", run_jax), ("port", run_port)):
        d = tmp_path / name
        d.mkdir()
        run(prefix, ["--sample-sheet", sheet_for(files, d)])
        res.append({k: v for k, v in outputs(d).items() if k != "sheet.tsv"})
    assert set(res[0]) == {"s1.tsv", "s2.tsv"}
    assert res[1] == res[0]
    assert res[0]["s1.tsv"] == res[0]["s2.tsv"]   # the same pairs in both samples


# ------------------------------------------------------- the bulk FASTQ route

def test_bulk_route_single_end(tmp_path_factory, tmp_path, monkeypatch):
    """Single-end plain and gzip FASTQ take the native bulk route and give the
    golden TSV; the same reads on stdin (which the bulk route refuses) take
    the object route and give it too."""
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    calls = []
    serve = ClassifierTorch.serve_tsv_prepacked

    def spy(self, items):
        calls.append(1)
        return serve(self, items)
    monkeypatch.setattr(ClassifierTorch, "serve_tsv_prepacked", spy)
    prefix = port_index("tiny_single", tmp_path_factory)
    golden = os.path.join(FIXTURE_DIR, "tiny_single", "golden_class_k1.tsv")
    assert_tsv_equal(run_port(prefix, ["-u", SINGLE]), golden)
    gz = tmp_path / "r.fq.gz"
    with open(SINGLE, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    assert_tsv_equal(run_port(prefix, ["-u", str(gz), "--batch-size", "7"]), golden)
    assert len(calls) == 2
    with open(SINGLE, "rb") as f:
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(f.read())))
    assert_tsv_equal(run_port(prefix, ["-u", "-"]), golden)
    assert len(calls) == 2


def test_bulk_route_two_files_match_jax(prefix, tmp_path):
    """Two single-end files, batches counted per file: the JAX CLI's bulk
    route (its fused engine) gives the same TSV, and so does its non-fused
    engine with -k 0."""
    args = ["-u", SINGLE, "-u", R1, "--batch-size", "16"]
    assert run_port(prefix, args) == run_jax(prefix, args, engine="fused")
    # -k 0: each batch goes to the non-fused engine
    args += ["-k", "0"]
    assert run_port(prefix, args) == run_jax(prefix, args)


def test_missing_compiler_raises(prefix, tmp_path, monkeypatch):
    """No pure-Python fallback hides a failed native build: the bulk route's
    native load raises through the CLI."""
    import subprocess
    from centrifuger_tpu_torch import native

    def no_compiler(*a, **k):
        raise FileNotFoundError("g++")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_BUILD", str(tmp_path))
    monkeypatch.setattr(subprocess, "run", no_compiler)
    with pytest.raises(FileNotFoundError, match="g\\+\\+"):
        run_port(prefix, ["-u", SINGLE])


# -------------------------------------------------------------- multi-host

@pytest.mark.parametrize("reads", [PAIRED, ["-u", SINGLE]], ids=["paired", "bulk"])
def test_two_ranks_merge_to_the_single_run(prefix, tmp_path, reads):
    from centrifuger_tpu_torch.cli import merge_cli
    args = reads + ["--batch-size", "16"]
    want = run_port(prefix, args)
    assert want == run_jax(prefix, args)
    argv = ["-o", str(tmp_path / "merged.tsv")]
    for r in range(2):
        idx = str(tmp_path / ("rank%d.idx" % r))
        tsv = tmp_path / ("rank%d.tsv" % r)
        tsv.write_text(run_port(prefix, args + ["--n-ranks", "2", "--rank", str(r),
                                                "--rank-index", idx]))
        argv += ["--shard", str(tsv), idx]
    assert merge_cli.main(argv) == 0
    assert (tmp_path / "merged.tsv").read_text() == want


def test_n_ranks_checks(prefix, capsys):
    from centrifuger_tpu_torch.cli import classify_cli
    for extra in (["--n-ranks", "2", "--rank", "2"],
                  ["--n-ranks", "2", "--un", "x"]):
        with pytest.raises(SystemExit) as e:
            classify_cli.main(["-x", prefix, "-u", SINGLE, "--device", "cpu"] + extra)
        assert e.value.code != 0
    err = capsys.readouterr().err
    assert "--rank must be in" in err and "incompatible" in err


# ------------------------------------------------------------- .cfr indexes

@pytest.mark.parametrize("engine", [[], ["--engine", "jax"]], ids=["fused", "jax"])
def test_cfr_index_gives_the_golden(engine):
    """The checked-in reference-built index loads through the .cfr reader and
    classifies to the golden; it has no source prefix, so no wide-row cache
    is written beside it."""
    from centrifuger_tpu_torch.fm.device import SERVE_CACHE_SUFFIX
    cfr = os.path.join(FX, "refidx")
    assert_tsv_equal(run_port(cfr, PAIRED + engine),
                     os.path.join(FX, "golden_class_k1.tsv"))
    assert not os.path.exists(cfr + SERVE_CACHE_SUFFIX)


@pytest.mark.parametrize("fx", ["tiny", "tiny_single", "small"])
def test_cfr_load_matches_jax(fx):
    from centrifuger_tpu.interop.cfr import load_cfr_index as jax_load
    from centrifuger_tpu_torch.interop.cfr import load_cfr_index
    import numpy as np
    prefix = os.path.join(FIXTURE_DIR, fx, "refidx")
    (jfm, jtax, jlen, jmeta), (fm, tax, slen, meta) = jax_load(prefix), load_cfr_index(prefix)
    assert (slen, meta) == (jlen, jmeta)
    assert not hasattr(fm, "source_prefix")
    for k, v in vars(jfm).items():
        if k == "bwt":
            assert np.array_equal(fm.bwt.decode(), v.decode())
        elif isinstance(v, np.ndarray):
            assert np.array_equal(getattr(fm, k), v), k
        else:
            assert getattr(fm, k) == v, k
    for k in ("parent", "rank", "leaf", "orig_ids", "seq_id_to_tax"):
        assert np.array_equal(getattr(tax, k), getattr(jtax, k)), k
    assert (tax.names, tax.seq_names, tax.root_ctax) == (jtax.names, jtax.seq_names,
                                                         jtax.root_ctax)


# -------------------------------------------------------------- the parser

def option_strings(module):
    """Every option string of a CLI's parser (caught at parse_args)."""
    seen = []

    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        seen.append(self)
        raise Caught
    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(Caught):
            module.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return set(seen[0]._option_string_actions)


def test_parser_accepts_every_jax_option():
    from centrifuger_tpu.cli import classify_cli as jax_cli
    from centrifuger_tpu_torch.cli import classify_cli
    jax_opts, port_opts = option_strings(jax_cli), option_strings(classify_cli)
    assert port_opts - jax_opts == {"--device", "--trace-out"}
    assert jax_opts <= port_opts
