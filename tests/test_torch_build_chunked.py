"""The port's memory-bounded chunked builder (fm/sa_external.py, native/
sa_chunked.cpp, fm/builder.py:build_fm_streaming) against the JAX package's:
the same suffix-array chunk stream, the same index arrays as the SA-IS build
and as the JAX chunked build, the same logs and MemoryError, checkpoints that
resume across packages, and no SA-IS fallback when the toolchain fails."""

import contextlib
import ctypes
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from centrifuger_tpu_torch.fm.builder import BMAX_FLOOR
from conftest import FIXTURE_DIR
from test_golden_classify import assert_tsv_equal

RNG_SEED = 1234
FIXTURES = {"tiny": False, "small": False, "tiny_protein": True}
CONFIGS = {
    "t3_bmax2048_dcv64": dict(threads=3, bmax=2048, dcv=64),
    "t2_mem2g": dict(threads=2, build_mem=2 << 30),
    "t1_bmax512_dcv64": dict(threads=1, bmax=512, dcv=64),
    "threshold": {},
}


def jax_native(name, tmp_path_factory):
    """The JAX package's native library `name`, compiled by this process into
    a directory of its own and handed to the JAX loader: that loader writes
    its .so in place beside the source, where another test process may be
    loading it meanwhile."""
    from centrifuger_tpu import native as jax_native_mod
    with jax_native_mod._LOCK:
        if jax_native_mod._LIBS.get(name) is None:
            src = os.path.join(os.path.dirname(jax_native_mod.__file__), name + ".cpp")
            out = str(tmp_path_factory.mktemp("jax_native") / ("lib%s.so" % name))
            subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            "-std=c++17", "-pthread", "-o", out, src],
                           check=True, capture_output=True)
            jax_native_mod._LIBS[name] = ctypes.CDLL(out)
        return jax_native_mod._LIBS[name]


@pytest.fixture(scope="module", autouse=True)
def _jax_sa_chunked(tmp_path_factory):
    jax_native("sa_chunked", tmp_path_factory)


def _chunk_stream(cls, codes, sigma, **kw):
    cs = cls(codes, sigma, **kw)
    out = [(ci, row0, part.copy()) for ci, row0, part in cs]
    cs.close()
    return out


def _assert_streams_equal(codes, sigma, **kw):
    from centrifuger_tpu.fm.sa_external import ChunkedSA as JaxChunkedSA
    from centrifuger_tpu_torch.fm.sa_external import ChunkedSA
    from centrifuger_tpu_torch.fm.suffix_array import suffix_array
    ours = _chunk_stream(ChunkedSA, codes, sigma, **kw)
    theirs = _chunk_stream(JaxChunkedSA, codes, sigma, **kw)
    assert len(ours) == len(theirs)
    for (ci, r, p), (cj, s, q) in zip(ours, theirs):
        assert (ci, r) == (cj, s)
        assert np.array_equal(p, q)
    sa = np.concatenate([p for _, _, p in ours])
    assert np.array_equal(sa, suffix_array(codes, sigma))


@pytest.mark.parametrize("n,dcv,bmax,threads", [
    (1000, 16, 256, 1),
    (5000, 64, 512, 2),
    (20000, 256, 4096, 3),
])
def test_chunked_sa_stream_random_dna(n, dcv, bmax, threads):
    codes = np.random.default_rng(RNG_SEED + n).integers(0, 4, n).astype(np.uint8)
    _assert_streams_equal(codes, 4, dcv=dcv, bmax=bmax, threads=threads, kprefix=6)


@pytest.mark.parametrize("n,dcv,bmax,threads", [(4000, 64, 512, 2), (9000, 16, 2048, 3)])
def test_chunked_sa_stream_random_protein(n, dcv, bmax, threads):
    codes = np.random.default_rng(RNG_SEED + n).integers(0, 22, n).astype(np.uint8)
    _assert_streams_equal(codes, 22, dcv=dcv, bmax=bmax, threads=threads, kprefix=3)


def test_chunked_sa_stream_repetitive():
    codes = np.tile(np.array([0, 1, 2, 3, 0, 0, 1, 1], np.uint8), 800)
    _assert_streams_equal(codes, 4, dcv=16, bmax=1024, threads=3, kprefix=5)


def test_chunked_sa_stream_overweight_kmer():
    rng = np.random.default_rng(RNG_SEED)
    codes = np.concatenate([np.zeros(3000, np.uint8),
                            rng.integers(0, 4, 3000).astype(np.uint8)])
    _assert_streams_equal(codes, 4, dcv=64, bmax=128, threads=2, kprefix=4)


def test_chunked_sa_default_kprefix_and_plan_match_jax():
    from centrifuger_tpu.fm.sa_external import ChunkedSA as JaxChunkedSA
    from centrifuger_tpu_torch.fm.sa_external import ChunkedSA
    codes = np.random.default_rng(RNG_SEED).integers(0, 4, 30000).astype(np.uint8)
    a, b = ChunkedSA(codes, 4, bmax=1000), JaxChunkedSA(codes, 4, bmax=1000)
    try:
        assert a.k == b.k
        assert a.plan_chunks() == b.plan_chunks()
    finally:
        a.close()
        b.close()


# ------------------------------------------------------------ whole builds

def _fixture_args(fx):
    d = os.path.join(FIXTURE_DIR, fx)
    return ([os.path.join(d, "ref.fa")], os.path.join(d, "nodes.dmp"),
            os.path.join(d, "names.dmp"), os.path.join(d, "ref_seqid.map"))


def _messages(text):
    """The build log without its timestamps and the native compile notes."""
    out = []
    for line in text.splitlines():
        if line.startswith("[native]"):
            continue
        out.append(re.sub(r"^\[[A-Z][a-z]{2} [A-Z][a-z]{2} [ \d]\d [\d:]{8} \d{4}\] ", "",
                          line))
    return out


def _build(pkg, fx, prefix, **kw):
    if pkg == "jax":
        from centrifuger_tpu.build import build_index
    else:
        from centrifuger_tpu_torch.build import build_index
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        build_index(*_fixture_args(fx), conversion_at_file_level=False,
                    output_prefix=prefix, protein=FIXTURES[fx], **kw)
    return _messages(err.getvalue())


def _assert_index_equal(a, b):
    for ext in (".fm.npz", ".rowmap.npz"):
        assert os.path.exists(a + ext) == os.path.exists(b + ext), ext
        if not os.path.exists(a + ext):
            continue
        za, zb = np.load(a + ext), np.load(b + ext)
        assert sorted(za.files) == sorted(zb.files), ext
        for k in za.files:
            assert np.array_equal(za[k], zb[k]), (ext, k)


@pytest.fixture(scope="module")
def sais_index(tmp_path_factory):
    """Each fixture's SA-IS build by the port, once per module."""
    cache = {}

    def get(fx):
        if fx not in cache:
            cache[fx] = str(tmp_path_factory.mktemp("sais_" + fx) / "idx")
            _build("port", fx, cache[fx])
        return cache[fx]
    return get


# The port's --build-mem line (fm/builder.py:build_memory counts every array
# alive at the build's peak) beside the JAX package's (2n + DC ranks + ftab +
# 256 MB, bmax from threads * 24 bytes a row): the same bmax, other byte counts.
BUILD_MEM_LINES = {
    "tiny": ("build-mem 2147483648: using bmax=16777216 (fixed state ~127093824, "
             "peak ~129397824)",
             "build-mem 2147483648: using bmax=16777216 (fixed state ~293673408)"),
    "small": ("build-mem 2147483648: using bmax=16777216 (fixed state ~127688176, "
              "peak ~136328176)",
              "build-mem 2147483648: using bmax=16777216 (fixed state ~293871760)"),
    "tiny_protein": ("build-mem 2147483648: using bmax=16777216 (fixed state ~126958776, "
                     "peak ~127823064)",
                     "build-mem 2147483648: using bmax=16777216 (fixed state ~293628336)"),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("fx", sorted(FIXTURES))
def test_chunked_build_matches_sais_and_jax(tmp_path, monkeypatch, sais_index, fx, config):
    kw = CONFIGS[config]
    if config == "threshold":
        monkeypatch.setenv("CFR_CHUNKED_BUILD_THRESHOLD", "1000")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    log_ours = _build("port", fx, ours, **kw)
    log_theirs = _build("jax", fx, theirs, **kw)
    assert any(m.startswith("chunk plan:") for m in log_ours)
    if config == "t2_mem2g":
        port_line, jax_line = BUILD_MEM_LINES[fx]
        assert [m for m in log_ours if m.startswith("build-mem ")] == [port_line]
        assert [m for m in log_theirs if m.startswith("build-mem ")] == [jax_line]
        log_ours = [m for m in log_ours if m != port_line]
        log_theirs = [m for m in log_theirs if m != jax_line]
    assert log_ours == log_theirs
    _assert_index_equal(ours, sais_index(fx))
    _assert_index_equal(ours, theirs)


def test_chunked_build_mem_too_small_raises_jax_message(tmp_path):
    """The same MemoryError as the JAX package's, with the port's count of
    the bytes the build needs at its smallest bmax (the JAX package says
    ~293673408 here)."""
    errs = []
    for pkg in ("port", "jax"):
        with pytest.raises(MemoryError) as e:
            _build(pkg, "tiny", str(tmp_path / pkg), build_mem=1 << 20, threads=2)
        errs.append(str(e.value))
    assert errs[0] == ("--build-mem 1048576 too small: fixed state needs ~129269824 bytes; "
                       "increase the budget or increase --dcv")
    assert errs[1] == ("--build-mem 1048576 too small: fixed state needs ~293673408 bytes; "
                       "increase the budget or increase --dcv")


def _interrupting(monkeypatch, builder_module, at_call):
    real_add = builder_module._StreamAccum.add
    calls = {"n": 0}

    def add(self, row0, sa):
        real_add(self, row0, sa)
        calls["n"] += 1
        if calls["n"] == at_call:
            raise KeyboardInterrupt()
    monkeypatch.setattr(builder_module._StreamAccum, "add", add)
    return real_add


@pytest.mark.parametrize("first", ["port", "jax"])
def test_chunked_checkpoint_resumes_across_packages(tmp_path, monkeypatch, sais_index, first):
    """A build interrupted past its first ~10% state checkpoint (by the port
    or by the JAX package) restarts in the port from the same files and gives
    the SA-IS arrays; the state files are gone afterwards.  The DC ranks
    resume from either package; the state resumes from the port's own file,
    and a JAX-written one (it records no chunk plan) starts the chunk pass
    afresh."""
    from centrifuger_tpu_torch.fm import builder
    from centrifuger_tpu.fm import builder as jax_builder
    mod = builder if first == "port" else jax_builder
    prefix = str(tmp_path / "ck")
    kw = dict(checkpoint=True, threads=1, bmax=512, dcv=64)
    real_add = _interrupting(monkeypatch, mod, 30)
    with pytest.raises(KeyboardInterrupt):
        _build(first, "tiny", prefix, **kw)
    monkeypatch.setattr(mod._StreamAccum, "add", real_add)
    for suffix in ("_checkpoint_state.npz", "_checkpoint.json", "_checkpoint_dc.npy"):
        assert os.path.exists(prefix + suffix), suffix
    log = _build("port", "tiny", prefix, **kw)
    assert "resumed DC sample ranks from checkpoint" in log
    resumed = [m for m in log if m.startswith("resuming build at chunk ")]
    if first == "port":
        assert resumed and int(resumed[0].split()[-1]) > 0
    else:
        assert not resumed
        assert "checkpoint state records no chunk plan; starting fresh" in log
    for suffix in ("_checkpoint_state.npz", "_checkpoint.json", "_checkpoint_dc.npy"):
        assert not os.path.exists(prefix + suffix), suffix
    if first == "port":
        # a resumed build captures no rowmap (earlier chunks were not kept)
        assert not os.path.exists(prefix + ".rowmap.npz")
        z, want = np.load(prefix + ".fm.npz"), np.load(sais_index("tiny") + ".fm.npz")
        assert sorted(z.files) == sorted(want.files)
        for k in z.files:
            assert np.array_equal(z[k], want[k]), k
    else:
        _assert_index_equal(prefix, sais_index("tiny"))


def _assert_fm_equal(got, want):
    assert np.array_equal(got.bwt.decode(), want.bwt.decode())
    assert got.first_isa == want.first_isa
    assert np.array_equal(got.sampled_sa, want.sampled_sa)


@pytest.mark.parametrize("field,first,then", [
    ("bmax", dict(bmax=256, dcv=64), dict(bmax=1024, dcv=64)),
    ("dcv", dict(bmax=256, dcv=64), dict(bmax=256, dcv=128)),
])
def test_chunked_checkpoint_of_another_plan_starts_fresh(tmp_path, monkeypatch, field, first, then):
    """A state checkpoint resumes only under its own chunk plan: interrupted
    at --bmax 256 (or --dcv 64) and restarted at --bmax 1024 (or --dcv 128),
    the build starts afresh, names the field, and gives build_fm's arrays.
    (The JAX package resumes both at chunk 21: under the new bmax its BWT
    differs from build_fm's in 10,978 of the 20,000 rows, from row 5,376;
    the dcv case leaves the plan as it was, and it is right there.)"""
    from centrifuger_tpu_torch.fm import builder
    from centrifuger_tpu_torch.fm.builder import FMBuildParams, build_fm_streaming
    from centrifuger_tpu_torch.utils import DNA_ALPHABET
    n = 20000
    codes = np.random.default_rng(11).integers(0, 4, n).astype(np.uint8)
    prefix = str(tmp_path / "g")
    real_add = _interrupting(monkeypatch, builder, 25)
    with pytest.raises(KeyboardInterrupt):
        build_fm_streaming(codes, [n], [0], DNA_ALPHABET, FMBuildParams(),
                           checkpoint_prefix=prefix, **first)
    monkeypatch.setattr(builder._StreamAccum, "add", real_add)
    assert os.path.exists(prefix + "_checkpoint_state.npz")
    msgs = []
    got = build_fm_streaming(codes, [n], [0], DNA_ALPHABET, FMBuildParams(),
                             checkpoint_prefix=prefix, log=msgs.append, **then)
    fresh = [m for m in msgs if m.endswith("; starting fresh")]
    assert fresh == ["checkpoint state was written under another chunk plan (%s %d, now %d); "
                     "starting fresh" % (field, first[field], then[field])]
    assert not any(m.startswith("resuming build at chunk") for m in msgs)
    _assert_fm_equal(got, builder.build_fm(codes, [n], [0], DNA_ALPHABET, FMBuildParams()))


def test_chunked_checkpoint_of_another_input_is_not_resumed(tmp_path, monkeypatch):
    """The digest guard: a state file of a different text of the same length
    starts the build afresh."""
    from centrifuger_tpu_torch.fm import builder
    from centrifuger_tpu_torch.fm.builder import FMBuildParams, build_fm_streaming
    from centrifuger_tpu_torch.utils import DNA_ALPHABET
    n = 20000
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, n).astype(np.uint8)
    b = a.copy()
    b[n // 2] = (b[n // 2] + 1) % 4
    prefix = str(tmp_path / "g")
    real_add = _interrupting(monkeypatch, builder, 25)
    with pytest.raises(KeyboardInterrupt):
        build_fm_streaming(a, [n], [0], DNA_ALPHABET, FMBuildParams(), dcv=64, bmax=256,
                           checkpoint_prefix=prefix)
    monkeypatch.setattr(builder._StreamAccum, "add", real_add)
    assert os.path.exists(prefix + "_checkpoint_state.npz")
    msgs = []
    got = build_fm_streaming(b, [n], [0], DNA_ALPHABET, FMBuildParams(), dcv=64, bmax=256,
                             checkpoint_prefix=prefix, log=msgs.append)
    assert "checkpoint state does not match input; starting fresh" in msgs
    want = builder.build_fm(b, [n], [0], DNA_ALPHABET, FMBuildParams())
    assert np.array_equal(got.bwt.decode(), want.bwt.decode())
    assert got.first_isa == want.first_isa


# A child process builds a seeded random text of argv[1] symbols, either with
# build_fm_streaming under --build-mem argv[3] (argv[2] threads), sampling its
# resident set from /proc/self/statm every 2 ms (as chip_smoke.py's
# peak_rss_mb does) from the build's start to its end, or (argv[3] "sais")
# with build_fm; the index is saved at the prefix argv[4].
BUILD_MEM_CHILD = r"""
import json, os, sys, threading, time
import numpy as np
from centrifuger_tpu_torch.fm.builder import FMBuildParams, build_fm, build_fm_streaming
from centrifuger_tpu_torch.utils import DNA_ALPHABET
n, threads, budget, prefix = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
codes = np.random.default_rng(5).integers(0, 4, n).astype(np.uint8)
lens, ids = [n // 4] * 3 + [n - 3 * (n // 4)], [0, 1, 2, 3]
page = os.sysconf("SC_PAGE_SIZE")

def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * page

start = rss()
peak, stop = [start], []

def sample():
    while not stop:
        peak[0] = max(peak[0], rss())
        time.sleep(0.002)

th = threading.Thread(target=sample, daemon=True)
th.start()
msgs = []
try:
    if budget == "sais":
        fm = build_fm(codes, lens, ids, DNA_ALPHABET, FMBuildParams(row_map=True))
    else:
        fm = build_fm_streaming(codes, lens, ids, DNA_ALPHABET, FMBuildParams(row_map=True),
                                threads=threads, build_mem=int(budget), log=msgs.append)
finally:
    stop.append(1)
    th.join()
fm.save(prefix + ".fm.npz")
np.savez(prefix + ".rowmap.npz", rowmap=fm.rowmap)
print(json.dumps({"growth": peak[0] - start, "log": msgs}))
"""
BUILD_MEM_N = 12_000_000


def _build_mem_child(n, threads, budget, prefix):
    repo = os.path.dirname(os.path.dirname(FIXTURE_DIR))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", BUILD_MEM_CHILD, str(n), str(threads),
                          str(budget), prefix], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def build_mem_sais(tmp_path_factory):
    """The SA-IS index of the --build-mem test's text, built in a child."""
    prefix = str(tmp_path_factory.mktemp("build_mem") / "sais")
    _build_mem_child(BUILD_MEM_N, 1, "sais", prefix)
    return prefix


@pytest.mark.parametrize("threads,budget,bmax", [
    # the builder before this bound took this budget (bmax 6215995) and
    # peaked ~702 MiB above its start; the estimate keeps bmax at its default
    (1, 448 << 20, 1 << 24),
    # a budget that lowers bmax (that builder raised MemoryError here)
    (2, 300 << 20, None),
])
def test_chunked_build_holds_build_mem(tmp_path, build_mem_sais, threads, budget, bmax):
    """--build-mem bounds the chunked build's peak RSS growth over its
    start on a 12 Mnt text (rowmap captured), and the arrays equal the
    SA-IS build's."""
    prefix = str(tmp_path / "chunked")
    got = _build_mem_child(BUILD_MEM_N, threads, budget, prefix)
    assert 0 < got["growth"] <= budget, (got["growth"] / 2 ** 20, budget / 2 ** 20)
    lines = [m for m in got["log"] if m.startswith("build-mem ")]
    assert len(lines) == 1
    chosen = int(re.match(r"build-mem %d: using bmax=(\d+) " % budget, lines[0]).group(1))
    assert chosen == bmax if bmax else BMAX_FLOOR <= chosen < 1 << 24
    assert not any("row-map skipped" in m for m in got["log"])
    _assert_index_equal(prefix, build_mem_sais)


def test_toolchain_failure_raises_instead_of_sais(tmp_path, monkeypatch):
    """-t 2 alone picks the chunked builder; when g++ fails the build raises
    (the JAX package would quietly build with SA-IS) and writes no index."""
    from centrifuger_tpu_torch import native

    def broken(name):
        raise OSError("g++: command not found")
    monkeypatch.setattr(native, "_build_lib", broken)
    monkeypatch.setattr(native, "_LIBS", {})
    prefix = str(tmp_path / "t2")
    with pytest.raises(OSError, match="g\\+\\+"):
        _build("port", "tiny", prefix, threads=2)
    assert not os.path.exists(prefix + ".fm.npz")


def test_cli_chunked_build_classifies_to_the_golden(tmp_path):
    from centrifuger_tpu_torch.cli import build_cli, classify_cli
    d = os.path.join(FIXTURE_DIR, "tiny")
    prefix = str(tmp_path / "cli")
    with contextlib.redirect_stderr(io.StringIO()):
        assert build_cli.main(["-r", os.path.join(d, "ref.fa"),
                               "--taxonomy-tree", os.path.join(d, "nodes.dmp"),
                               "--name-table", os.path.join(d, "names.dmp"),
                               "--conversion-table", os.path.join(d, "ref_seqid.map"),
                               "-o", prefix, "-t", "2", "--bmax", "4096",
                               "--dcv", "64"]) == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert classify_cli.main(["-x", prefix, "--device", "cpu",
                                  "-1", os.path.join(d, "reads_1.fq"),
                                  "-2", os.path.join(d, "reads_2.fq")]) == 0
    assert_tsv_equal(buf.getvalue(), os.path.join(d, "golden_class_k1.tsv"))
