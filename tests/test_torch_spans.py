"""The port's spans and counters (centrifuger_tpu_torch/spans.py) on the CPU:
every serving loop of ClassifierTorch fills each stage's seconds and the
batch count, the finish workers' counts are exact, the records nest by thread
and batch, the Chrome trace loads, and the TSV does not change with spans
on (cfr-classify-torch --trace-out against the goldens)."""

import contextlib
import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import FIXTURE_DIR

from centrifuger_tpu_torch import spans
from centrifuger_tpu_torch.classify.engine import (ENGINE_STAGES, FINISH_STAGES,
                                                   STAGES)

torch.set_num_threads(1)   # the suite runs in several worker processes

TINY = os.path.join(FIXTURE_DIR, "tiny")
GROUPS = ("engine.dispatch", "finish.batch")   # recorded only, no counter


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    from centrifuger_tpu_torch.build import build_index
    out = str(tmp_path_factory.mktemp("spans_tiny") / "idx")
    with contextlib.redirect_stderr(io.StringIO()):
        build_index([os.path.join(TINY, "ref.fa")], os.path.join(TINY, "nodes.dmp"),
                    os.path.join(TINY, "names.dmp"), os.path.join(TINY, "ref_seqid.map"),
                    conversion_at_file_level=False, output_prefix=out)
    return out


def make(prefix, **param):
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    from centrifuger_tpu_torch.cli.classify_cli import make_classifier
    fm, tax, _, _ = load_index(prefix)
    return make_classifier(fm, tax, ClassifierParam(**param), False, "fused", device="cpu")


@pytest.fixture(scope="module")
def queries():
    from centrifuger_tpu_torch.io.readers import ReadFiles
    r1, r2 = ReadFiles(), ReadFiles()
    r1.add_read_file(os.path.join(TINY, "reads_1.fq"))
    r2.add_read_file(os.path.join(TINY, "reads_2.fq"))
    return [(np.frombuffer(a.seq.encode(), np.uint8), np.frombuffer(b.seq.encode(), np.uint8))
            for a, b in zip(r1, r2)]


@pytest.fixture
def spans_off():
    spans.enable()
    spans.enable(False)      # an empty record list, nothing kept
    yield
    spans.enable(False)


def batches_of(queries, n):
    return [queries[i:i + n] for i in range(0, len(queries), n)]


def run_loop(c, loop, queries, n):
    """Drive one serving loop over the fixture's reads in batches of n;
    returns (the batches run, reads)."""
    bs = batches_of(queries, n)
    if loop == "query_pipelined_packed":
        out = list(c.query_pipelined_packed(bs))
        assert [len(q) for _, _, q in out] == [len(b) for b in bs]
    elif loop == "query_pipelined":
        out = list(c.query_pipelined(bs))
        assert [len(r) for r in out] == [len(b) for b in bs]
    else:
        out = list(c.serve_tsv_prepacked(c.iter_prepacked(os.path.join(TINY, "reads_1.fq"), n)))
        assert sum(nq for _, _, nq in out) == len(queries)
    return len(bs), len(queries)


LOOPS = ["query_pipelined_packed", "query_pipelined", "serve_tsv_prepacked"]


@pytest.mark.parametrize("loop", LOOPS)
def test_loops_fill_every_stage_counter(prefix, queries, spans_off, loop):
    c = make(prefix)
    nb, reads = run_loop(c, loop, queries, 16)
    st = c.stats
    assert st["batches"] == nb
    assert not any(k.endswith("_n") for k in st)
    assert not any(g + "_s" in st for g in GROUPS)
    for name in STAGES:
        assert st[name + "_s"] >= 0.0, name
    ran = {"engine.upload", "engine.launch", "engine.finish_wait",
           "finish.pull", "finish.fallback"}
    ran |= {"finish.format"} if loop == "serve_tsv_prepacked" else {"engine.pack"}
    for name in STAGES:
        assert (st[name + "_s"] > 0) == (name in ran), name
    assert st["fast_units"] + st["fallback_units"] == reads
    assert spans.records() == []


def test_unfused_batches_count_as_batches(prefix, queries, spans_off):
    """-k 0 takes the non-fused engine: engine.unfused a batch, every other
    stage 0 s, the units counted as before."""
    c = make(prefix, max_result=0)
    bs = batches_of(queries, 32)
    list(c.query_pipelined_packed(bs))
    st = c.stats
    assert st["batches"] == len(bs) and st["engine.unfused_s"] > 0
    for name in STAGES:
        assert (st[name + "_s"] > 0) == (name == "engine.unfused"), name
    assert st["fast_units"] + st["slow_units"] == len(queries)


def test_finish_workers_count_exactly(prefix, queries, spans_off):
    """Batches of one pair through the four finish workers, the interpreter
    switching threads as often as it can: the pipelined counts equal the
    serial ones, unit for unit."""
    serial, piped = make(prefix), make(prefix)
    bs = batches_of(queries, 1)
    for b in bs:
        serial.query_batch(b)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        list(piped.query_pipelined_packed(bs))
    finally:
        sys.setswitchinterval(old)
    for key in ("fast_units", "fallback_units", "batches"):
        assert piped.stats[key] == serial.stats[key], key
    assert piped.stats["fast_units"] + piped.stats["fallback_units"] == len(queries)
    assert serial.stats["fallback_units"] > 0
    assert piped.stats["batches"] == len(bs)


def test_finish_lets_the_device_outputs_go_before_the_fallback(prefix, queries, monkeypatch):
    """finish_packed takes the batch's device outputs out of its ctx and
    holds none of them through the fallback's host work, so that a faster
    reader's next batches do not find them still allocated."""
    import weakref
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    c = make(prefix)
    ctx = c._dispatch_fused(queries)
    held = [weakref.ref(ctx["out"][k]) for k in ("hits", "nhits", "host_blob")]
    seen = []
    orig = ClassifierTorch._finish_fallback_units

    def spy(self, *args):
        seen.append([r() is None for r in held])
        return orig(self, *args)
    monkeypatch.setattr(ClassifierTorch, "_finish_fallback_units", spy)
    packed, fb = c.finish_packed(ctx)
    assert seen == [[True, True, True]] and "out" not in ctx and fb
    assert ctx["released"].is_set()
    ref = make(prefix)
    want_packed, want_fb = ref.finish_packed(ref._dispatch_fused(queries))
    assert np.array_equal(packed, want_packed) and sorted(fb) == sorted(want_fb)


def test_dispatch_waits_for_the_last_batch_to_let_its_outputs_go(prefix, queries, monkeypatch):
    """A finish worker slow to pull: each pipelined batch's upload starts
    only after the batch before it has pulled its outputs and let the
    device ones go."""
    import time
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    orig = ClassifierTorch._pull_results

    def slow_pull(self, out):
        time.sleep(0.05)
        return orig(self, out)
    monkeypatch.setattr(ClassifierTorch, "_pull_results", slow_pull)
    c = make(prefix)
    bs = batches_of(queries, 4)[:4]
    spans.enable()
    try:
        got = list(c.query_pipelined_packed(bs))
    finally:
        spans.enable(False)
    rec = spans.records()
    pulled = {r.batch: r.t1 for r in rec if r.name == "finish.pull"}
    uploads = {r.batch: r.t0 for r in rec if r.name == "engine.upload"}
    assert len(got) == len(bs) and len(uploads) == len(bs)
    for b in sorted(uploads)[1:]:
        assert uploads[b] >= pulled[b - 1], b


def test_stats_lock_loses_no_update(prefix):
    """Eight threads adding to stats at once, as the finish workers do."""
    c = make(prefix)
    per, n_threads = 2000, 8
    seconds = dict.fromkeys(STAGES, 0.5)

    def add():
        for _ in range(per):
            c._add_stats(seconds, FINISH_STAGES, fast_units=1, fallback_units=2, batches=1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = per * n_threads
    assert c.stats["fast_units"] == total and c.stats["fallback_units"] == 2 * total
    assert c.stats["batches"] == total
    for name in FINISH_STAGES:
        assert c.stats[name + "_s"] == 0.5 * total


NEST = {"engine.pack": "engine.dispatch", "engine.upload": "engine.dispatch",
        "engine.launch": "engine.dispatch", "finish.pull": "finish.batch",
        "finish.fallback": "finish.batch", "finish.format": "finish.batch"}


@pytest.mark.parametrize("loop", ["query_pipelined_packed", "serve_tsv_prepacked"])
def test_records_nest_and_share_batches(prefix, queries, loop):
    c = make(prefix)
    spans.enable()
    try:
        nb, _ = run_loop(c, loop, queries, 16)
        recs = spans.records()
    finally:
        spans.enable(False)
    serving = threading.current_thread().name
    by = {}
    for r in recs:
        by.setdefault(r.batch, {}).setdefault(r.name, []).append(r)
    assert sorted(by) == list(range(nb))
    want = (set(STAGES) | set(GROUPS)) - {"engine.unfused"}
    want -= {"engine.pack"} if loop == "serve_tsv_prepacked" else {"finish.format"}
    for b, named in by.items():
        assert set(named) == want, b
        assert all(len(v) == 1 for v in named.values()), b
        r = {k: v[0] for k, v in named.items()}
        for name in ENGINE_STAGES + ("engine.dispatch",):
            if name in r:
                assert r[name].thread == serving, name
        workers = {r[name].thread for name in FINISH_STAGES + ("finish.batch",) if name in r}
        assert len(workers) == 1 and workers.pop().startswith("finish"), b
        for child, parent in NEST.items():
            if child in r:
                assert r[child].parent == parent, child
                assert r[parent].t0 <= r[child].t0 <= r[child].t1 <= r[parent].t1, child
        for top in ("engine.dispatch", "engine.finish_wait", "finish.batch"):
            assert r[top].parent is None, top
        assert r["engine.dispatch"].t1 <= r["finish.batch"].t0
        assert r["finish.batch"].t1 <= r["engine.finish_wait"].t1


def test_chrome_trace_loads(prefix, queries, tmp_path):
    c = make(prefix)
    spans.enable()
    try:
        run_loop(c, "query_pipelined_packed", queries, 16)
        path = str(tmp_path / "trace.json")
        spans.write_chrome_trace(path)
        n = len(spans.records())
    finally:
        spans.enable(False)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    done = [e for e in events if e["ph"] == "X"]
    assert len(done) == n
    assert {e["name"] for e in done} == \
        (set(STAGES) | set(GROUPS)) - {"engine.unfused", "finish.format"}
    threads = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert threading.current_thread().name in threads
    assert any(t.startswith("finish") for t in threads)
    assert all(e["dur"] >= 0 and "batch" in e["args"] for e in done)


def test_setup_spans_count_into_totals(prefix):
    before = spans.totals()
    make(prefix)
    after = spans.totals()
    for name in ("load.index", "load.device_index"):
        s0, n0 = before.get(name, (0.0, 0))
        s1, n1 = after[name]
        assert n1 == n0 + 1 and s1 > s0, name


def cli(prefix, args, trace=None):
    from centrifuger_tpu_torch.cli import classify_cli
    buf, err = io.StringIO(), io.StringIO()
    extra = ["--trace-out", trace] if trace else []
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        assert classify_cli.main(["-x", prefix, "--device", "cpu", "--batch-size", "16"]
                                 + args + extra) == 0
    return buf.getvalue(), err.getvalue()


@pytest.mark.parametrize("route,args", [
    ("packed", ["-1", os.path.join(TINY, "reads_1.fq"), "-2", os.path.join(TINY, "reads_2.fq")]),
    ("bulk", ["-u", os.path.join(FIXTURE_DIR, "tiny_single", "reads_1.fq")])])
def test_cli_tsv_same_with_spans_on(prefix, tmp_path, route, args):
    """The TSV byte for byte with --trace-out and without; the paired one is
    the reference's golden.  The trace holds the load and the batches' spans,
    and the last log line each stage's microseconds a read."""
    path = str(tmp_path / "trace.json")
    on, err = cli(prefix, args, path)
    off, _ = cli(prefix, args)
    assert on == off
    if route == "packed":
        with open(os.path.join(TINY, "golden_class_k1.tsv")) as f:
            assert on == f.read()
    kept = len(spans.records())
    with spans.span("a test's span"):    # the CLI turned the records off
        pass
    assert len(spans.records()) == kept
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e["ph"] == "X"}
    assert {"load.index", "load.device_index", "engine.dispatch", "finish.batch"} <= names
    assert ("finish.format" in names) == (route == "bulk")
    line = [ln for ln in err.splitlines() if "Device units:" in ln][-1]
    for name in STAGES:
        assert " %s " % name in line, name
    for name in GROUPS:
        assert name not in line, name


def test_cli_line_gives_the_native_read_share(prefix, monkeypatch):
    """The CLI's closing line says how many of ReadFiles' reads its native
    pass gave (io.native_reads against io.line_reads)."""
    monkeypatch.setattr(spans, "_totals", {})
    _, err = cli(prefix, ["-1", os.path.join(TINY, "reads_1.fq"),
                          "-2", os.path.join(TINY, "reads_2.fq")])
    with open(os.path.join(TINY, "reads_1.fq")) as f:
        n = 2 * (sum(1 for _ in f) // 4)
    line = [ln for ln in err.splitlines() if "Device units:" in ln][-1]
    assert line.endswith("; reads parsed natively: 100.0%% (%d of %d)" % (n, n))
