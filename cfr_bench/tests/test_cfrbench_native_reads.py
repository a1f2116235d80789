"""io.native_read_pct: a traced run of the tiny paired cell on the CPU
reads every read through ReadFiles' native pass, and the metric gives
nothing where the port has no such counters."""

import pytest

from cfr_bench import spec
from cfr_bench.tests.tiny import BENCH, make_root, run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))


def test_traced_run_reads_all_native(root, monkeypatch):
    from centrifuger_tpu_torch import spans
    monkeypatch.setattr(spans, "_totals", {})    # this run's counts alone
    rc, res = run(root, "tiny-nt.tpe", 2 ** 31 + 23, trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["io.native_read_pct"] == {"value": 100.0, "unit": "%"}
    native = spans.totals()["io.native_reads"][1]
    assert native >= 2 * res["attempted"]          # both mates, warm-up and window
    assert "io.line_reads" not in spans.totals()


def test_nothing_without_the_counters(monkeypatch):
    from centrifuger_tpu_torch import spans
    monkeypatch.setattr(spans, "_totals", {})
    reader = spec.metric_reader("io.native_read_pct", BENCH)
    assert reader.read(None) is None
    spans.count("io.line_reads", 3)
    spans.count("io.native_reads", 9)
    assert reader.read(None) == 75.0
