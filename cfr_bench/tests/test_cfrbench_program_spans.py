"""The per-layer metrics that read the port's own spans and counters
(centrifuger_tpu_torch/spans.py, ClassifierTorch.stats): a traced run of a
tiny cell on the CPU prints every one of them."""

import pytest

from cfr_bench.tests.tiny import make_root, run

PROGRAM_SPANS = ("engine.pack_us_per_read", "engine.upload_us_per_read",
                 "engine.launch_us_per_read", "engine.finish_wait_pct",
                 "finish.pull_us_per_read", "finish.fallback_us_per_read",
                 "setup.index_load_s", "setup.device_index_s")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))


def test_traced_run_reports_program_spans(root):
    rc, res = run(root, "tiny-nt.tpe", 2 ** 31 + 97, trace=1)
    assert rc == 0 and res["correct"] is True
    m = res["metrics"]
    for name in PROGRAM_SPANS:
        assert name in m, name
        if name == "finish.fallback_us_per_read":   # a window may flag no unit
            assert m[name]["value"] >= 0
        else:
            assert m[name]["value"] > 0, name
    assert m["engine.finish_wait_pct"]["value"] < 100
