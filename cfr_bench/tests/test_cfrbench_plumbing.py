"""The harness end to end on the CPU (--device cpu, the port's plain
versions): FIFOs, both routes, the check; and data files added by name."""

import json
import os
import shutil

import pytest

from cfr_bench.tests.tiny import BENCH, make_root, run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))


@pytest.mark.parametrize("cell", ["tiny-nt.tpe", "tiny-nt.tse", "tiny-aa.tpe"])
def test_tiny_cell_runs_through_fifos(root, cell):
    rc, res = run(root, cell, 2 ** 31 + 11, trace=0)
    assert rc == 0 and res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"reads_per_s", "host_rss_gib", "setup_s"}   # no device metric
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    assert all(v["value"] == 0 for v in res["checks"].values())


def test_traced_run_reports_host_layers(root):
    rc, res = run(root, "tiny-nt.tpe", 8, trace=1)
    assert rc == 0 and res["correct"] is True
    m = res["metrics"]
    for name in ("io.parse_us_per_read", "io.reader_wait_pct", "engine.us_per_read",
                 "format.us_per_read"):
        assert m[name]["value"] > 0
    assert "device.idle_pct" not in m and "kernels.ms_per_kread" not in m
    assert "busy_s" not in res["device"]


def test_new_files_are_found_by_name(root, tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files
    and entries, with no edit to any file that was there."""
    new = str(tmp_path / "checkout2")
    shutil.copytree(root, new, ignore=shutil.ignore_patterns("_cache"))
    before = {p: open(os.path.join(BENCH, p)).read() for p in
              ("configs/nt256-plain.json", "traffic/pe150.json", "metrics/reads_per_s.py")}
    with open(os.path.join(new, "cfr_bench", "configs", "tiny-nt.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny-nt2", genomes=6)
    with open(os.path.join(new, "cfr_bench", "configs", "tiny-nt2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(new, "cfr_bench", "traffic", "tpe.json")) as f:
        mix = json.load(f)
    mix.update(name="tpe-short", read_len=100, fragment={"mean": 200, "sd": 20})
    with open(os.path.join(new, "cfr_bench", "traffic", "tpe-short.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(new, "cfr_bench", "metrics", "io.reads_parsed.py"), "w") as f:
        f.write('UNIT, LAYER, MOVES = "reads", "read parse", "reads_per_s"\n\n\n'
                'def read(run):\n    return run.spans.parsed or None\n')
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny-nt2.tpe-short", "config": "tiny-nt2",
                               "traffic": "tpe-short", "chips": 1, "why": "added by a test"})
    bench["per_layer"].append({"name": "io.reads_parsed", "unit": "reads", "better": "higher",
                               "source": "program_span", "layer": "read parse",
                               "moves": "reads_per_s", "workloads": ["tiny-nt2.tpe-short"]})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, res = run(new, "tiny-nt2.tpe-short", 3, trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"] == {"io.reads_parsed": {"value": res["metrics"]["io.reads_parsed"]["value"],
                                                  "unit": "reads"}}
    assert res["metrics"]["io.reads_parsed"]["value"] >= res["attempted"]
    assert os.path.isdir(os.path.join(new, "cfr_bench", "_cache"))
    after = {p: open(os.path.join(BENCH, p)).read() for p in before}
    assert after == before
