"""What a cell is made of, found by name: BENCHMARK.json's entry, the
configuration's file, the traffic mix's file and the metrics' readers.

A later cell, configuration, mix or metric is a new file and a new entry;
nothing here lists them.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One BENCHMARK.json workload with its configuration and traffic mix,
    under the checkout `root` (BENCHMARK.json and cfr_bench/ of its own)."""

    def __init__(self, name, root=ROOT):
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        self.bench_dir = bench_dir = os.path.join(root, "cfr_bench")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit("no workload %r in BENCHMARK.json (have %s)"
                             % (name, ", ".join(sorted(cells))))
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = load_json(os.path.join(bench_dir, "configs",
                                             self.entry["config"] + ".json"))
        self.traffic = load_json(os.path.join(bench_dir, "traffic",
                                              self.entry["traffic"] + ".json"))

    def _applies(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self):
        """The per-layer metrics whose `workloads` list this cell."""
        return [m for m in self.bench["per_layer"] if self.name in m.get("workloads", ())]


def metric_reader(name, bench_dir):
    """The module cfr_bench/metrics/<name>.py (UNIT, LAYER, MOVES, read)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("cfr_bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
