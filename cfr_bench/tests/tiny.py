"""A checkout of its own for the tests: BENCHMARK.json with tiny cells,
and cfr_bench/ holding the repository's data files and the tiny ones."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

TINY_NT = dict(genomes=4, genome_nt=20000, repeat_every=5000, inverted_repeat=200)
TINY_AA = dict(genomes=4, proteome_aa=6000)
TINY_SHORT = dict(batch_size=256, block_reads=64, check_reads=200)
TINY_LONG = dict(batch_size=64, block_reads=16, check_reads=16)
CELLS = {"tiny-nt.tpe": ("tiny-nt", "tpe"), "tiny-nt.tse": ("tiny-nt", "tse"),
         "tiny-aa.tpe": ("tiny-aa", "tpe"), "tiny-nt.tont": ("tiny-nt", "tont")}


def make_root(root):
    """Write the tiny checkout under `root`; returns root."""
    os.makedirs(os.path.join(root, "cfr_bench"), exist_ok=True)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, "cfr_bench", d),
                        dirs_exist_ok=True)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)

    def derive(kind, base, name, over):
        with open(os.path.join(BENCH, kind, base + ".json")) as f:
            d = json.load(f)
        d.update(over, name=name)
        with open(os.path.join(root, "cfr_bench", kind, name + ".json"), "w") as f:
            json.dump(d, f)
    derive("configs", "nt256-plain", "tiny-nt", TINY_NT)
    derive("configs", "aa128-protein", "tiny-aa", TINY_AA)
    derive("traffic", "pe150", "tpe", TINY_SHORT)
    derive("traffic", "se150", "tse", TINY_SHORT)
    derive("traffic", "ont", "tont", TINY_LONG)
    for cell, (cfg, mix) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": mix, "chips": 1,
                                   "why": "a test's tiny cell"})
        for m in bench["per_layer"]:
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run(root, cell, seed, trace=0, seconds=2):
    """One in-process run on the CPU: (exit code, result dict or None)."""
    import contextlib
    import io
    from cfr_bench.harness import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace), "--device", "cpu"], root=root)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
