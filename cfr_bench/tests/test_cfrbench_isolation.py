"""What the benchmark runs loads neither JAX nor the JAX package, compared
by whole top-level names (the port's name begins with the JAX package's),
and the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

from cfr_bench.tests.tiny import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "centrifuger_tpu"}


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=REPO))
    return set(out.stdout.split())


def test_harness_and_port_load_no_jax():
    names = loaded("import cfr_bench.harness, cfr_bench.trace, cfr_bench.control\n"
                   "import centrifuger_tpu_torch.cli.classify_cli, centrifuger_tpu_torch.build\n"
                   "import centrifuger_tpu_torch.classify.engine, centrifuger_tpu_torch.kernels\n"
                   "import centrifuger_tpu_torch.io.fastq_fast, centrifuger_tpu_torch.io.readers\n"
                   "import centrifuger_tpu_torch.cli.build_cli")
    assert "centrifuger_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    names = loaded("import cfr_bench.reference.classify, cfr_bench.reference.index, "
                   "cfr_bench.reference.taxonomy, cfr_bench.check")
    assert not names & (FORBIDDEN | {"centrifuger_tpu_torch"})


def test_no_source_imports_jax():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else []
                for n in names:
                    top = n.split(".")[0]
                    assert top not in FORBIDDEN, (f, n)
                    if "reference" in d.split(os.sep):
                        assert top != "centrifuger_tpu_torch", (f, n)
