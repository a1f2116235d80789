"""The port stands alone: no file of centrifuger_tpu_torch, nor chip_smoke.py,
imports jax or centrifuger_tpu; and its entry points ask for CUDA by default
and raise where there is none, instead of running on the CPU."""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "centrifuger_tpu")


def port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(REPO, "centrifuger_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = port_files()
    assert len(files) > 20
    rel = {os.path.relpath(p, REPO) for p in files}
    assert {"centrifuger_tpu_torch/classify/finalize.py",
            "centrifuger_tpu_torch/classify/engine_unfused.py",
            "centrifuger_tpu_torch/tools/micro_gather.py",
            "centrifuger_tpu_torch/fm/sa_external.py",
            "centrifuger_tpu_torch/interop/cfr_write.py",
            "centrifuger_tpu_torch/quant/tree.py",
            "centrifuger_tpu_torch/quant/quantifier.py",
            "centrifuger_tpu_torch/cli/quant_cli.py",
            "centrifuger_tpu_torch/cli/kreport_cli.py",
            "centrifuger_tpu_torch/cli/promote_cli.py",
            "centrifuger_tpu_torch/cli/inspect_cli.py",
            "centrifuger_tpu_torch/succinct/trees.py",
            "centrifuger_tpu_torch/succinct/csa.py",
            "centrifuger_tpu_torch/succinct/sequences.py",
            "centrifuger_tpu_torch/cli/download_cli.py",
            "centrifuger_tpu_torch/testutil.py"} <= rel
    bad = [(os.path.relpath(p, REPO), m) for p in files for m in imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_kernel_sources_exist_for_every_kernel():
    from centrifuger_tpu_torch import kernels
    csrc = os.path.join(REPO, "centrifuger_tpu_torch", "kernels", "csrc")
    assert "dep_gather" in kernels.KERNELS
    for k in kernels.KERNELS:
        with open(os.path.join(csrc, k + ".cu")) as f:
            src = f.read()
        assert 'extern "C" int %s_launch(' % k in src
        # names the JAX program (or, for K12, the Pallas probe) it replaces
        replaces = "tools/micro_gather.py" if k == "dep_gather" else "centrifuger_tpu/"
        assert replaces in src


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise")


def test_torch_fm_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    from centrifuger_tpu.testutil import synthetic_fm
    from centrifuger_tpu_torch.fm.device import TorchFM, fm_arrays
    fm, _ = synthetic_fm(n_genomes=2, genome_len=3000, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchFM(fm_arrays(fm))


def test_unfused_engine_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    from centrifuger_tpu.testutil import synthetic_fm
    from centrifuger_tpu_torch.classify.engine_unfused import ClassifierTorchUnfused
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    fm, _ = synthetic_fm(n_genomes=2, genome_len=3000, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        ClassifierTorchUnfused(fm, None, ClassifierParam())


def test_micro_gather_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    from centrifuger_tpu_torch.tools import micro_gather
    with pytest.raises(RuntimeError, match="cuda"):
        micro_gather.run()


@pytest.mark.parametrize("engine", [[], ["--engine", "jax"]])
def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path_factory, engine):
    _no_cuda()
    from test_torch_golden import port_index
    from conftest import FIXTURE_DIR
    from centrifuger_tpu_torch.cli import classify_cli
    with pytest.raises(RuntimeError, match="cuda"):
        classify_cli.main(["-x", port_index("tiny", tmp_path_factory), "-u",
                           os.path.join(FIXTURE_DIR, "tiny", "reads_1.fq")] + engine)


def test_wrappers_refuse_cpu_tensors_on_the_kernel_path():
    """kernels.launch never takes a CPU tensor: no silent fallback either way."""
    from centrifuger_tpu_torch import kernels

    class FakeFM:
        device = torch.device("cpu")
    rows = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU tensor"):
        kernels.launch("resolve_rows", FakeFM(), rows, rows.bool(), 1, rows)
    assert sum(kernels.LAUNCHES.values()) == 0
