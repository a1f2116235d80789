"""The control (the reference with float16 scores in the program's place)
goes through the run's own check and comes out as not correct on three
seeds; at the cells' own sizes it runs on the card (marked cuda)."""

import json

import pytest

from cfr_bench import control, spec
from cfr_bench.tests.tiny import REPO, make_root

SEEDS = [11, 2 ** 31 + 5, 987654321]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))


def _fails(cell, device):
    got = control.readings(cell, SEEDS, 50 * int(cell.traffic["check_reads"]), device)
    assert all(correct is False for _, correct in got.values()), got
    assert all(nums["rows_differ"][0] > 0 and nums["order_faults"][0] == 0
               for nums, _ in got.values()), got


@pytest.mark.parametrize("cell", ["tiny-nt.tpe", "tiny-nt.tse", "tiny-aa.tpe", "tiny-nt.tont"])
def test_control_fails_at_tiny_size(root, cell):
    _fails(spec.Cell(cell, root), "cpu")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at a cell's own size")
    return "cuda"


with open(REPO + "/BENCHMARK.json") as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(card, cell):
    _fails(spec.Cell(cell), card)
