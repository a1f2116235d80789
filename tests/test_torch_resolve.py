"""K2 (SA resolve): the port's plain version against centrifuger_tpu's
DeviceFM.resolve_rows and the host LF walk, with and without a rowmap."""

import numpy as np
import pytest
import torch

from centrifuger_tpu.build import load_index
from centrifuger_tpu.fm.device import DeviceFM
from centrifuger_tpu_torch.fm.device import TorchFM, fm_arrays, resolve_rows

from test_golden_classify import get_index

torch.set_num_threads(1)   # the suite runs in several worker processes


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    fm = load_index(get_index("tiny", tmp_path_factory))[0]
    assert fm.rowmap is not None
    return fm


@pytest.mark.parametrize("rowmap", [True, False])
def test_resolve_every_row(tiny, rowmap):
    fm = tiny
    fields = fm_arrays(fm)
    if not rowmap:
        fields["rowmap"] = None
    tfm = TorchFM(fields, device="cpu")
    rows = np.arange(fm.n, dtype=np.int64)
    want = fm.resolve_rows(rows)
    got = resolve_rows(tfm, torch.from_numpy(rows.astype(np.int32)),
                       torch.ones(fm.n, dtype=torch.bool)).numpy()
    assert np.array_equal(got, want)
    saved = fm.rowmap
    try:
        if not rowmap:
            fm.rowmap = None
        jax_got = np.asarray(DeviceFM(fm).resolve_rows(rows, np.ones(fm.n, bool)))
    finally:
        fm.rowmap = saved
    assert np.array_equal(got, jax_got)


@pytest.mark.parametrize("rowmap", [True, False])
def test_resolve_masks_invalid_lanes(tiny, rowmap):
    fields = fm_arrays(tiny)
    if not rowmap:
        fields["rowmap"] = None
    tfm = TorchFM(fields, device="cpu")
    rng = np.random.default_rng(4)
    rows = rng.integers(0, tiny.n, 512).astype(np.int32)
    valid = rng.random(512) < 0.7
    got = resolve_rows(tfm, torch.from_numpy(rows), torch.from_numpy(valid)).numpy()
    want = np.where(valid, tiny.resolve_rows(rows.astype(np.int64)), 0)
    assert np.array_equal(got, want)


def test_wrapper_checks_arguments(tiny):
    tfm = TorchFM(fm_arrays(tiny), device="cpu")
    with pytest.raises(TypeError):
        resolve_rows(tfm, torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        resolve_rows(tfm, torch.zeros(4, dtype=torch.int32), torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        resolve_rows(tfm, torch.zeros(8, dtype=torch.int32)[::2],
                     torch.ones(4, dtype=torch.bool))
