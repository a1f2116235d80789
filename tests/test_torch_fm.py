"""The port's index buffers and wide-row primitives (the plain twins of the
kernels' __device__ functions) against centrifuger_tpu's DeviceFM and the
host FMIndexData, exactly (integer equality, zero tolerance)."""

import numpy as np
import pytest
import torch

from centrifuger_tpu.testutil import synthetic_fm
from centrifuger_tpu.fm.device import DeviceFM
from centrifuger_tpu_torch.fm.device import TorchFM, fm_arrays, WIDE_BLOCK

from test_golden_classify import get_index

torch.set_num_threads(1)   # the suite runs in several worker processes


@pytest.fixture(scope="module")
def fms():
    fm, genomes = synthetic_fm(n_genomes=3, genome_len=12000, seed=11)
    return fm, DeviceFM(fm), TorchFM(fm_arrays(fm), device="cpu"), genomes


def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int64))


def edge_positions(fm):
    """pos = -1, the rows around first_isa, pos % 1920 in {0, 1918, 1919}
    and the last row."""
    fi = fm.first_isa
    pos = [-1, 0, 1, fi - 1, fi, fi + 1, fm.n - 1, fm.n - 2]
    for r in range(fm.n // WIDE_BLOCK + 1):
        for d in (0, 1918, 1919):
            pos.append(r * WIDE_BLOCK + d)
    pos = np.array(sorted(set(p for p in pos if -1 <= p < fm.n)), np.int64)
    return pos


def test_buffers_match_device_fm(fms):
    fm, dev, tfm, _ = fms
    assert np.array_equal(tfm.rows.numpy().view(np.uint32), np.asarray(dev.plain_rows))
    flat = np.asarray(dev.ftab2w).reshape(-1)
    assert np.array_equal(tfm.ftab.numpy(), flat[:len(tfm.ftab)])
    assert not flat[len(tfm.ftab):].any()
    for name, want in (("psum", dev.psum), ("sampled_sa", dev.sampled_sa),
                       ("sel_rows", dev.sel_rows), ("sel_vals", dev.sel_vals)):
        assert np.array_equal(getattr(tfm, name).numpy(), np.asarray(want)), name
    assert (tfm.n, tfm.first_isa, tfm.last_chr, tfm.sample_rate, tfm.adjusted_sa0) == \
        (dev.n, dev.first_isa, dev.last_chr, dev.sample_rate, dev.adjusted_sa0)


@pytest.mark.parametrize("which", ["edges", "random"])
def test_rank_sym_parity(fms, which):
    fm, dev, tfm, _ = fms
    rng = np.random.default_rng(0)
    if which == "edges":
        pos = np.repeat(edge_positions(fm), 4)
        cs = np.tile(np.arange(4), len(pos) // 4)
    else:
        pos = rng.integers(-1, fm.n, 2048)
        cs = rng.integers(0, 4, 2048)
    rank, sym = tfm.rank_sym(t64(cs), t64(pos))
    jr, js = dev._plain_rank_sym(cs.astype(np.int32), pos.astype(np.int32))
    assert np.array_equal(rank.numpy(), np.asarray(jr))
    ok = pos >= 0
    assert np.array_equal(sym.numpy()[ok], np.asarray(js)[ok])
    want = np.where(pos < 0, 0, fm.bwt.rank_inclusive(cs, np.maximum(pos, 0)))
    assert np.array_equal(rank.numpy(), want)
    assert np.array_equal(sym.numpy()[ok], fm.bwt.access(pos[ok]).astype(np.int64))


@pytest.mark.parametrize("which", ["edges", "random", "same"])
def test_backward_extend_parity(fms, which):
    fm, dev, tfm, _ = fms
    rng = np.random.default_rng(1)
    if which == "edges":
        fi, lc = fm.first_isa, fm.last_chr
        sp = np.array([fi, fi, fi - 1, fi, fi + 1, 0, 1, fm.n - 1] * 4)
        ep = np.array([fi, fi + 5, fi - 1, fi + 1, fi + 1, 0, 1919, fm.n - 1] * 4)
        cs = np.repeat(np.array([lc, (lc + 1) % 4, (lc + 2) % 4, (lc + 3) % 4]), 8)
    else:
        sp = rng.integers(0, fm.n, 1024)
        ep = np.minimum(sp + rng.integers(0, 3000, 1024), fm.n - 1)
        if which == "same":
            ep = sp.copy()
        cs = rng.integers(0, 4, 1024)
    nsp, nep = tfm.backward_extend(t64(cs), t64(sp), t64(ep))
    jsp, jep = dev.backward_extend(cs.astype(np.int32), sp.astype(np.int32),
                                   ep.astype(np.int32))
    assert np.array_equal(nsp.numpy(), np.asarray(jsp))
    assert np.array_equal(nep.numpy(), np.asarray(jep))
    hsp, hep = fm.backward_extend(cs, sp, ep)
    assert np.array_equal(nsp.numpy(), hsp)
    assert np.array_equal(nep.numpy(), hep)


def test_lf_parity(fms):
    fm, dev, tfm, _ = fms
    rng = np.random.default_rng(2)
    rows = np.concatenate([edge_positions(fm)[1:], rng.integers(0, fm.n, 2048)])
    got = tfm.lf(t64(rows)).numpy()
    assert np.array_equal(got, np.asarray(dev.lf(rows.astype(np.int32))))
    assert np.array_equal(got, fm.lf(rows))


def test_sampled_value_and_stored(fms):
    fm, dev, tfm, _ = fms
    rows = np.arange(fm.n, dtype=np.int64)
    found, val = fm.get_sampled_sa(rows)
    assert np.array_equal(tfm.stored_here(t64(rows)).numpy(), found)
    assert np.array_equal(tfm.sampled_value(t64(rows)).numpy()[found], val[found])


@pytest.mark.parametrize("fx", ["tiny", "small"])
def test_load_index_of_jax_built_index(tmp_path_factory, fx):
    """The port's load_index reads centrifuger_tpu's files; both routes give
    identical buffers."""
    from centrifuger_tpu.build import load_index as load_jax
    from centrifuger_tpu_torch.build import load_index as load_torch
    prefix = get_index(fx, tmp_path_factory)
    fj = load_jax(prefix)[0]
    ft = load_torch(prefix)[0]
    a = TorchFM(fm_arrays(fj), device="cpu")
    b = TorchFM.from_index(ft, device="cpu")
    for name, buf in a.named_buffers():
        assert torch.equal(buf, getattr(b, name)), name
    assert a.rowmap is not None
    assert np.array_equal(a.rows.numpy().view(np.uint32),
                          np.asarray(DeviceFM(fj).plain_rows))
