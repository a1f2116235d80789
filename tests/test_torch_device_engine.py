"""The port's fused_classify (K1 + K4 chains, K3 finalize with K2 inline)
against centrifuger_tpu's DeviceFM.fused_classify: every output array and
the host_blob bit-identical, for nr = 1 and 2 at k = 1, 2 and 5, on an index
built so that units take the FLAG_ADJUST and FLAG_ROW_OVERFLOW paths and
surface more best seqids than k_out."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from centrifuger_tpu.fm.builder import FMBuildParams, build_fm
from centrifuger_tpu.fm.device import DeviceFM
from centrifuger_tpu_torch.classify import device_engine as de
from centrifuger_tpu_torch.fm.device import TorchFM, fm_arrays

from test_torch_kernels import pack_reads

torch.set_num_threads(1)   # the suite runs in several worker processes

MHL = 22
HITK = 40


def family_genomes(seed):
    """A random genome with inverted repeats (both-strand hits), a family of
    ten near-identical copies of a second one (many best seqids, more SA
    rows than the unit budget), and two unrelated genomes."""
    rng = np.random.default_rng(seed)
    g0 = rng.integers(0, 4, 6000).astype(np.uint8)
    for _ in range(4):
        a, b = rng.integers(0, 5600, 2)
        g0[b:b + 300] = 3 - g0[a:a + 300][::-1]
    base = rng.integers(0, 4, 3000).astype(np.uint8)
    fam = []
    for _ in range(10):
        g = base.copy()
        pos = rng.integers(0, 3000, 6)
        g[pos] = rng.integers(0, 4, 6)
        fam.append(g)
    return [g0] + fam + [rng.integers(0, 4, 4000).astype(np.uint8) for _ in range(2)]


def sample_units(genomes, n, nr, seed):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for _ in range(n * nr):
        u = rng.random()
        g = genomes[0] if u < 0.35 else \
            genomes[rng.integers(1, 11)] if u < 0.6 else \
            genomes[rng.integers(11, 13)] if u < 0.9 else \
            rng.integers(0, 4, 500).astype(np.uint8)
        ln = int(rng.integers(30, 150))
        p = int(rng.integers(0, len(g) - ln))
        frag = g[p:p + ln].copy()
        if rng.random() < 0.5:
            frag = (3 - frag)[::-1]
        err = rng.random(ln) < 0.01
        frag[err] = rng.integers(0, 4, int(err.sum()))
        b = acgt[frag].copy()
        b[rng.random(ln) < 0.005] = ord("N")
        reads.append(b)
    return reads


@pytest.fixture(scope="module")
def index():
    genomes = family_genomes(21)
    codes = np.concatenate(genomes)
    fm = build_fm(codes, [len(g) for g in genomes], np.arange(len(genomes)), "ACGT",
                  FMBuildParams(row_map=True))
    return fm, genomes


def run_both(index, nr, k, k_out, rowmap, seed):
    fm, genomes = index
    saved = fm.rowmap
    if not rowmap:
        fm.rowmap = None
    try:
        dev = DeviceFM(fm)
        tfm = TorchFM(fm_arrays(fm), device="cpu")
    finally:
        fm.rowmap = saved
    Q = 96
    reads = sample_units(genomes, Q, nr, seed)
    L = 192
    H = L // (MHL + 1) + 1
    pack2, vmask, lengths = pack_reads(reads, L)
    got = de.fused_classify(tfm, torch.from_numpy(pack2), torch.from_numpy(vmask),
                            torch.from_numpy(lengths), nr, MHL, H, k, HITK, k_out,
                            Q * de.U_CAP)
    want = dev.fused_classify((jnp.asarray(pack2), jnp.asarray(vmask)),
                              jnp.asarray(lengths), nr, MHL, H, k, HITK, k_out,
                              Q * de.U_CAP)
    return got, want


def assert_same(got, want):
    for key in ("packed", "hits", "nhits", "fb_units", "fb_hits", "fb_nh", "host_blob"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        assert np.array_equal(g, w), key


@pytest.mark.parametrize("nr", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_fused_classify_matches_jax(index, nr, k):
    got, want = run_both(index, nr, k, 8, True, seed=10 * k + nr)
    assert_same(got, want)
    flags = got["packed"][:, 4].numpy()
    assert (flags & de.FLAG_ADJUST).any()
    assert (flags & de.FLAG_ROW_OVERFLOW).any()
    assert (got["packed"][:, 3] > 1).any()
    assert (flags == 0).sum() > len(flags) // 3


@pytest.mark.parametrize("nr", [1, 2])
def test_fused_classify_lf_walk_resolve(index, nr):
    """Without a rowmap the inline resolve walks LF to a stored row."""
    got, want = run_both(index, nr, 1, 8, False, seed=7 + nr)
    assert_same(got, want)


def test_fused_classify_more_best_than_k_out(index):
    """k_out = 2 < the family's best seqids: such units are flagged for the
    host by n_best > k_out and ship in the fb slice."""
    got, want = run_both(index, 2, 5, 2, True, seed=3)
    assert_same(got, want)
    packed = got["packed"].numpy()
    many = (packed[:, 3] > 2) & (packed[:, 4] == 0)
    assert many.any()
    fb = set(got["fb_units"].numpy().tolist())
    assert set(np.flatnonzero(many)[:5]) <= fb


def test_fused_classify_rejects_other_row_budgets(index):
    fm, genomes = index
    tfm = TorchFM(fm_arrays(fm), device="cpu")
    pack2, vmask, lengths = pack_reads(sample_units(genomes, 4, 1, 0), 192)
    with pytest.raises(ValueError):
        de.fused_classify(tfm, torch.from_numpy(pack2), torch.from_numpy(vmask),
                          torch.from_numpy(lengths), 1, MHL, 3, 1, HITK, 8, 4 * 4)
