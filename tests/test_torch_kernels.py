"""Each CUDA kernel against its plain PyTorch twin on the card (marked `cuda`;
skips without a GPU).  chip_smoke.py runs the same comparisons at the main
path's shapes.  This file imports no JAX, so it runs on a host without it:

  python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from centrifuger_tpu.testutil import synthetic_fm, sample_reads
from centrifuger_tpu_torch.classify import device_engine as de
from centrifuger_tpu_torch.fm import device as fd

pytestmark = pytest.mark.cuda

ENC = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    ENC[_c] = _i


def pack_reads(reads, L):
    """uint8 ASCII reads -> (pack2 [U, L/4], vmask [U, L/8], lengths [U]) as
    the engine packs them (engine._pack_reads)."""
    U = len(reads)
    codes = np.full((U, L), 255, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = ENC[np.asarray(r, np.uint8)]
    valid = codes != 255
    cc = np.where(valid, codes, 0).reshape(U, L // 4, 4)
    pack2 = (cc[:, :, 0] | (cc[:, :, 1] << 2) | (cc[:, :, 2] << 4)
             | (cc[:, :, 3] << 6)).astype(np.uint8)
    vmask = np.packbits(valid, axis=1, bitorder="little")
    lengths = np.array([len(r) for r in reads], np.int32)
    return pack2, vmask, lengths


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    fm, genomes = synthetic_fm(n_genomes=3, genome_len=12000, seed=11)
    tfm = fd.TorchFM(fd.fm_arrays(fm), device="cuda")
    reads = sample_reads(genomes, 512, 100, seed=3, err=0.01)
    pack2, vmask, lengths = (torch.from_numpy(a).cuda() for a in pack_reads(reads, 128))
    return tfm, pack2, vmask, lengths


def test_chain_search_kernel(gpu):
    tfm, pack2, vmask, lengths = gpu
    got = de.chain_search(tfm, pack2, vmask, lengths, 23, 6)
    want = de.chain_search_plain(tfm, pack2, vmask, lengths, 23, 6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("nr", [1, 2])
def test_finalize_units_kernel(gpu, nr):
    tfm, pack2, vmask, lengths = gpu
    hits, nh = de.chain_search(tfm, pack2, vmask, lengths, 23, 6)
    got = de.finalize_units(tfm, hits, nh, nr, 23, 40, 8)
    assert torch.equal(got, de.finalize_units_plain(tfm, hits, nh, nr, 23, 40, 8))


@pytest.mark.parametrize("rowmap", [True, False])
def test_resolve_rows_kernel(gpu, rowmap):
    tfm = gpu[0]
    saved = tfm.rowmap
    tfm.rowmap = saved if rowmap else None
    try:
        rows = torch.from_numpy(np.random.default_rng(0).integers(
            0, tfm.n, 4096).astype(np.int32)).cuda()
        valid = torch.rand(4096, device="cuda") < 0.8
        assert torch.equal(fd.resolve_rows(tfm, rows, valid),
                           fd.resolve_rows_plain(tfm, rows, valid))
    finally:
        tfm.rowmap = saved


def test_prefix_search_kernel(gpu):
    tfm, pack2, vmask, lengths = gpu
    cf, _ = de.decode_packed_dna(pack2, vmask, lengths)
    codes = cf.to(torch.uint8).contiguous()
    ms = (lengths * torch.rand(len(lengths), device="cuda")).int()
    got = fd.prefix_search(tfm, codes, ms)
    want = fd.prefix_search_plain(tfm, codes, ms)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
