"""K1 (chain search), K4 (packed-read decode) and K5 (prefix search): the
port's plain versions against centrifuger_tpu's DeviceFM programs on the same
reads, exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from centrifuger_tpu.classify.device_engine import decode_packed_dna as jax_decode
from centrifuger_tpu_torch.classify import device_engine as de
from centrifuger_tpu_torch.fm.device import prefix_search

from test_torch_fm import fms  # noqa: F401  (module fixture)
from test_torch_kernels import ENC, pack_reads

torch.set_num_threads(1)   # the suite runs in several worker processes


def adversarial_reads(genomes, seed):
    """Reads with N, shorter than pw, at genome ends, unmatched, plus
    error-injected samples from both strands."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.array([3, 2, 1, 0], np.uint8)
    reads = []
    for g in genomes:
        reads.append(acgt[g[:90]])                      # genome start
        reads.append(acgt[g[-90:]])                     # genome end
        reads.append(acgt[comp[g[-70:]][::-1]])         # rc of the end
    reads += [acgt[rng.integers(0, 4, n)] for n in (0, 1, 5, 9, 10, 11, 23)]
    for _ in range(40):
        g = genomes[rng.integers(0, len(genomes))]
        n = int(rng.integers(20, 120))
        p = int(rng.integers(0, len(g) - n))
        frag = g[p:p + n].copy()
        if rng.random() < 0.5:
            frag = comp[frag][::-1]
        err = rng.random(n) < 0.03
        frag[err] = rng.integers(0, 4, int(err.sum()))
        b = acgt[frag].copy()
        b[rng.random(n) < 0.02] = ord("N")
        reads.append(b)
    reads.append(np.full(60, ord("N"), np.uint8))
    return reads


def run_both(fms, reads, mhl, H, L=128):
    fm, dev, tfm, _ = fms
    pack2, vmask, lengths = pack_reads(reads, L)
    hits, nh = de.chain_search(tfm, torch.from_numpy(pack2), torch.from_numpy(vmask),
                               torch.from_numpy(lengths), mhl, H)
    cf, cr = jax_decode(jnp.asarray(pack2), jnp.asarray(vmask), jnp.asarray(lengths))
    codes = np.asarray(jnp.stack([cf, cr], axis=1).reshape(2 * len(reads), L))
    out = dev.chain_search(codes.astype(np.uint8), np.repeat(lengths, 2), mhl, H)
    return hits.numpy(), nh.numpy(), out


@pytest.mark.parametrize("mhl,H", [(23, 6), (15, 9), (12, 2)])
def test_chain_search_matches_jax(fms, mhl, H):
    reads = adversarial_reads(fms[3], seed=mhl)
    hits, nh, out = run_both(fms, reads, mhl, H)
    assert np.array_equal(nh, np.asarray(out["nhits"]))
    for i, k in enumerate(("sp", "ep", "l", "off")):
        assert np.array_equal(hits[:, :, i], np.asarray(out[k])), k
    assert nh.max() > 0


def test_chain_search_h_overflow_keeps_walking(fms):
    """With H = 1 a lane records its first chain only, but keeps walking:
    its nhits stays 1 and the first hit equals the H = 9 run's first hit."""
    reads = adversarial_reads(fms[3], seed=3)
    h1, n1, _ = run_both(fms, reads, 12, 1)
    h9, n9, _ = run_both(fms, reads, 12, 9)
    assert (n9 > 1).any()
    assert np.array_equal(n1, np.minimum(n9, 1))
    assert np.array_equal(h1[:, 0], h9[:, 0])


@pytest.mark.parametrize("L", [64, 128])
def test_decode_packed_dna_matches_jax(fms, L):
    reads = [r[:L] for r in adversarial_reads(fms[3], seed=L)]
    pack2, vmask, lengths = pack_reads(reads, L)
    cf, cr = de.decode_packed_dna(torch.from_numpy(pack2), torch.from_numpy(vmask),
                                  torch.from_numpy(lengths))
    jf, jr = jax_decode(jnp.asarray(pack2), jnp.asarray(vmask), jnp.asarray(lengths))
    assert np.array_equal(cf.numpy(), np.asarray(jf))
    assert np.array_equal(cr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_search_matches_jax(fms, seed):
    fm, dev, tfm, genomes = fms
    rng = np.random.default_rng(seed)
    reads = adversarial_reads(genomes, seed=10 + seed)
    L = 128
    codes = np.full((len(reads), L), 255, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = ENC[r]
    lens = np.array([len(r) for r in reads])
    ms = np.where(rng.random(len(reads)) < 0.5, lens,
                  rng.integers(0, np.maximum(lens, 1) + 1)).astype(np.int32)
    got = prefix_search(tfm, torch.from_numpy(codes), torch.from_numpy(ms))
    want = dev.prefix_search(codes, ms)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # and the host oracle, lane by lane
    from centrifuger_tpu.classify.engine_np import ClassifierNP
    from centrifuger_tpu.classify.params import ClassifierParam
    host = ClassifierNP(fm, None, ClassifierParam(min_hit_len=23))
    for i in range(len(reads)):
        assert host.backward_search(codes[i], int(ms[i])) == \
            tuple(int(t[i]) for t in got)
