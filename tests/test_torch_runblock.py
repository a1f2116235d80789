"""The run-block rank layouts of the port (the plain twins of kernels K7 and
K8) against centrifuger_tpu on the CPU, exactly (integers, tolerance 0):
TorchPacked / TorchBitvector against DevicePacked / DeviceBitvector, the
generic bwt_rank / bwt_access / rank / backward_extend / lf against DeviceFM on
a protein index and on a nucleotide index's run-block mirrors, and the
mega-table layout against DeviceFM(serve_layout="runblock")."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from centrifuger_tpu.fm.device import DeviceBitvector, DeviceFM, DevicePacked
from centrifuger_tpu.succinct.bitvector import Bitvector
from centrifuger_tpu.succinct.packed import PackedSeq
from centrifuger_tpu.testutil import synthetic_fm
from centrifuger_tpu_torch.fm import device as fd
from centrifuger_tpu_torch.fm.device import (TorchBitvector, TorchFM, TorchPacked,
                                             fm_arrays)

from test_torch_kernels import family_fm, synthetic_protein_fm

torch.set_num_threads(1)   # the suite runs in several worker processes

def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int64))


def i32(a):
    return np.asarray(a, dtype=np.int32)


@pytest.fixture(scope="module")
def protein():
    fm, recs = synthetic_protein_fm()
    assert fm.bwt.b < fm.bwt.n and fm.bwt.run.n > 1000 and fm.bwt.lit.width == 8
    return fm, DeviceFM(fm), TorchFM(fm_arrays(fm), device="cpu"), recs


@pytest.fixture(scope="module")
def dna():
    """A nucleotide index, its JAX mirror with the run-block layout (which
    keeps the ind / lit / run mirrors beside the mega-table), and the port's
    runblock and generic layouts of it."""
    fm, _ = family_fm()
    fields = fm_arrays(fm)
    return (fm, DeviceFM(fm, serve_layout="runblock"),
            TorchFM(fields, device="cpu", serve_layout="runblock"),
            TorchFM(fields, device="cpu", _generic=True))


def on_layout(fields, layout):
    """TorchFM of a nucleotide index on one of the three rank layouts."""
    if layout == "generic":
        return TorchFM(fields, device="cpu", _generic=True)
    return TorchFM(fields, device="cpu", serve_layout=layout)


def edge_positions(n, first_isa, b):
    """Rows at the table edges: 0, the last, around first_isa, the 256-symbol
    and 256-block borders (pos % 256 in {254, 255, 0}) and the run-block
    borders."""
    pos = [0, 1, n - 2, n - 1, first_isa - 1, first_isa, first_isa + 1]
    for r in range(n // 256 + 1):
        pos += [256 * r - 2, 256 * r - 1, 256 * r]
    for k in (1, 2, 255, 256, 257):
        pos += [k * b - 1, k * b, 256 * k * b - 1, 256 * k * b]
    return np.array(sorted(set(p for p in pos if 0 <= p < n)), np.int64)


# ------------------------------------------ TorchPacked / TorchBitvector

@pytest.mark.parametrize("sigma,width", [(4, 2), (11, 4), (21, 8)])
def test_packed_matches_device_packed(sigma, width):
    rng = np.random.default_rng(width)
    codes = rng.integers(0, sigma, 3001).astype(np.uint8)
    codes[700:1300] = 1                      # whole blocks of one symbol
    ps = PackedSeq.from_codes(codes, sigma)
    assert ps.width == width
    jp = DevicePacked(ps, jnp.int32)
    tp = TorchPacked(ps.words, ps.occ, ps.width, ps.n, "cpu")
    assert np.array_equal(tp.words.numpy().view(np.uint32), np.asarray(jp.words))
    assert np.array_equal(tp.occ.numpy(), np.asarray(jp.occ))
    idx = np.concatenate([[0, 1, 254, 255, 256, 257, 511, 512, 2999, 3000],
                          rng.integers(0, 3001, 600)])
    c = rng.integers(0, sigma, len(idx))
    c[:10] = 1
    got = tp.rank_inclusive(t64(c), t64(idx)).numpy()
    assert np.array_equal(got, np.asarray(jp.rank_inclusive(i32(c), i32(idx))))
    assert np.array_equal(got, ps.rank_inclusive(c, idx))
    assert np.array_equal(tp.access(t64(idx)).numpy(), np.asarray(jp.access(i32(idx))))
    assert np.array_equal(tp.access(t64(idx)).numpy(), codes[idx])


def test_bitvector_matches_device_bitvector():
    rng = np.random.default_rng(9)
    bits = rng.random(5000) < 0.3
    bits[512:1100] = True
    bv = Bitvector.from_bits(bits)
    jb = DeviceBitvector(bv, jnp.int32)
    tb = TorchBitvector(bv.words, bv.cum, bv.n, "cpu")
    assert np.array_equal(tb.words.numpy().view(np.uint32), np.asarray(jb.words))
    assert np.array_equal(tb.cum.numpy(), np.asarray(jb.cum))
    idx = np.concatenate([[0, 30, 31, 32, 254, 255, 256, 257, 4998, 4999],
                          rng.integers(0, 5000, 600)])
    got = tb.rank1_inclusive(t64(idx)).numpy()
    assert np.array_equal(got, np.asarray(jb.rank1_inclusive(i32(idx))))
    assert np.array_equal(got, np.cumsum(bits)[idx])
    assert np.array_equal(tb.access(t64(idx)).numpy(), np.asarray(jb.access(i32(idx))))
    assert np.array_equal(tb.access(t64(idx)).numpy(), bits[idx].astype(np.int64))


# ------------------------------------------------- generic layout (K7)

def generic_case(request, protein, dna):
    if request == "protein":
        fm, dev, tfm, _ = protein
    else:
        fm, dev, _, tfm = dna
    assert tfm.layout == "generic" and dev.ind is not None
    return fm, dev, tfm


def probes(fm, b, seed, n_random=1500):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([edge_positions(fm.n, fm.first_isa, b),
                          rng.integers(0, fm.n, n_random)])
    c = rng.integers(0, fm.sigma, len(pos))
    c[::3] = fm.last_chr
    return c, pos


@pytest.mark.parametrize("which", ["protein", "dna"])
def test_generic_bwt_rank_and_access(protein, dna, which):
    fm, dev, tfm = generic_case(which, protein, dna)
    c, pos = probes(fm, tfm.b, 1)
    got = tfm.bwt_rank(t64(c), t64(pos)).numpy()
    assert np.array_equal(got, np.asarray(dev.bwt_rank(i32(c), i32(pos))))
    assert np.array_equal(got, fm.bwt.rank_inclusive(c, pos))
    acc = tfm.bwt_access(t64(pos)).numpy()
    assert np.array_equal(acc, np.asarray(dev.bwt_access(i32(pos))))
    assert np.array_equal(acc, fm.bwt.access(pos).astype(np.int64))


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("which", ["protein", "dna"])
def test_generic_rank_both_ways(protein, dna, which, inclusive):
    fm, dev, tfm = generic_case(which, protein, dna)
    c, pos = probes(fm, tfm.b, 2)
    got = tfm.rank(t64(c), t64(pos), inclusive).numpy()
    assert np.array_equal(got, np.asarray(dev.rank(i32(c), i32(pos), inclusive)))
    assert np.array_equal(got, fm.rank(c, pos, inclusive))


def stream_rank_bytes(pos, n, width):
    """Bytes one thread reads for a stream's rank_inclusive at pos clipped to
    the stream: the occ entry and the block's words up to pos; none for
    pos < 0 or an empty stream."""
    rem = (np.minimum(pos, n - 1) + 1) % 256
    cost = 4 + 4 * -(-rem // (32 // width))
    return np.where((pos >= 0) & (n > 0), cost, 0)


@pytest.mark.parametrize("which", ["protein", "dna"])
def test_generic_rank_accounts_only_the_taken_branch(protein, dna, which):
    """TorchFM.account over bwt_rank counts what one thread of the kernel
    reads: the indicator bit and its count, the block's own stream, and the
    other stream's cross term where there is one -- not both block types."""
    fm, _, tfm = generic_case(which, protein, dna)
    c, idx = probes(fm, tfm.b, 12)
    b, bwt = tfm.b, fm.bwt
    bi, inb = idx // b, idx % b
    typ = np.asarray(bwt.indicator.access(bi)).astype(np.int64)
    r1 = np.asarray(bwt.indicator.rank1_inclusive(bi)).astype(np.int64)
    ranki = np.where(typ == 1, r1, bi + 1 - r1)
    other = bi + 1 - ranki
    pos1 = bi + 1
    want = 4 + 4 + 4 * -(-(pos1 - (pos1 >> 5) // 8 * 256) // 32)
    w = bwt.lit.width

    def lit(pos):
        return stream_rank_bytes(pos, bwt.lit.n, w)

    def run(pos):
        return stream_rank_bytes(pos, bwt.run.n, w)
    cross = other != 0
    want = want + np.where(
        typ == 0, lit((ranki - 1) * b + inb) + cross * run(other - 1),
        run(ranki - 1) + 4 + cross * lit(other * b - 1))
    assert (typ == 0).any() and (typ == 1).any() and cross.any() and (~cross).any()
    tfm.traffic = 0
    try:
        tfm.bwt_rank(t64(c), t64(idx))
        got = tfm.traffic
    finally:
        tfm.traffic = None
    assert got == int(want.sum())


def extend_probes(fm, b, seed):
    """(c, sp, ep): random ranges, sp == ep, and ranges at first_isa."""
    rng = np.random.default_rng(seed)
    sp = np.concatenate([edge_positions(fm.n, fm.first_isa, b),
                         rng.integers(0, fm.n, 1200)])
    ep = np.minimum(sp + rng.integers(0, 400, len(sp)), fm.n - 1)
    ep[::2] = sp[::2]
    c = rng.integers(0, fm.sigma, len(sp))
    c[::3] = fm.last_chr
    return c, sp, ep


def test_generic_backward_extend_protein(protein):
    fm, dev, tfm, _ = protein
    c, sp, ep = extend_probes(fm, tfm.b, 3)
    nsp, nep = tfm.backward_extend(t64(c), t64(sp), t64(ep))
    jsp, jep = dev.backward_extend(i32(c), i32(sp), i32(ep))
    assert np.array_equal(nsp.numpy(), np.asarray(jsp))
    assert np.array_equal(nep.numpy(), np.asarray(jep))
    hsp, hep = fm.backward_extend(c, sp, ep)
    assert np.array_equal(nsp.numpy(), hsp) and np.array_equal(nep.numpy(), hep)


def test_generic_lf_protein(protein):
    fm, dev, tfm, _ = protein
    _, rows = probes(fm, tfm.b, 4)
    got = tfm.lf(t64(rows)).numpy()
    assert np.array_equal(got, np.asarray(dev.lf(i32(rows))))
    assert np.array_equal(got, fm.lf(rows))


def test_generic_equals_fast_layouts_on_dna(dna):
    """The generic layout of a nucleotide index gives the run-block layout's
    BackwardExtend and LF (the JAX package takes the fast branch there)."""
    fm, dev, _, tfm = dna
    c, sp, ep = extend_probes(fm, tfm.b, 5)
    nsp, nep = tfm.backward_extend(t64(c), t64(sp), t64(ep))
    jsp, jep = dev.backward_extend(i32(c), i32(sp), i32(ep))
    assert np.array_equal(nsp.numpy(), np.asarray(jsp))
    assert np.array_equal(nep.numpy(), np.asarray(jep))
    assert np.array_equal(tfm.lf(t64(sp)).numpy(), np.asarray(dev.lf(i32(sp))))


# ---------------------------------------------- mega-table layout (K8)

def test_mega_table_equal(dna):
    fm, dev, tfm, _ = dna
    assert np.array_equal(tfm.mega.numpy().view(np.uint32), np.asarray(dev.mega))
    assert (0, tfm.m_lit, tfm.m_run) == (dev.m_ind, dev.m_lit, dev.m_run)
    assert (tfm.b, tfm.b_lt_n) == (dev.b, dev.b_lt_n)
    assert tfm.rows is None and tfm.ind is None      # only the layout's tables


@pytest.mark.parametrize("which", ["edges", "random"])
def test_runblock_rank_sym(dna, which):
    fm, dev, tfm, _ = dna
    rng = np.random.default_rng(6)
    if which == "edges":
        pos = np.repeat(np.concatenate([[-1], edge_positions(fm.n, fm.first_isa, tfm.b)]), 4)
        c = np.tile(np.arange(4), len(pos) // 4)
        assert (pos % 256 == 255).any() and (pos == -1).any()
    else:
        pos = rng.integers(-1, fm.n, 3000)
        c = rng.integers(0, 4, 3000)
    rank, sym = tfm.rank_sym(t64(c), t64(pos))
    jr, js = dev._runblock_rank_sym(i32(c), i32(pos))
    assert np.array_equal(rank.numpy(), np.asarray(jr))
    assert np.array_equal(sym.numpy(), np.asarray(js))
    ok = pos >= 0
    assert np.array_equal(rank.numpy(), np.where(ok, fm.bwt.rank_inclusive(
        c, np.maximum(pos, 0)), 0))
    assert np.array_equal(sym.numpy()[ok], fm.bwt.access(pos[ok]).astype(np.int64))


@pytest.mark.parametrize("which", ["mixed", "same"])
def test_runblock_backward_extend(dna, which):
    fm, dev, tfm, _ = dna
    c, sp, ep = extend_probes(fm, tfm.b, 7)
    if which == "same":
        ep = sp.copy()
    assert (sp == ep).any() and (sp == fm.first_isa).any()
    nsp, nep = tfm.backward_extend(t64(c), t64(sp), t64(ep))
    jsp, jep = dev.backward_extend(i32(c), i32(sp), i32(ep))
    assert np.array_equal(nsp.numpy(), np.asarray(jsp))
    assert np.array_equal(nep.numpy(), np.asarray(jep))
    hsp, hep = fm.backward_extend(c, sp, ep)
    assert np.array_equal(nsp.numpy(), hsp) and np.array_equal(nep.numpy(), hep)


def test_runblock_lf(dna):
    fm, dev, tfm, _ = dna
    _, rows = probes(fm, tfm.b, 8)
    got = tfm.lf(t64(rows)).numpy()
    assert np.array_equal(got, np.asarray(dev.lf(i32(rows))))
    assert np.array_equal(got, fm.lf(rows))


@pytest.mark.parametrize("layout", ["runblock", "generic"])
def test_one_block_covers_the_bwt(layout):
    """rbbwt_b = 1 stores the BWT as one literal block (b >= n): the rank of
    the block type is 1 and the run stream is empty."""
    fm, _ = synthetic_fm(n_genomes=2, genome_len=3000, seed=4, rbbwt_b=1)
    assert fm.bwt.b >= fm.bwt.n and fm.bwt.run.n == 0
    dev = DeviceFM(fm, serve_layout="runblock")
    tfm = on_layout(fm_arrays(fm), layout)
    assert not tfm.b_lt_n
    c, sp, ep = extend_probes(fm, 256, 10)
    nsp, nep = tfm.backward_extend(t64(c), t64(sp), t64(ep))
    jsp, jep = dev.backward_extend(i32(c), i32(sp), i32(ep))
    assert np.array_equal(nsp.numpy(), np.asarray(jsp))
    assert np.array_equal(nep.numpy(), np.asarray(jep))
    assert np.array_equal(tfm.lf(t64(sp)).numpy(), np.asarray(dev.lf(i32(sp))))
    if layout == "generic":
        got = tfm.bwt_rank(t64(c), t64(sp)).numpy()
        assert np.array_equal(got, np.asarray(dev.bwt_rank(i32(c), i32(sp))))


# ------------------------------------------------------ the wrappers

@pytest.mark.parametrize("layout", ["plain", "runblock", "generic"])
def test_wrappers_agree_across_layouts(layout):
    """rank_sym / backward_extend / lf (what rank_probe.cu computes on the
    card) give the host index's values on every layout."""
    fm, _ = family_fm(seed=8)
    tfm = on_layout(fm_arrays(fm), layout)
    assert tfm.layout == layout
    c, sp, ep = extend_probes(fm, tfm.b, 11)

    def t32(a):
        return torch.from_numpy(i32(a))
    pos = np.concatenate([[-1], sp[1:]])
    rank, sym = fd.rank_sym(tfm, t32(c), t32(pos))
    assert rank.dtype == torch.int32
    assert np.array_equal(rank.numpy(), np.where(pos >= 0, fm.bwt.rank_inclusive(
        c, np.maximum(pos, 0)), 0))
    assert np.array_equal(sym.numpy()[1:], fm.bwt.access(pos[1:]))
    nsp, nep = fd.backward_extend(tfm, t32(c), t32(sp), t32(ep))
    hsp, hep = fm.backward_extend(c, sp, ep)
    assert np.array_equal(nsp.numpy(), hsp) and np.array_equal(nep.numpy(), hep)
    assert np.array_equal(fd.lf(tfm, t32(sp)).numpy(), fm.lf(sp))


def test_streams_of_two_widths_are_refused(protein):
    """The kernels read the literal and the run stream with one width."""
    fields = dict(fm_arrays(protein[0]), run_width=4)
    with pytest.raises(ValueError, match="differ in symbol width"):
        TorchFM(fields, device="cpu")


def test_protein_forces_the_generic_layout(protein):
    fm = protein[0]
    for serve_layout in ("plain", "runblock"):
        tfm = TorchFM(fm_arrays(fm), device="cpu", serve_layout=serve_layout)
        assert tfm.layout == "generic" and tfm.lit.width == 8
    for serve_layout in ("wide", "generic"):      # generic is never asked for
        with pytest.raises(ValueError):
            TorchFM(fm_arrays(fm), device="cpu", serve_layout=serve_layout)
