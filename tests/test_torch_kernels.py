"""Each CUDA kernel against its plain PyTorch twin on the card (marked `cuda`;
skips without a GPU).  chip_smoke.py runs the same comparisons at the main
path's shapes.  This file imports no JAX, so it runs on a host without it:

  python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from centrifuger_tpu.fm.builder import FMBuildParams, build_fm
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


# ------------------- the rank layouts: (kernel, layout) pairs and rank_probe

PROTEIN_ALPHABET = "$ARNDCEQGHILKMFPSTWYV"


def family_fm(seed=11, row_map=False):
    """A nucleotide index over four near-identical genomes and a stranger: its
    BWT has long runs, so the run-block split has run blocks, literal blocks
    and several indicator rows."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 12000).astype(np.uint8)
    genomes = [g]
    for _ in range(3):
        h = g.copy()
        pos = rng.integers(0, len(g), 60)
        h[pos] = rng.integers(0, 4, 60)
        genomes.append(h)
    genomes.append(rng.integers(0, 4, 6000).astype(np.uint8))
    fm = build_fm(np.concatenate(genomes), [len(x) for x in genomes],
                  np.arange(len(genomes)), "ACGT", FMBuildParams(row_map=row_map))
    assert fm.bwt.b < fm.bwt.n and fm.bwt.run.n > 1000 and fm.bwt.indicator.n > 512
    return fm, genomes


def synthetic_protein_fm(seed=5, n_records=40, rbbwt_b=0):
    """A protein FM index (sigma 21, end markers, ftab width 4) over random
    records, some of them near copies so that the BWT has run blocks."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_records):
        if i % 3 == 2:
            r = recs[-1][:-1].copy()
            pos = rng.integers(0, len(r), 4)
            r[pos] = rng.integers(1, 21, 4)
        else:
            r = rng.integers(1, 21, int(rng.integers(150, 600))).astype(np.uint8)
            p = int(rng.integers(0, len(r) - 40))
            r[p:p + int(rng.integers(5, 30))] = rng.integers(1, 21)
        recs.append(np.concatenate([r, [0]]).astype(np.uint8))
    params = FMBuildParams(precompute_width=4, has_end_marker=True, rbbwt_b=rbbwt_b)
    fm = build_fm(np.concatenate(recs), [len(r) for r in recs],
                  np.arange(len(recs)), PROTEIN_ALPHABET, params)
    return fm, recs


@pytest.fixture(scope="module")
def layouts_gpu():
    """{(layout, rowmap?): TorchFM on the card} of one run-rich index, and
    packed reads from it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    fm, genomes = family_fm(row_map=True)
    fms = {}
    for layout in fd.LAYOUTS:
        for rowmap in (True, False):
            fields = fd.fm_arrays(fm)
            if not rowmap:
                fields["rowmap"] = None
            fms[layout, rowmap] = fd.TorchFM(
                fields, device="cuda", _generic=True) if layout == "generic" \
                else fd.TorchFM(fields, device="cuda", serve_layout=layout)
    reads = sample_reads(genomes, 512, 100, seed=3, err=0.01)
    packed = tuple(torch.from_numpy(a).cuda() for a in pack_reads(reads, 128))
    return fm, fms, packed


@pytest.fixture(scope="module")
def protein_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    fm, recs = synthetic_protein_fm()
    tfm = fd.TorchFM(fd.fm_arrays(fm), device="cuda")
    return (fm, tfm) + protein_lanes(recs)


def protein_lanes(recs, seed=2):
    """Amino-acid code lanes [B, L] on the card (255 invalid) cut from the
    records, with 3% substitutions and 2% invalid codes, and their lengths."""
    rng = np.random.default_rng(seed)
    B, L = 6 * 2 * 64, 64
    codes = np.full((B, L), 255, np.uint8)
    lengths = np.zeros(B, np.int32)
    for i in range(B):
        r = recs[rng.integers(0, len(recs))]
        ln = int(rng.integers(0, L + 1))
        p = int(rng.integers(0, max(len(r) - ln, 1)))
        frag = r[p:p + ln].copy()
        frag[rng.random(len(frag)) < 0.03] = rng.integers(1, 21)
        frag[rng.random(len(frag)) < 0.02] = 255
        codes[i, :len(frag)] = frag
        lengths[i] = len(frag)
    return torch.from_numpy(codes).cuda(), torch.from_numpy(lengths).cuda()


def probe_queries(fm, seed):
    rng = np.random.default_rng(seed)
    sp = np.concatenate([[0, fm.first_isa - 1, fm.first_isa, fm.first_isa + 1, fm.n - 1],
                         np.arange(254, fm.n, 256)[:64], rng.integers(0, fm.n, 4096)])
    sp = np.clip(sp, 0, fm.n - 1)
    ep = np.minimum(sp + rng.integers(0, 400, len(sp)), fm.n - 1)
    ep[::2] = sp[::2]
    c = rng.integers(0, fm.sigma, len(sp))
    c[::3] = fm.last_chr

    def dev(a):
        return torch.from_numpy(a.astype(np.int32)).cuda()
    return dev(c), dev(sp), dev(ep)


def check_rank_probe(tfm, c, sp, ep):
    pos = sp.clone()
    pos[:2] = -1
    want = tfm.rank_sym(c.long(), pos.long())
    got = fd.rank_sym(tfm, c, pos)
    assert all(torch.equal(g, w.to(tfm.idtype)) for g, w in zip(got, want))
    want = tfm.backward_extend(c.long(), sp.long(), ep.long())
    got = fd.backward_extend(tfm, c, sp, ep)
    assert all(torch.equal(g, w.to(tfm.idtype)) for g, w in zip(got, want))
    assert torch.equal(fd.lf(tfm, sp), tfm.lf(sp.long()).to(tfm.idtype))


@pytest.mark.parametrize("layout", fd.LAYOUTS)
def test_rank_probe_kernel(layouts_gpu, layout):
    fm, fms, _ = layouts_gpu
    check_rank_probe(fms[layout, True], *probe_queries(fm, 1))


def test_rank_probe_kernel_protein(protein_gpu):
    fm, tfm = protein_gpu[:2]
    assert tfm.layout == "generic" and tfm.lit.width == 8
    check_rank_probe(tfm, *probe_queries(fm, 2))


@pytest.mark.parametrize("rowmap", [True, False])
@pytest.mark.parametrize("layout", ["runblock", "generic"])
def test_kernels_on_layout(layouts_gpu, layout, rowmap):
    """chain_search, finalize_units, resolve_rows and prefix_search on the
    other two rank layouts: equal to their plain twins there and to the plain
    layout's kernels."""
    fm, fms, (pack2, vmask, lengths) = layouts_gpu
    tfm, ref = fms[layout, rowmap], fms["plain", rowmap]
    hits, nh = de.chain_search(tfm, pack2, vmask, lengths, 23, 6)
    want = de.chain_search_plain(tfm, pack2, vmask, lengths, 23, 6)
    assert torch.equal(hits, want[0]) and torch.equal(nh, want[1])
    assert torch.equal(hits, de.chain_search(ref, pack2, vmask, lengths, 23, 6)[0])
    for nr in (1, 2):
        got = de.finalize_units(tfm, hits, nh, nr, 23, 40, 8)
        assert torch.equal(got, de.finalize_units_plain(tfm, hits, nh, nr, 23, 40, 8))
        assert torch.equal(got, de.finalize_units(ref, hits, nh, nr, 23, 40, 8))
    rows = torch.from_numpy(np.random.default_rng(0).integers(
        0, tfm.n, 4096).astype(np.int32)).cuda()
    valid = torch.rand(4096, device="cuda") < 0.8
    assert torch.equal(fd.resolve_rows(tfm, rows, valid),
                       fd.resolve_rows_plain(tfm, rows, valid))
    cf, _ = de.decode_packed_dna(pack2, vmask, lengths)
    codes = cf.to(torch.uint8).contiguous()
    ms = (lengths * torch.rand(len(lengths), device="cuda")).int()
    got = fd.prefix_search(tfm, codes, ms)
    want = fd.prefix_search_plain(tfm, codes, ms)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("nr", [1, 2])
def test_protein_kernels(protein_gpu, nr):
    """The protein path's kernels: chain_search over uint8 code lanes on the
    generic layout, finalize_units with the frame choice, and the LF-walk
    resolve that stops at end-marker rows."""
    fm, tfm, codes, lengths = protein_gpu
    hits, nh = fd.chain_search_lanes(tfm, codes, lengths, 11, 6)
    want = fd.chain_search_lanes_plain(tfm, codes, lengths, 11, 6)
    assert torch.equal(hits, want[0]) and torch.equal(nh, want[1])
    assert int(nh.sum()) > 50
    got = de.finalize_units(tfm, hits, nh, nr, 11, 40, 8, protein=True)
    assert torch.equal(got, de.finalize_units_plain(tfm, hits, nh, nr, 11, 40, 8,
                                                    protein=True))
    assert tfm.rowmap is None and tfm.end_marker_sa is not None
    rows = torch.arange(tfm.n, dtype=torch.int32, device="cuda")
    valid = torch.ones(tfm.n, dtype=torch.bool, device="cuda")
    assert torch.equal(fd.resolve_rows(tfm, rows, valid),
                       fd.resolve_rows_plain(tfm, rows, valid))


def test_launch_counts_name_layout_and_variant(layouts_gpu, protein_gpu):
    from centrifuger_tpu_torch import kernels
    fm, fms, (pack2, vmask, lengths) = layouts_gpu
    kernels.reset_launches()
    de.chain_search(fms["runblock", True], pack2, vmask, lengths, 23, 6)
    hits, nh = fd.chain_search_lanes(*protein_gpu[1:], 11, 6)
    de.finalize_units(protein_gpu[1], hits, nh, 1, 11, 40, 8, protein=True)
    assert dict(kernels.LAUNCHES) == {"chain_search:runblock": 1,
                                      "chain_search:generic:lanes": 1,
                                      "finalize_units:generic:protein": 1}


# -------------------------- int64 indexes (K9) and the non-fused engine

def forced64(fm, layout="plain", rowmap=True):
    fields = fd.fm_arrays(fm)
    if not rowmap:
        fields["rowmap"] = None
    return fd.TorchFM(fields, device="cuda", serve_layout=layout, force_idtype="int64")


@pytest.mark.parametrize("rowmap", [True, False])
@pytest.mark.parametrize("layout", ["plain", "runblock"])
def test_kernels_int64(layouts_gpu, layout, rowmap):
    """Every i64 instantiation against its twin and against the int32
    kernels: plain x int64 and (runblock served as) generic x int64."""
    from centrifuger_tpu_torch import kernels
    fm, fms, (pack2, vmask, lengths) = layouts_gpu
    tfm, ref = forced64(fm, layout, rowmap), fms["plain", rowmap]
    assert tfm.layout == ("generic" if layout == "runblock" else "plain")
    kernels.reset_launches()
    hits, nh = de.chain_search(tfm, pack2, vmask, lengths, 23, 6)
    assert hits.dtype == torch.int64
    want = de.chain_search_plain(tfm, pack2, vmask, lengths, 23, 6)
    assert torch.equal(hits, want[0]) and torch.equal(nh, want[1])
    rhits, rnh = de.chain_search(ref, pack2, vmask, lengths, 23, 6)
    assert torch.equal(hits, rhits.long()) and torch.equal(nh, rnh)
    for nr in (1, 2):
        got = de.finalize_units(tfm, hits, nh, nr, 23, 40, 8)
        assert torch.equal(got, de.finalize_units_plain(tfm, hits, nh, nr, 23, 40, 8))
        assert torch.equal(got, de.finalize_units(ref, rhits, rnh, nr, 23, 40, 8))
    rows = torch.from_numpy(np.random.default_rng(0).integers(0, tfm.n, 4096)).cuda()
    valid = torch.rand(4096, device="cuda") < 0.8
    got = fd.resolve_rows(tfm, rows, valid)
    assert got.dtype == torch.int64
    assert torch.equal(got, fd.resolve_rows_plain(tfm, rows, valid))
    assert torch.equal(got, fd.resolve_rows(ref, rows.int(), valid).long())
    cf, _ = de.decode_packed_dna(pack2, vmask, lengths)
    codes = cf.to(torch.uint8).contiguous()
    ms = (lengths * torch.rand(len(lengths), device="cuda")).int()
    got = fd.prefix_search(tfm, codes, ms)
    want = fd.prefix_search_plain(tfm, codes, ms)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    c, sp, ep = (x.long() for x in probe_queries(fm, 3))
    check_rank_probe(tfm, c, sp, ep)
    launched = {k.split(":")[0] for k in kernels.LAUNCHES if ":i64" in k}
    assert launched == {"chain_search", "finalize_units", "resolve_rows", "prefix_search",
                        "rank_probe"}


def test_kernels_int64_protein(protein_gpu):
    fm, _, codes, lengths = protein_gpu
    tfm = forced64(fm)
    assert tfm.layout == "generic" and tfm.rowmap is None
    hits, nh = fd.chain_search_lanes(tfm, codes, lengths, 11, 6)
    want = fd.chain_search_lanes_plain(tfm, codes, lengths, 11, 6)
    assert torch.equal(hits, want[0]) and torch.equal(nh, want[1])
    got = de.finalize_units(tfm, hits, nh, 2, 11, 40, 8, protein=True)
    assert torch.equal(got, de.finalize_units_plain(tfm, hits, nh, 2, 11, 40, 8,
                                                    protein=True))
    rows = torch.arange(tfm.n, dtype=torch.int64, device="cuda")
    valid = torch.ones(tfm.n, dtype=torch.bool, device="cuda")
    assert torch.equal(fd.resolve_rows(tfm, rows, valid),
                       fd.resolve_rows_plain(tfm, rows, valid))
    check_rank_probe(tfm, *(x.long() for x in probe_queries(fm, 4)))


# ------------------------------------- the sharded index (K10) and K11

def sharded(fm, D, idtype="int32", rowmap=True, devices=None):
    from centrifuger_tpu_torch.parallel.sharded import ShardedIndex
    fields = fd.fm_arrays(fm)
    if not rowmap:
        fields["rowmap"] = None
    return ShardedIndex(fields, D, devices, force_idtype=idtype)


@pytest.mark.parametrize("rowmap", [True, False])
@pytest.mark.parametrize("idtype", ["int32", "int64"])
def test_kernels_sharded(layouts_gpu, idtype, rowmap):
    """Every plain_sharded instantiation against its twin (routed fetches)
    and against the unsharded plain kernels, over 3 shards on one card."""
    from centrifuger_tpu_torch import kernels
    fm, fms, (pack2, vmask, lengths) = layouts_gpu
    sh, ref = sharded(fm, 3, idtype, rowmap), fms["plain", rowmap]
    kernels.reset_launches()
    hits, nh = de.chain_search(sh, pack2, vmask, lengths, 23, 6)
    want = de.chain_search_plain(sh, pack2, vmask, lengths, 23, 6)
    assert torch.equal(hits, want[0]) and torch.equal(nh, want[1])
    rhits, rnh = de.chain_search(ref, pack2, vmask, lengths, 23, 6)
    assert torch.equal(hits, rhits.to(sh.idtype)) and torch.equal(nh, rnh)
    for nr in (1, 2):
        got = de.finalize_units(sh, hits, nh, nr, 23, 40, 8)
        assert torch.equal(got, de.finalize_units_plain(sh, hits, nh, nr, 23, 40, 8))
        assert torch.equal(got, de.finalize_units(ref, rhits, rnh, nr, 23, 40, 8))
    rows = torch.from_numpy(np.random.default_rng(0).integers(0, sh.n, 4096)).cuda()
    rows[:3] = torch.tensor([0, sh.n - 1, sh.first_isa])
    valid = torch.rand(4096, device="cuda") < 0.8
    got = fd.resolve_rows(sh, rows.to(sh.idtype), valid)
    assert torch.equal(got, fd.resolve_rows_plain(sh, rows.to(sh.idtype), valid))
    assert torch.equal(got, fd.resolve_rows(ref, rows.int(), valid).to(sh.idtype))
    cf, _ = de.decode_packed_dna(pack2, vmask, lengths)
    codes = cf.to(torch.uint8).contiguous()
    ms = (lengths * torch.rand(len(lengths), device="cuda")).int()
    got = fd.prefix_search(sh, codes, ms)
    assert all(torch.equal(g, w) for g, w in zip(got, fd.prefix_search_plain(sh, codes, ms)))
    check_rank_probe(sh, *(x.to(sh.idtype) for x in probe_queries(fm, 5)))
    suffix = ":i64" if idtype == "int64" else ""
    assert {k for k in kernels.LAUNCHES if "plain_sharded" in k} == {
        k + ":plain_sharded" + suffix for k in
        ("chain_search", "finalize_units", "resolve_rows", "prefix_search", "rank_probe")}
    assert kernels.LAUNCHES["chain_search:plain_sharded" + suffix] == 1


def test_fused_program_on_sharded_index(layouts_gpu):
    """The fused program and the non-fused engine's chains on a sharded
    index equal the unsharded ones; a shard count that leaves the last shard
    mostly padding included."""
    fm, fms, (pack2, vmask, lengths) = layouts_gpu
    ref = fms["plain", True]
    Q = len(lengths) // 2
    want = de.fused_classify(ref, pack2, vmask, lengths, 2, 23, 6, 1, 40, 8, Q * 8)
    for D in (2, 7):
        got = de.fused_classify(sharded(fm, D), pack2, vmask, lengths, 2, 23, 6, 1, 40, 8,
                                Q * 8)
        for k in ("packed", "hits", "nhits", "host_blob"):
            assert torch.equal(got[k], want[k]), (D, k)
    # two views of the card stand for two cards: the units split into two
    # runs on the card and the outputs are gathered there
    sh = sharded(fm, 2)
    sh.views = [sh, sh]
    got = de.fused_classify(sh, pack2, vmask, lengths, 2, 23, 6, 1, 40, 8, Q * 8)
    for k in ("packed", "hits", "nhits", "host_blob"):
        assert torch.equal(got[k], want[k]), ("two views", k)


def test_classify_dp_step_on_card(gpu):
    from centrifuger_tpu_torch.parallel.mesh import classify_dp_step
    tfm, pack2, vmask, lengths = gpu
    cf, cr = de.decode_packed_dna(pack2, vmask, lengths)
    codes = torch.cat([cf, cr]).to(torch.uint8).contiguous()
    clen = torch.cat([lengths, lengths])
    one = classify_dp_step(tfm, ["cuda:0"], 23, 6)(codes, clen)
    two = classify_dp_step(tfm, ["cuda:0", "cuda:0"], 23, 6)(codes, clen)
    # an index on the host: the step keeps a replica of it on the card
    host = fd.TorchFM(fd.fm_arrays(_gpu_fm()), device="cpu")
    moved = classify_dp_step(host, ["cuda:0"], 23, 6)(codes, clen)
    assert host.device.type == "cpu"
    for k in one:
        assert torch.equal(one[k], two[k]) and torch.equal(one[k], moved[k]), k
    hits, nh = fd.chain_search_lanes_plain(tfm, codes, clen, 23, 6)
    has_hit = torch.arange(6, device="cuda")[None, :] < nh[:, None]
    rows = torch.where(has_hit, hits[:, :, 0], torch.zeros_like(hits[:, :, 0]))
    seqids = fd.resolve_rows_plain(tfm, rows.reshape(-1), has_hit.reshape(-1))
    assert torch.equal(one["nhits"], nh) and torch.equal(one["sp"], hits[:, :, 0])
    assert torch.equal(one["seqids"], seqids.reshape(-1, 6))
    assert int(one["total_hits"]) == int(nh.sum()) > 0


def test_sharded_over_two_cards():
    """Shards round-robin over two cards with peer access: the same results
    as one card's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    fm, genomes = synthetic_fm(n_genomes=3, genome_len=12000, seed=11)
    reads = sample_reads(genomes, 512, 100, seed=3, err=0.01)
    pack2, vmask, lengths = (torch.from_numpy(a).cuda() for a in pack_reads(reads, 128))
    one = sharded(fm, 2)
    two = sharded(fm, 2, devices=["cuda:0", "cuda:1"])
    assert len(two.views) == 2 and two.views[1].device == torch.device("cuda", 1)
    Q = len(lengths) // 2
    want = de.fused_classify(one, pack2, vmask, lengths, 2, 23, 6, 1, 40, 8, Q * 8)
    got = de.fused_classify(two, pack2, vmask, lengths, 2, 23, 6, 1, 40, 8, Q * 8)
    for k in ("packed", "hits", "nhits", "host_blob"):
        assert torch.equal(got[k], want[k]), k


def test_offset_rows_rank_int64(gpu):
    """The 40-bit occ on the card: offset rows rank O higher at pos >= 0, as
    their twin does."""
    tfm32 = gpu[0]
    tfm = fd.TorchFM(fd.fm_arrays(_gpu_fm()), device="cuda", force_idtype="int64")
    O = 5 * 2 ** 32 + 12345
    off = fd.offset_rows_view(tfm, O)
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(np.concatenate([[-1, 0, tfm.n - 1, 1919, 1920],
                                           rng.integers(0, tfm.n, 8192)])).cuda()
    c = torch.from_numpy(rng.integers(0, 4, len(pos))).cuda()
    r, s = fd.rank_sym(off, c, pos)
    rt, st = off.rank_sym(c, pos)
    assert torch.equal(r, rt) and torch.equal(s, st)
    r0, s0 = fd.rank_sym(tfm32, c.int(), pos.int())
    assert torch.equal(s, s0.long())
    assert torch.equal(r, torch.where(pos >= 0, r0.long() + O, 0))


# ------------- the group rank (a warp a lane) of K1 and K2, plain rows

@pytest.fixture(scope="module")
def group_gpu():
    """An index of 200 kbp (105 wide rows) with a 4-char ftab, whose ranges
    average 780 rows, so that the first EXTEND steps of most chains rank on
    both sides of a row edge; 2,048 reads from it, and 16 long code lanes of
    9-20 kbp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    fm, genomes = synthetic_fm(n_genomes=4, genome_len=50000, seed=21, precompute_width=4)
    start, ln = np.asarray(fm.ftab_start, np.int64), np.asarray(fm.ftab_len, np.int64)
    full = ln > 0
    crossing = (start[full] - 1) // 1920 != (start[full] + ln[full] - 1) // 1920
    assert crossing.mean() > 0.2
    reads = sample_reads(genomes, 2048, 100, seed=5, err=0.01)
    packed = tuple(torch.from_numpy(a).cuda() for a in pack_reads(reads, 128))
    rng = np.random.default_rng(6)
    lens = rng.integers(9000, 20001, 16)
    codes = np.full((16, 20032), 255, np.uint8)
    for i, n in enumerate(lens):
        g = genomes[i % len(genomes)]
        p = int(rng.integers(0, len(g) - n))
        r = g[p:p + n].copy()
        r[rng.random(n) < 0.01] = rng.integers(0, 4)
        codes[i, :n] = r
    long_lanes = (torch.from_numpy(codes).cuda(), torch.from_numpy(lens.astype(np.int32)).cuda())
    return fm, packed, long_lanes


def group_index(fm, kind, rowmap=True):
    """The plain layouts that rank with the group: whole or 2 shards on
    cuda:0, int32 or int64."""
    idtype = "int64" if kind.endswith(":i64") else "int32"
    if kind.startswith("sharded2"):
        return sharded(fm, 2, idtype, rowmap)
    fields = fd.fm_arrays(fm)
    if not rowmap:
        fields["rowmap"] = None
    return fd.TorchFM(fields, device="cuda", force_idtype=idtype)


GROUP_KINDS = ["plain", "plain:i64", "sharded2", "sharded2:i64"]


@pytest.mark.parametrize("kind", GROUP_KINDS)
def test_group_chain_kernel(group_gpu, kind):
    """The chain kernel with a warp a lane, against its twin and against
    the int32 whole-row kernel."""
    from centrifuger_tpu_torch import kernels
    fm, (pack2, vmask, lengths), _ = group_gpu
    tfm = group_index(fm, kind)
    kernels.reset_launches()
    hits, nh = de.chain_search(tfm, pack2, vmask, lengths, 23, 6)
    assert dict(kernels.LAUNCHES) == {kernels.instantiation("chain_search", tfm): 1}
    want = de.chain_search_plain(tfm, pack2, vmask, lengths, 23, 6)
    assert torch.equal(hits, want[0]) and torch.equal(nh, want[1])
    assert int(nh.sum()) > 2048
    ref = de.chain_search(group_index(fm, "plain"), pack2, vmask, lengths, 23, 6)
    assert torch.equal(hits, ref[0].to(tfm.idtype)) and torch.equal(nh, ref[1])


@pytest.mark.parametrize("kind", ["plain", "plain:i64", "sharded2"])
def test_group_chain_kernel_long_lanes(group_gpu, kind):
    """Code lanes of 9-20 kbp (the non-fused engine's long reads)."""
    fm, _, (codes, lens) = group_gpu
    tfm = group_index(fm, kind)
    hits, nh = fd.chain_search_lanes(tfm, codes, lens, 23, 400)
    want = fd.chain_search_lanes_plain(tfm, codes, lens, 23, 400)
    assert torch.equal(hits, want[0]) and torch.equal(nh, want[1])
    assert int(nh.min()) > 0


@pytest.mark.parametrize("kind", GROUP_KINDS)
def test_group_resolve_rows_lf_walk(group_gpu, kind):
    """resolve_rows with the rowmap off (the group LF walk) on every row of
    the index, against its twin and against the generic layout's one-thread
    LF walk."""
    fm = group_gpu[0]
    tfm = group_index(fm, kind, rowmap=False)
    assert tfm.rowmap is None
    rows = torch.arange(tfm.n, dtype=tfm.idtype, device="cuda")
    valid = torch.rand(tfm.n, device="cuda") < 0.9
    got = fd.resolve_rows(tfm, rows, valid)
    assert torch.equal(got, fd.resolve_rows_plain(tfm, rows, valid))
    fields = fd.fm_arrays(fm)
    fields["rowmap"] = None
    solo = fd.TorchFM(fields, device="cuda", _generic=True)
    assert torch.equal(got, fd.resolve_rows(solo, rows.int(), valid).to(tfm.idtype))


@pytest.mark.parametrize("kind", ["plain", "sharded2"])
def test_misaligned_rows_refused_on_card(gpu, kind):
    """A rows tensor (or shard) off a 16-byte boundary never reaches a
    kernel: the group rank reads rows as 16-byte vectors."""
    _, pack2, vmask, lengths = gpu
    tfm = sharded(_gpu_fm(), 2) if kind == "sharded2" else \
        fd.TorchFM(fd.fm_arrays(_gpu_fm()), device="cuda")
    rows = tfm.shards["rows"][0] if kind == "sharded2" else tfm.rows
    shifted = torch.empty(rows.numel() + 1, dtype=rows.dtype, device="cuda")[1:]
    shifted = shifted.view(rows.shape)
    shifted.copy_(rows)
    if kind == "sharded2":
        tfm.shards["rows"][0] = shifted
    else:
        tfm.rows = shifted
    with pytest.raises(ValueError, match="16-byte aligned"):
        de.chain_search(tfm, pack2, vmask, lengths, 23, 6)


def _gpu_fm():
    return synthetic_fm(n_genomes=3, genome_len=12000, seed=11)[0]


def test_dep_gather_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    from centrifuger_tpu_torch.tools import micro_gather as mg
    table, idx = mg.make_inputs(3, "cuda", nrow=4099, lanes=3000)
    got = mg.dep_gather(table, idx, 37)
    assert torch.equal(got, mg.dep_gather_plain(table, idx, 37))
    got, want, ms, plain_ms = mg.run("cuda")
    assert torch.equal(got, want) and ms > 0


def _results(res):
    return [(r.score, r.secondary_score, r.hit_length, r.query_length, r.tax_ids,
             r.seq_names) for r in res]


@pytest.fixture(scope="module")
def port_small(tmp_path_factory):
    """The small fixture indexed by the port's builder, loaded by the port."""
    import contextlib
    import io
    import os
    from centrifuger_tpu_torch.build import build_index, load_index
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "small")
    prefix = str(tmp_path_factory.mktemp("port_small") / "idx")
    with contextlib.redirect_stderr(io.StringIO()):
        build_index([os.path.join(d, "ref.fa")], os.path.join(d, "nodes.dmp"),
                    os.path.join(d, "names.dmp"), os.path.join(d, "ref_seqid.map"),
                    conversion_at_file_level=False, output_prefix=prefix)
    fm, tax, _, _ = load_index(prefix)
    genomes = []
    with open(os.path.join(d, "ref.fa")) as f:
        for line in f:
            if line.startswith(">"):
                genomes.append([])
            else:
                genomes[-1].append(line.strip())
    return fm, tax, [np.frombuffer("".join(g).encode(), np.uint8) for g in genomes]


@pytest.mark.parametrize("idtype", ["int32", "int64"])
@pytest.mark.parametrize("k,hitk", [(1, 40), (0, 40), (2, 0)])
def test_unfused_engine_on_card(port_small, k, hitk, idtype):
    """ClassifierTorchUnfused on the card equals it on the CPU (the twins),
    and ClassifierTorch hands it -k 0, --hitk-factor 0 and long reads."""
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.engine_unfused import ClassifierTorchUnfused
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    fm, tax, genomes = port_small
    rng = np.random.default_rng(k + hitk)
    qs = []
    for i in range(64):
        g = genomes[rng.integers(0, len(genomes))]
        ln = 9000 if i == 0 else 100
        p = int(rng.integers(0, len(g) - ln))
        qs.append((g[p:p + ln].copy(), None if i % 2 else g[p:p + 100].copy()))
    out = {}
    for device in ("cuda", "cpu"):
        param = ClassifierParam(max_result=k, max_result_per_hit_factor=hitk)
        eng = ClassifierTorchUnfused(fm, tax, param, device=device, force_idtype=idtype)
        out[device] = _results(eng.query_batch(qs))
    assert out["cuda"] == out["cpu"]
    fused = ClassifierTorch(fm, tax, ClassifierParam(max_result=k, max_result_per_hit_factor=hitk),
                            device="cuda", force_idtype=idtype)
    assert _results(fused.query_batch(qs)) == out["cpu"]


# ------------ K5 (a warp a lane) and K3 (a warp a unit): the edge cases

def prefix_edge_lanes(genomes, pw, L, seed):
    """uint8 code lanes [B, L] (255 invalid) and int32 ms [B] for the
    prefix search's edge cases: ms < 0, 0 and < pw; a 255 inside the first
    pw-mer (the short tail); random codes, whose pw-mer is often absent from
    the ftab; a 255 met mid-extension; ms = L and ms > L; exact substrings
    of a genome, which the search covers whole; and substrings with
    errors."""
    rng = np.random.default_rng(seed)
    lanes, ms = [], []

    def piece(n):
        g = genomes[int(rng.integers(len(genomes)))]
        p = int(rng.integers(0, len(g) - n))
        return g[p:p + n].astype(np.uint8)

    def add(x, m):
        lanes.append(x)
        ms.append(m)
    for m in (-7, -1, 0, 1, pw - 1):
        add(piece(L), m)
    for d in range(pw):                                   # the short tail
        x, m = piece(L), int(rng.integers(pw, L + 1))
        x[m - 1 - d] = 255
        add(x, m)
    for _ in range(8):                                    # mostly empty ftab k-mers
        add(rng.integers(0, 4, L).astype(np.uint8), int(rng.integers(pw, L + 1)))
    for _ in range(8):                                    # a 255 mid-extension
        x, m = piece(L), int(rng.integers(pw + 2, L + 1))
        x[int(rng.integers(0, m - pw - 1))] = 255
        add(x, m)
    for m in (L, L, L + 1, L + 40):                       # ms = L and beyond
        add(piece(L), m)
    for _ in range(8):                                    # covered whole
        add(piece(L), int(rng.integers(pw, L + 1)))
    for _ in range(16):                                   # errors
        x = piece(L)
        err = rng.random(L) < 0.02
        x[err] = rng.integers(0, 4, int(err.sum()))
        add(x, int(rng.integers(0, L + 1)))
    return np.stack(lanes), np.array(ms, np.int32)


def prefix_long_lanes(genomes, n_lanes, L, seed):
    """Lanes of L codes whose ms runs in the thousands: half exact pieces of
    a genome (searched over all of ms), half with 0.1% errors."""
    rng = np.random.default_rng(seed)
    codes = np.full((n_lanes, L), 255, np.uint8)
    ms = rng.integers(L // 2, L + 1, n_lanes).astype(np.int32)
    for i in range(n_lanes):
        g = genomes[i % len(genomes)]
        p = int(rng.integers(0, len(g) - L))
        x = g[p:p + L].astype(np.uint8)
        if i % 2:
            err = rng.random(L) < 0.001
            x[err] = rng.integers(0, 4, int(err.sum()))
        codes[i] = x
    return codes, ms


def finalize_edge_units(n, Q, lpu, H, mhl, seed, protein=False):
    """Hand-made chains for finalize_units over an index of n rows: hits
    [lpu Q, H, 4] int64 (sp, ep, l, off) and nhits int32 [lpu Q].  Unit 0
    has no hits; unit 1 ties its strands (protein: its frames too); unit 2
    has every lane full to H; unit 3 has hits whose rows reach n - 1; units
    4 and 5 expand past W = 8 rows (one wide hit; many one-row hits).  The
    rest are random, most lanes with 0-3 hits: one-row hits in runs of consecutive offsets (which
    merge where they resolve alike), narrow ranges, ranges that stride
    (wider than max_entries), l around mhl."""
    rng = np.random.default_rng(seed)
    hits = np.zeros((Q * lpu, H, 4), np.int64)
    nh = np.where(rng.random(Q * lpu) < 0.8, rng.integers(0, 4, Q * lpu),
                  rng.integers(0, H + 1, Q * lpu)).astype(np.int32)

    def lane_hits(b, count):
        off = int(rng.integers(0, 8))
        for m in range(count):
            u = rng.random()
            sp = int(rng.integers(0, n))
            ep = sp if u < 0.5 else sp + int(rng.integers(1, 6)) if u < 0.8 else \
                sp + int(rng.integers(6, 120)) if u < 0.95 else sp + int(rng.integers(0, n))
            l = int(rng.integers(mhl, mhl + 60)) if rng.random() < 0.9 else mhl - 3
            hits[b, m] = (sp, min(ep, n - 1), l, off)
            off += l + (1 if rng.random() < 0.7 else int(rng.integers(2, 9)))
    for b in range(Q * lpu):
        lane_hits(b, H)
    hits[:, :, 2] = np.maximum(hits[:, :, 2], 1)
    nh[:lpu] = 0                                          # no hits
    base = lpu                                            # a tie
    nh[base:base + lpu] = max(nh[base], 1)
    if protein:
        for g in range(0, lpu, 3):
            hits[base + g + 1] = hits[base + g + 2] = hits[base]
    else:
        hits[base + 1] = hits[base]
        if lpu == 4:
            hits[base + 2] = hits[base + 3]
    nh[2 * lpu:3 * lpu] = H                               # full to H
    hits[3 * lpu:4 * lpu, 0, :2] = n - 1                  # the last row
    hits[3 * lpu, 1, :2] = (n - 9, n - 1)
    nh[3 * lpu:4 * lpu] = np.maximum(nh[3 * lpu:4 * lpu], 2)
    hits[4 * lpu, 0, :2] = (0, n - 1)                     # past W: one wide hit
    nh[4 * lpu] = max(nh[4 * lpu], 1)
    nh[5 * lpu:6 * lpu] = H                               # past W: many hits
    hits[5 * lpu:6 * lpu, :, 1] = hits[5 * lpu:6 * lpu, :, 0]
    return hits, nh


@pytest.fixture(scope="module")
def edge_gpu():
    """A run-rich index with its rowmap and pw 10 (many ftab k-mers empty),
    and its genomes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return family_fm(row_map=True)


EDGE_KINDS = ["plain", "plain:i64", "sharded2", "sharded2:i64", "runblock", "generic"]


def edge_index(fm, kind, rowmap=True):
    """The plain layouts of group_index, or the run-block or generic layout
    (int32) on the card."""
    if kind not in ("runblock", "generic"):
        return group_index(fm, kind, rowmap)
    fields = fd.fm_arrays(fm)
    if not rowmap:
        fields["rowmap"] = None
    if kind == "generic":
        return fd.TorchFM(fields, device="cuda", _generic=True)
    return fd.TorchFM(fields, device="cuda", serve_layout="runblock")


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_prefix_search_kernel_edges(edge_gpu, kind):
    """K5 on the edge-case lanes and on lanes searched for thousands of
    steps, against its twin and the int32 plain kernel."""
    fm, genomes = edge_gpu
    tfm, ref = edge_index(fm, kind), edge_index(fm, "plain")
    for codes, ms in (prefix_edge_lanes(genomes, fm.precompute_width, 100, 1),
                      prefix_long_lanes(genomes, 8, 3000, 2)):
        codes, ms = torch.from_numpy(codes).cuda(), torch.from_numpy(ms).cuda()
        got = fd.prefix_search(tfm, codes, ms)
        want = fd.prefix_search_plain(tfm, codes, ms)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(torch.equal(g, r.to(tfm.idtype))
                   for g, r in zip(got, fd.prefix_search(ref, codes, ms)))
    assert int(got[0].max()) >= 1500


@pytest.mark.parametrize("nr", [1, 2])
@pytest.mark.parametrize("rowmap", [True, False])
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_finalize_units_kernel_edges(edge_gpu, kind, rowmap, nr):
    """K3 on hand-made chains (no hits, a strand tie, lanes full to H, rows
    at n - 1, units past W), with the rowmap and with the LF walk, against
    its twin and the int32 plain kernel."""
    fm = edge_gpu[0]
    tfm, ref = edge_index(fm, kind, rowmap), edge_index(fm, "plain", rowmap)
    for H in (6, 40):
        h, nh = finalize_edge_units(fm.n, 256, 2 * nr, H, 23, seed=H + nr)
        hits = torch.from_numpy(h).cuda()
        nhits = torch.from_numpy(nh).cuda()
        got = de.finalize_units(tfm, hits.to(tfm.idtype), nhits, nr, 23, 40, 8)
        want = de.finalize_units_plain(tfm, hits.to(tfm.idtype), nhits, nr, 23, 40, 8)
        assert torch.equal(got, want)
        assert torch.equal(got, de.finalize_units(ref, hits.int(), nhits, nr, 23, 40, 8))
        flags = got[:, 4]
        assert bool((flags & de.FLAG_ROW_OVERFLOW).any()) and bool((got[:, 3] > 1).any())


@pytest.mark.parametrize("nr", [1, 2])
def test_finalize_units_kernel_protein_edges(protein_gpu, nr):
    """K3's frame choice on hand-made protein chains: frame ties included;
    the LF walk stops at end-marker rows."""
    fm, tfm = protein_gpu[:2]
    for H in (4, 40):
        h, nh = finalize_edge_units(fm.n, 128, 6 * nr, H, 11, seed=H + nr, protein=True)
        hits, nhits = torch.from_numpy(h).int().cuda(), torch.from_numpy(nh).cuda()
        got = de.finalize_units(tfm, hits, nhits, nr, 11, 40, 8, protein=True)
        assert torch.equal(got, de.finalize_units_plain(tfm, hits, nhits, nr, 11, 40, 8,
                                                        protein=True))


# ---------- the run-block and generic layouts: a warp a lane (K7, K8, K9)

RB_KINDS = ["runblock", "generic", "generic:i64", "protein"]


@pytest.fixture(scope="module")
def rb_gpu():
    """The run-rich nucleotide index and its genomes, the protein index and
    its records, and the protein chain lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    fm, genomes = family_fm(row_map=True)
    pfm, recs = synthetic_protein_fm()
    return fm, genomes, pfm, [r[:-1] for r in recs]


def rb_index(rb, kind, rowmap=False):
    """(the index of `kind` on the card, its host index, its sequences):
    runblock and generic (int32 or int64) of the nucleotide index, or the
    protein index (generic, sigma 21)."""
    fm, genomes, pfm, recs = rb
    if kind == "protein":
        return fd.TorchFM(fd.fm_arrays(pfm), device="cuda"), pfm, recs
    fields = fd.fm_arrays(fm)
    if not rowmap:
        fields["rowmap"] = None
    if kind == "runblock":
        return fd.TorchFM(fields, device="cuda", serve_layout="runblock"), fm, genomes
    idtype = "int64" if kind.endswith(":i64") else "int32"
    return fd.TorchFM(fields, device="cuda", _generic=True, force_idtype=idtype), fm, genomes


@pytest.mark.parametrize("kind", RB_KINDS)
def test_rb_group_rank_probe(rb_gpu, kind):
    """rank_probe's group modes (BackwardExtend and LF through Lanes<Layout>,
    a warp a query) against the twins and the one-thread modes, at the
    table edges and at random rows."""
    from centrifuger_tpu_torch import kernels
    tfm, fm, _ = rb_index(rb_gpu, kind)
    assert tfm.layout == ("runblock" if kind == "runblock" else "generic")
    c, sp, ep = (x.to(tfm.idtype) for x in probe_queries(fm, 6))
    kernels.reset_launches()
    got = fd.backward_extend(tfm, c, sp, ep, group=True)
    want = tfm.backward_extend(c.long(), sp.long(), ep.long())
    assert all(torch.equal(g, w.to(tfm.idtype)) for g, w in zip(got, want))
    assert all(torch.equal(g, s) for g, s in zip(got, fd.backward_extend(tfm, c, sp, ep)))
    rows = torch.cat([sp, ep])
    got = fd.lf(tfm, rows, group=True)
    assert torch.equal(got, tfm.lf(rows.long()).to(tfm.idtype))
    assert torch.equal(got, fd.lf(tfm, rows))
    assert dict(kernels.LAUNCHES) == {kernels.instantiation("rank_probe", tfm): 4}


@pytest.mark.parametrize("kind", RB_KINDS)
def test_rb_chain_and_prefix(rb_gpu, kind):
    """K1 (K6's body) and K5 with a warp a lane on the run-block and generic
    layouts: the chains of sampled reads (protein: code lanes), the prefix
    search's edge-case lanes and long searches, against their twins."""
    tfm, fm, seqs = rb_index(rb_gpu, kind)
    if kind == "protein":
        codes, lengths = protein_lanes(seqs)
        hits, nh = fd.chain_search_lanes(tfm, codes, lengths, 11, 6)
        want = fd.chain_search_lanes_plain(tfm, codes, lengths, 11, 6)
        long_lanes = prefix_long_lanes(seqs, 8, 140, 2)
    else:
        reads = sample_reads(seqs, 512, 100, seed=3, err=0.01)
        packed = tuple(torch.from_numpy(a).cuda() for a in pack_reads(reads, 128))
        hits, nh = de.chain_search(tfm, *packed, 23, 6)
        want = de.chain_search_plain(tfm, *packed, 23, 6)
        long_lanes = prefix_long_lanes(seqs, 8, 3000, 2)
    assert torch.equal(hits, want[0]) and torch.equal(nh, want[1])
    assert int(nh.sum()) > 50
    for codes, ms in (prefix_edge_lanes(seqs, fm.precompute_width, 100, 1), long_lanes):
        codes, ms = torch.from_numpy(codes).cuda(), torch.from_numpy(ms).cuda()
        got = fd.prefix_search(tfm, codes, ms)
        want = fd.prefix_search_plain(tfm, codes, ms)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("nr", [1, 2])
@pytest.mark.parametrize("kind", RB_KINDS)
def test_rb_lf_walks(rb_gpu, kind, nr):
    """K2's LF-walk resolve and K3's --no-rowmap finalize (its warp LF walk)
    on the run-block and generic layouts: every row of the index and
    hand-made chains, against their twins."""
    tfm, fm, _ = rb_index(rb_gpu, kind)
    assert tfm.rowmap is None
    rows = torch.arange(tfm.n, dtype=tfm.idtype, device="cuda")
    valid = torch.rand(tfm.n, device="cuda") < 0.9
    assert torch.equal(fd.resolve_rows(tfm, rows, valid),
                       fd.resolve_rows_plain(tfm, rows, valid))
    protein = kind == "protein"
    lpu, mhl = (6 * nr, 11) if protein else (2 * nr, 23)
    for H in (6, 40):
        h, nh = finalize_edge_units(fm.n, 128, lpu, H, mhl, seed=H + nr, protein=protein)
        hits = torch.from_numpy(h).to("cuda", tfm.idtype)
        nhits = torch.from_numpy(nh).cuda()
        got = de.finalize_units(tfm, hits, nhits, nr, mhl, 40, 8, protein=protein)
        assert torch.equal(got, de.finalize_units_plain(tfm, hits, nhits, nr, mhl, 40, 8,
                                                        protein=protein))
