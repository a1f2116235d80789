"""The three further paths of the port on the CPU (the kernels' plain twins)
against centrifuger_tpu, exactly: the protein (translated) path, the wide-ftab
chain search, and the goldens through the port's CLI for protein and for the
run-block serving layout, byte-identical and in order."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import FIXTURE_DIR
from centrifuger_tpu.fm.device import DeviceFM
from centrifuger_tpu.testutil import synthetic_fm, sample_reads
from centrifuger_tpu_torch.classify import device_engine as de
from centrifuger_tpu_torch.fm import device as fd
from centrifuger_tpu_torch.fm.device import TorchFM, fm_arrays

from test_golden_classify import assert_tsv_equal
from test_engine_fused import _results_equal
from test_torch_chain import adversarial_reads
from test_torch_golden import port_index, run_port_cli
from test_torch_kernels import pack_reads, synthetic_protein_fm

torch.set_num_threads(1)   # the suite runs in several worker processes

PFX = os.path.join(FIXTURE_DIR, "tiny_protein")


# ----------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def protein_prefix(tmp_path_factory):
    """tiny_protein built by the port's builder (--protein)."""
    from centrifuger_tpu_torch.cli import build_cli
    prefix = str(tmp_path_factory.mktemp("port_protein") / "idx")
    with contextlib.redirect_stderr(io.StringIO()):
        assert build_cli.main([
            "-r", os.path.join(PFX, "ref.fa"), "--taxonomy-tree",
            os.path.join(PFX, "nodes.dmp"), "--name-table", os.path.join(PFX, "names.dmp"),
            "--conversion-table", os.path.join(PFX, "ref_seqid.map"), "--protein",
            "-o", prefix]) == 0
    return prefix


@pytest.fixture(scope="module")
def protein_engines(protein_prefix):
    """(the JAX package's fused engine, its exact host engine, the port's
    engine on the CPU), each on its own package's load of the same files."""
    from centrifuger_tpu.build import load_index as jax_load_index
    from centrifuger_tpu.classify.engine_fused import ClassifierFused
    from centrifuger_tpu.classify.engine_np import ClassifierNP
    from centrifuger_tpu.classify.params import ClassifierParam as JaxParam
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    jfm, jtax, _, _ = jax_load_index(protein_prefix)
    fm, tax, _, _ = load_index(protein_prefix)
    return (ClassifierFused(jfm, jtax, JaxParam(), protein=True),
            ClassifierNP(jfm, jtax, JaxParam(max_result=2), protein=True),
            ClassifierTorch(fm, tax, ClassifierParam(), protein=True, device="cpu"))


def protein_queries(paired, n=64):
    """The fixture's nucleotide reads (and, paired, a later read as the mate);
    one read carries Ns and one unit has an empty mate."""
    reads = []
    with open(os.path.join(PFX, "reads_1.fq")) as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                reads.append(np.frombuffer(line.strip().encode(), np.uint8).copy())
    reads[3][10:14] = ord("N")
    reads = (reads * 3)[:2 * n]
    if not paired:
        return [(r, None) for r in reads[:n]]
    qs = [(reads[i], reads[n + i][:60 + i % 40]) for i in range(n)]
    qs[5] = (qs[5][0], np.zeros(0, np.uint8))
    return qs


# ------------------------------------------------- the protein path (A)

def test_protein_index_matches_jax_build(protein_prefix, tmp_path_factory):
    from centrifuger_tpu.build import build_index
    theirs = str(tmp_path_factory.mktemp("jax_protein") / "idx")
    with contextlib.redirect_stderr(io.StringIO()):
        build_index([os.path.join(PFX, "ref.fa")], os.path.join(PFX, "nodes.dmp"),
                    os.path.join(PFX, "names.dmp"), os.path.join(PFX, "ref_seqid.map"),
                    conversion_at_file_level=False, output_prefix=theirs, protein=True)
    for ext in (".fm.npz", ".rowmap.npz", ".tax.npz", ".seqlen.npz"):
        a, b = np.load(protein_prefix + ext), np.load(theirs + ext)
        assert a.files == b.files, ext
        for k in a.files:
            assert np.array_equal(a[k], b[k]), (ext, k)


@pytest.mark.parametrize("paired", [False, True])
def test_pack_reads_protein_matches_jax(protein_engines, paired):
    jeng, _, port = protein_engines
    queries = protein_queries(paired)
    jcodes, jlens, jnr, q0, _, jL = jeng._pack_reads_protein(queries)
    codes, lens, nr, L = port._pack_reads_protein(queries)
    assert (nr, L, q0) == (jnr, jL, len(queries)) and L % 32 == 0
    B = 6 * nr * len(queries)
    assert codes.shape == (B, L) and codes.dtype == np.uint8
    assert np.array_equal(codes, jcodes[:B]) and np.array_equal(lens, jlens[:B])
    assert (jcodes[B:] == 255).all() and not jlens[B:].any()   # its padding lanes


@pytest.mark.parametrize("paired", [False, True])
def test_fused_classify_protein_matches_jax(protein_engines, paired):
    jeng, _, port = protein_engines
    queries = protein_queries(paired)
    jcodes, jlens, nr, Q0, Q, L = jeng._pack_reads_protein(queries)
    codes, lens, _, _ = port._pack_reads_protein(queries)
    mhl = port.param.min_hit_len
    assert mhl == jeng.param.min_hit_len and mhl >= 11
    H = L // (mhl + 1) + 1
    want = jeng.dev.fused_classify(jcodes, jlens, nr, mhl, H, 1, 40, 8, Q * de.U_CAP,
                                   protein=True)
    got = de.fused_classify_protein(port.dev, torch.from_numpy(codes),
                                    torch.from_numpy(lens), nr, mhl, H, 1, 40, 8,
                                    Q0 * de.U_CAP)
    B = 6 * nr * Q0
    assert np.array_equal(got["packed"].numpy(), np.asarray(want["packed"])[:Q0])
    assert np.array_equal(got["hits"].numpy(), np.asarray(want["hits"])[:B])
    assert np.array_equal(got["nhits"].numpy(), np.asarray(want["nhits"])[:B])
    assert np.array_equal(got["fb_units"].numpy(), np.asarray(want["fb_units"])[:Q0])
    assert (got["packed"][:, 3] > 0).sum() > Q0 // 2     # most units classified
    assert not (got["packed"][:, 4] & de.FLAG_ADJUST).any()


def test_finalize_protein_frame_choice():
    """Frame choice on made-up chains: nhits * score decides, strictly, so a
    tie keeps the earlier frame and an all-zero read keeps frame 0."""
    fm, _ = synthetic_protein_fm()
    tfm = TorchFM(fm_arrays(fm), device="cpu")
    dev = DeviceFM(fm)
    rng = np.random.default_rng(3)
    Q, H, mhl = 48, 3, 11
    for nr in (1, 2):
        B = 6 * nr * Q
        nh = rng.integers(0, H + 1, B).astype(np.int32)
        nh[:12] = 1                                  # ties among the frames
        hits = np.zeros((B, H, 4), np.int32)
        hits[:, :, 0] = rng.integers(0, fm.n - 1, (B, H))
        hits[:, :, 1] = hits[:, :, 0] + rng.integers(0, 3, (B, H)) // 2
        hits[:, :, 2] = rng.integers(mhl, 30, (B, H))
        hits[:12, :, 2] = 20
        hits[:, :, 3] = np.arange(H)[None, :] * 31
        hits[np.arange(H)[None, :] >= nh[:, None]] = 0
        got = de.finalize_units_plain(tfm, torch.from_numpy(hits), torch.from_numpy(nh),
                                      nr, mhl, 40, 8, protein=True)
        # the JAX program's finalize on the same chains: stub its chain search
        stub = dev._bind(dev.arrs)
        stub._chain_search_impl = lambda codes, lens, m, h: dict(
            sp=jnp.asarray(hits[:, :, 0]), ep=jnp.asarray(hits[:, :, 1]),
            l=jnp.asarray(hits[:, :, 2]), off=jnp.asarray(hits[:, :, 3]),
            nhits=jnp.asarray(nh))
        from centrifuger_tpu.classify.device_engine import fused_classify
        want = fused_classify(stub, jnp.zeros((B, 32), jnp.uint8), jnp.zeros(B, jnp.int32),
                              nr, mhl, H, 1, 40, 8, Q * de.U_CAP, protein=True)
        assert np.array_equal(got.numpy(), np.asarray(want["packed"])), nr


@pytest.mark.parametrize("paired,k", [(False, 1), (True, 2)])
def test_protein_engine_vs_host_oracle(protein_engines, paired, k):
    _, oracle, port = protein_engines
    oracle.param.max_result = port.param.max_result = k
    try:
        queries = protein_queries(paired, n=40)
        got = port.query_batch(queries)
        for i, (r1, r2) in enumerate(queries):
            want = oracle.query(r1, r2 if r2 is not None and len(r2) else None)
            want.query_length = len(r1) + (len(r2) if r2 is not None else 0)
            assert _results_equal(want, got[i]), i
    finally:
        port.param.max_result = 1


def test_resolve_on_an_end_marker_index():
    """Without selected rows the rows below len(end_marker_sa) are stored
    rows; every row's LF walk ends where the JAX program's does."""
    fm, _ = synthetic_protein_fm(seed=6, n_records=12)
    assert fm.selected_rows is None and len(fm.end_marker_sa) == 12
    dev = DeviceFM(fm)
    tfm = TorchFM(fm_arrays(fm), device="cpu")
    assert tfm.rowmap is None and tfm.end_marker_sa is not None
    rows = np.arange(fm.n, dtype=np.int32)
    valid = np.ones(fm.n, bool)
    valid[::7] = False
    got = fd.resolve_rows(tfm, torch.from_numpy(rows), torch.from_numpy(valid)).numpy()
    assert np.array_equal(got, np.asarray(dev.resolve_rows(rows, valid)))
    assert np.array_equal(got[valid], fm.resolve_rows(rows[valid]))
    found, _ = fm.get_sampled_sa(rows.astype(np.int64))
    assert np.array_equal(tfm.stored_here(torch.from_numpy(rows).long()).numpy(), found)


@pytest.mark.parametrize("tag,extra", [("k1", []), ("k2", ["-k", "2"]), ("k5", ["-k", "5"])])
@pytest.mark.parametrize("rowmap", [True, False])
def test_cli_protein_goldens(protein_prefix, tag, extra, rowmap):
    got = run_port_cli("tiny_protein", protein_prefix,
                       extra + ([] if rowmap else ["--no-rowmap"]), paired=False)
    assert_tsv_equal(got, os.path.join(PFX, "golden_class_%s.tsv" % tag))


# --------------------------------------- the run-block serving layout (B)

@pytest.mark.parametrize("rowmap", [True, False])
@pytest.mark.parametrize("fx,paired", [("tiny", True), ("tiny_single", False),
                                       ("small", True)])
def test_cli_runblock_goldens(tmp_path_factory, fx, paired, rowmap):
    extra = ["--serve-layout", "runblock"] + ([] if rowmap else ["--no-rowmap"])
    got = run_port_cli(fx, port_index(fx, tmp_path_factory), extra, paired)
    assert_tsv_equal(got, os.path.join(FIXTURE_DIR, fx, "golden_class_k1.tsv"))


@pytest.mark.parametrize("tag,extra", [("k2", ["-k", "2"]), ("k5", ["-k", "5"])])
def test_cli_runblock_goldens_k(tmp_path_factory, tag, extra):
    got = run_port_cli("tiny", port_index("tiny", tmp_path_factory),
                       extra + ["--serve-layout", "runblock", "--batch-size", "32"])
    assert_tsv_equal(got, os.path.join(FIXTURE_DIR, "tiny", "golden_class_%s.tsv" % tag))


@pytest.mark.parametrize("layout", ["runblock", "generic"])
def test_fused_classify_layouts_match_plain(layout):
    """The whole device program gives the plain layout's arrays on the other
    two rank layouts of the same index, rowmap or LF walk."""
    from test_torch_device_engine import family_genomes, sample_units, MHL, HITK
    from centrifuger_tpu.fm.builder import FMBuildParams, build_fm
    genomes = family_genomes(21)
    fm = build_fm(np.concatenate(genomes), [len(g) for g in genomes],
                  np.arange(len(genomes)), "ACGT", FMBuildParams(row_map=True))
    Q, L = 64, 192
    pack2, vmask, lengths = (torch.from_numpy(a) for a in
                             pack_reads(sample_units(genomes, Q, 2, 5), L))
    for rowmap in (True, False):
        fields = fm_arrays(fm)
        if not rowmap:
            fields["rowmap"] = None
        fms = [TorchFM(fields, device="cpu"),
               TorchFM(fields, device="cpu", _generic=True) if layout == "generic"
               else TorchFM(fields, device="cpu", serve_layout=layout)]
        outs = [de.fused_classify(tfm, pack2, vmask, lengths, 2, MHL, L // (MHL + 1) + 1,
                                  2, HITK, 8, Q * de.U_CAP) for tfm in fms]
        assert torch.equal(outs[0]["host_blob"], outs[1]["host_blob"]), rowmap
        assert torch.equal(outs[0]["hits"], outs[1]["hits"])


# ------------------------------------------------ the wide-ftab chain (C)

def ftab_chain(dev, codes, lengths, mhl, H):
    """DeviceFM._chain_search_ftab_impl called directly (jitted as
    chain_search jits its dispatch)."""
    f = dev._jitted(("ftab_chain", mhl, H),
                    lambda s, c, l: s._chain_search_ftab_impl(c, l, mhl, H))
    return f(dev.arrs, codes, lengths)


def assert_chains_equal(hits, nh, out):
    want = np.stack([np.asarray(out[k]) for k in ("sp", "ep", "l", "off")], axis=2)
    assert np.array_equal(nh.numpy(), np.asarray(out["nhits"]))
    assert np.array_equal(hits.numpy(), want)


@pytest.mark.parametrize("mhl,H", [(23, 6), (12, 2)])
def test_chain_matches_ftab_impl_nucleotide(mhl, H):
    """pw 10: both JAX chain programs and the port give the same chains."""
    fm, genomes = synthetic_fm(n_genomes=3, genome_len=12000, seed=11)
    dev, tfm = DeviceFM(fm), TorchFM(fm_arrays(fm), device="cpu")
    assert not tfm.wide_ftab
    reads = adversarial_reads(genomes, 5)
    L = 128
    codes = np.full((len(reads), L), 255, np.uint8)
    enc = np.full(256, 255, np.uint8)
    enc[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = enc[r]
    lengths = np.array([len(r) for r in reads], np.int32)
    hits, nh = fd.chain_search_lanes(tfm, torch.from_numpy(codes),
                                     torch.from_numpy(lengths), mhl, H)
    assert_chains_equal(hits, nh, ftab_chain(dev, codes, lengths, mhl, H))
    assert int(nh.sum()) > 20


def protein_lanes(recs, seed, n=96, L=64):
    """Amino-acid code lanes cut from the records, with substitutions, invalid
    codes, lanes shorter than pw and lanes that run over a record's end."""
    rng = np.random.default_rng(seed)
    codes = np.full((n, L), 255, np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        r = recs[rng.integers(0, len(recs))]
        ln = int(rng.integers(1, L + 1)) if i % 8 else int(rng.integers(0, 5))
        p = int(rng.integers(0, max(len(r) - ln, 1)))
        frag = r[p:p + ln].copy()
        err = rng.random(len(frag)) < 0.03
        frag[err] = rng.integers(1, 21, int(err.sum()))
        frag[rng.random(len(frag)) < 0.02] = 255
        codes[i, :len(frag)] = frag
        lengths[i] = len(frag)
    return codes, lengths


@pytest.mark.parametrize("mhl,H", [(11, 6), (6, 3)])
def test_chain_matches_jax_protein(mhl, H):
    """pw 4, code_bits 5 (5 * 4 + 9 = 29): the JAX dispatch takes the lazy
    chain; the eager-ftab chain called directly agrees, and so does the port
    on the generic rank layout."""
    fm, recs = synthetic_protein_fm()
    dev, tfm = DeviceFM(fm), TorchFM(fm_arrays(fm), device="cpu")
    assert (tfm.code_bits, tfm.pw, tfm.wide_ftab) == (5, 4, False)
    codes, lengths = protein_lanes(recs, 2)
    hits, nh = fd.chain_search_lanes(tfm, torch.from_numpy(codes),
                                     torch.from_numpy(lengths), mhl, H)
    assert_chains_equal(hits, nh, ftab_chain(dev, codes, lengths, mhl, H))
    assert_chains_equal(hits, nh, dev.chain_search(codes, lengths, mhl, H))
    assert int(nh.sum()) > 20 and int(nh.max()) >= 3      # (6, 3): H overflows


@pytest.fixture(scope="module")
def wide_ftab_prefix(tmp_path_factory):
    """The tiny fixture built by the port's cfr-build with --ftabchars 12: its
    ftab has 4^12 entries, so it is built once for the module."""
    from centrifuger_tpu_torch.cli import build_cli
    fx = os.path.join(FIXTURE_DIR, "tiny")
    prefix = str(tmp_path_factory.mktemp("port_ftab12") / "idx")
    with contextlib.redirect_stderr(io.StringIO()):
        assert build_cli.main([
            "-r", os.path.join(fx, "ref.fa"), "--taxonomy-tree",
            os.path.join(fx, "nodes.dmp"), "--name-table", os.path.join(fx, "names.dmp"),
            "--conversion-table", os.path.join(fx, "ref_seqid.map"),
            "--ftabchars", "12", "-o", prefix]) == 0
    return prefix


def test_chain_dispatch_on_wide_ftab_index(wide_ftab_prefix):
    """2 * 12 + 9 = 33 > 31: DeviceFM.chain_search dispatches to
    _chain_search_ftab_impl; the port's chain on the same index agrees."""
    from centrifuger_tpu.build import load_index as jax_load_index
    from test_torch_golden import tiny_genomes
    fm = jax_load_index(wide_ftab_prefix)[0]
    assert fm.precompute_width == 12 and len(fm.ftab_len) == 4 ** 12
    tfm = TorchFM(fm_arrays(fm), device="cpu")
    assert tfm.wide_ftab and fd.chain_variant(tfm, lanes=False) == ("wideftab",)
    enc = np.full(256, 255, np.uint8)
    enc[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    genomes = [enc[np.frombuffer(g.encode(), np.uint8)] for g in tiny_genomes()]
    reads = adversarial_reads(genomes, 9) + sample_reads(genomes, 60, 100, seed=2, err=0.02)
    pack2, vmask, lengths = pack_reads(reads, 128)
    hits, nh = de.chain_search(tfm, torch.from_numpy(pack2), torch.from_numpy(vmask),
                               torch.from_numpy(lengths), 23, 6)
    del tfm
    cf, cr = de.decode_packed_dna(torch.from_numpy(pack2), torch.from_numpy(vmask),
                                  torch.from_numpy(lengths))
    codes = torch.stack([cf, cr], dim=1).reshape(2 * len(reads), 128).to(torch.uint8).numpy()
    dev = DeviceFM(fm)
    out = dev.chain_search(codes, np.repeat(lengths, 2), 23, 6)
    assert_chains_equal(hits, nh, out)
    assert int(nh.sum()) > 60


@pytest.mark.parametrize("extra", [[], ["-k", "5", "--no-rowmap"]])
def test_cli_wide_ftab_matches_jax_cli(wide_ftab_prefix, extra):
    """Path C as a whole: on the --ftabchars 12 index the port's CLI writes
    the TSV of the JAX package's CLI, whose fused engine takes
    _chain_search_ftab_impl there.  The ftab width is part of the search (a
    START that fails on an empty range consumes pw - 1 characters), so this
    TSV is not the default-ftab goldens': some scores differ."""
    from test_golden_classify import run_classify
    got = run_port_cli("tiny", wide_ftab_prefix, extra)
    with contextlib.redirect_stderr(io.StringIO()):
        want = run_classify(os.path.join(FIXTURE_DIR, "tiny"), wide_ftab_prefix, extra,
                            engine="fused")
    assert got == want
    if not extra:
        with open(os.path.join(FIXTURE_DIR, "tiny", "golden_class_k1.tsv")) as f:
            assert got != f.read()
