"""The port's non-fused engine (ClassifierTorchUnfused, `--engine jax`) on the
CPU (the kernels' plain twins): the goldens through the CLI, and the batches
the fused engine cannot take -- reads over 8,192 bp, -k 0 and --hitk-factor 0
-- against the JAX package's engines, exactly: the chain hits against
ClassifierJax's device chain search, the results against ClassifierJax and,
through ClassifierTorch (which hands those batches to the non-fused engine),
against ClassifierFused."""

import os
import random

import numpy as np
import pytest
import torch

from conftest import FIXTURE_DIR
from test_golden_classify import assert_tsv_equal
from test_engine_fused import _rand_reads, _results_equal
from test_torch_golden import port_index, run_port_cli

torch.set_num_threads(1)   # the suite runs in several worker processes

KS = [("k1", []), ("k2", ["-k", "2"]), ("k5", ["-k", "5"])]
CASES = ("long", "k0", "hitk0")
PARAMS = {"long": dict(max_result=1), "k0": dict(max_result=0),
          "hitk0": dict(max_result=2, max_result_per_hit_factor=0),
          "mixed": dict(max_result=2)}


@pytest.mark.parametrize("tag,extra", KS)
@pytest.mark.parametrize("fx,paired", [("tiny", True), ("small", True)])
def test_cli_goldens(tmp_path_factory, fx, paired, tag, extra):
    got = run_port_cli(fx, port_index(fx, tmp_path_factory),
                       extra + ["--engine", "jax"], paired)
    assert_tsv_equal(got, os.path.join(FIXTURE_DIR, fx, "golden_class_%s.tsv" % tag))


def test_cli_golden_single(tmp_path_factory):
    got = run_port_cli("tiny_single", port_index("tiny_single", tmp_path_factory),
                       ["--engine", "jax"], paired=False)
    assert_tsv_equal(got, os.path.join(FIXTURE_DIR, "tiny_single", "golden_class_k1.tsv"))


# ------------------------------------------------- against the JAX engines

def small_genomes():
    genomes = []
    with open(os.path.join(FIXTURE_DIR, "small", "ref.fa")) as f:
        for line in f:
            if line.startswith(">"):
                genomes.append([])
            else:
                genomes[-1].append(line.strip())
    return ["".join(g) for g in genomes]


def long_reads(seed, n=2):
    """Reads of 9,000-9,200 bp cut from the fixture's 20 kb genomes, every
    second one reverse complemented, with 1% substitutions and a run of Ns."""
    rng = np.random.default_rng(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    out = []
    for i, g in enumerate(small_genomes()[:n]):
        ln = int(rng.integers(9000, 9200))
        p = int(rng.integers(0, len(g) - ln))
        r = bytearray(g[p:p + ln].encode())
        if i % 2:
            r = bytearray(bytes(r).translate(comp)[::-1])
        for j in np.flatnonzero(rng.random(ln) < 0.01):
            r[j] = b"ACGT"[rng.integers(0, 4)]
        r[100:110] = b"N" * 10
        out.append(np.frombuffer(bytes(r), np.uint8))
    return out


def chimera(a, b):
    """a, then the reverse complement of b: its strand lanes both hit, so the
    unit takes the exact path (hit-boundary adjustment)."""
    rc = bytes(b.tobytes()).translate(bytes.maketrans(b"ACGTN", b"TGCAN"))[::-1]
    return np.concatenate([a, np.frombuffer(rc, np.uint8)])


def queries(case):
    if case == "long":
        r = long_reads(5)
        short = _rand_reads(random.Random(3), small_genomes(), 1, 80, True)
        seg = np.frombuffer(small_genomes()[3][1000:1200].encode(), np.uint8)
        return [(chimera(r[0], seg), None), (short[0][0], r[1])]
    qs = _rand_reads(random.Random(11 + CASES.index(case)), small_genomes(), 24, 100, True)
    return [(chimera(r1, qs[i - 1][0]), r2) if i % 4 == 1 else (r1, r2)
            for i, (r1, r2) in enumerate(qs)]


@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    """Each package's load of the small fixture's index, and one device
    index of each package that every engine of this module shares (the JAX
    programs then compile once)."""
    from centrifuger_tpu.build import load_index as jax_load_index
    from centrifuger_tpu.fm.device import DeviceFM
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.fm.device import TorchFM
    prefix = port_index("small", tmp_path_factory)
    (jfm, jtax), (fm, tax) = jax_load_index(prefix)[:2], load_index(prefix)[:2]
    return (jfm, jtax, DeviceFM(jfm)), (fm, tax, TorchFM.from_index(fm, "cpu"))


def engines(small_index, case, monkeypatch):
    """(ClassifierJax, ClassifierFused, ClassifierTorchUnfused on the CPU,
    ClassifierTorch on the CPU) with the case's parameters.  The JAX engines
    pad a batch to a shape bucket of at least 4,096 lanes for their compile
    cache; for these few long lanes the floor is lowered (results do not
    depend on the padding)."""
    from centrifuger_tpu.classify import engine_jax
    from centrifuger_tpu.classify.engine_fused import ClassifierFused
    from centrifuger_tpu.classify.engine_jax import ClassifierJax
    from centrifuger_tpu.classify.params import ClassifierParam as JaxParam
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.engine_unfused import ClassifierTorchUnfused
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    monkeypatch.setattr(engine_jax, "_bucket_size",
                        lambda x, floor=4096: engine_jax._next_pow2(max(x, 8)))
    (jfm, jtax, jdev), (fm, tax, tdev) = small_index
    p = PARAMS[case]
    return (ClassifierJax(jfm, jtax, JaxParam(**p), dev=jdev),
            ClassifierFused(jfm, jtax, JaxParam(**p), dev=jdev),
            ClassifierTorchUnfused(fm, tax, ClassifierParam(**p), dev=tdev),
            ClassifierTorch(fm, tax, ClassifierParam(**p), dev=tdev))


@pytest.mark.parametrize("case", CASES)
def test_chain_hits_match_jax(small_index, case, monkeypatch):
    jeng, _, port, _ = engines(small_index, case, monkeypatch)
    raws = [r for q in queries(case) for r in q if r is not None]
    codes, lengths = port._encode_lanes(raws)
    jcodes, jlengths = jeng._encode_lanes(raws)
    assert np.array_equal(codes, jcodes) and np.array_equal(lengths, jlengths)
    if case == "long":
        assert codes.shape[1] > port_fused_l_max()
    mhl = port.param.min_hit_len
    H = codes.shape[1] // (mhl + 1) + 1
    sp, ep, hl, off, nh = port._pull_hits(port._chain_search_dispatch(codes, lengths))
    want = jeng.dev.chain_search(codes, lengths, mhl, H)
    assert np.array_equal(nh, np.asarray(want["nhits"]))
    live = np.arange(H)[None, :] < nh[:, None]
    for got, k in ((sp, "sp"), (ep, "ep"), (hl, "l"), (off, "off")):
        assert np.array_equal(np.where(live, got, 0), np.where(live, np.asarray(want[k]), 0)), k
    assert nh.sum() > len(raws)


def port_fused_l_max():
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    return ClassifierTorch.L_MAX


@pytest.mark.parametrize("case", CASES)
def test_unfused_matches_classifier_jax(small_index, case, monkeypatch):
    jeng, _, port, _ = engines(small_index, case, monkeypatch)
    qs = queries(case)
    want = jeng.query_batch(qs)
    got = port.query_batch(qs)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _results_equal(w, g), i
    assert port.stats["slow_units"] > 0      # the chimeras took the exact path
    assert sum(len(w.tax_ids) > 0 for w in want) >= len(qs) // 2
    if case == "k0":
        assert max(len(w.tax_ids) for w in want) > 1


LOOPS = ("query_pipelined_packed", "query_pipelined", "serve_tsv_prepacked")


@pytest.fixture(scope="module")
def jax_fused_results():
    """ClassifierFused.query_batch's results a case, made once a module."""
    return {}


def loop_lines(port, loop, batches, ids):
    """Each batch's TSV lines and classified count through one serving loop
    of ClassifierTorch, checking the loop's tuple a batch."""
    if loop == "serve_tsv_prepacked":
        items = [(i, b) + port._pack_reads(b)[:3] for i, b in zip(ids, batches)]
        out = list(port.serve_tsv_prepacked(iter(items)))
        assert [nq for _, _, nq in out] == [len(b) for b in batches]
        return [(lines, ncls) for lines, ncls, _ in out], out
    out = list(getattr(port, loop)(iter(batches)))
    assert len(out) == len(batches)
    if loop == "query_pipelined":
        assert [len(r) for r in out] == [len(b) for b in batches]
        return [port.format_tsv_batch(None, dict(enumerate(r)), b, i)
                for r, b, i in zip(out, batches, ids)], out
    for (_, _, q), b in zip(out, batches):
        assert len(q) == len(b) and all(x is y for x, y in zip(q, b))
    return [port.format_tsv_batch(p, fb, q, i) for (p, fb, q), i in zip(out, ids)], out


@pytest.mark.parametrize("loop", LOOPS)
@pytest.mark.parametrize("case", CASES)
def test_fused_engine_routes_to_unfused(small_index, case, loop, monkeypatch,
                                        jax_fused_results):
    """ClassifierTorch hands the batch to the non-fused engine, as
    ClassifierFused hands it to ClassifierJax: through each pipelined loop
    (a batch the fused program takes, the case's batch, another such batch),
    in order and with each loop's tuple, and, but for the long reads (whose
    chain search is slow on the CPU), in query_batch."""
    _, jfused, _, port = engines(small_index, case, monkeypatch)
    qs = queries(case)
    if case not in jax_fused_results:
        jax_fused_results[case] = jfused.query_batch(qs)
    want = jax_fused_results[case]
    if case != "long" and loop == LOOPS[0]:
        for i, (g, w) in enumerate(zip(port.query_batch(qs), want)):
            assert _results_equal(w, g), i
    plain = [_rand_reads(random.Random(s), small_genomes(), 8, 100, True) for s in (2, 4)]
    batches = [plain[0], qs, plain[1]]
    ids = [["b%dr%d" % (k, i) for i in range(len(b))] for k, b in enumerate(batches)]
    expect = [port.query_batch(plain[0]), want, port.query_batch(plain[1])]
    got, out = loop_lines(port, loop, batches, ids)
    for k, (b, res, i) in enumerate(zip(batches, expect, ids)):
        assert got[k] == port.format_tsv_batch(None, dict(enumerate(res)), b, i), k
    if loop == "query_pipelined_packed":
        assert [o[0] is not None for o in out] == [port._fused_ok(), False, port._fused_ok()]
        for i, w in enumerate(want):
            assert _results_equal(w, out[1][1][i]), i
    elif loop == "query_pipelined":
        for i, w in enumerate(want):
            assert _results_equal(w, out[1][i]), i
    assert len(got[1][0]) >= len(qs)


# ------------------------------------------------------------ protein

PFX = os.path.join(FIXTURE_DIR, "tiny_protein")


@pytest.mark.parametrize("tag,extra", KS)
def test_cli_golden_protein(protein_index, tag, extra):
    got = run_port_cli("tiny_protein", protein_index[1][3], extra + ["--engine", "jax"],
                       paired=False)
    assert_tsv_equal(got, os.path.join(PFX, "golden_class_%s.tsv" % tag))


@pytest.fixture(scope="module")
def protein_index(tmp_path_factory):
    """tiny_protein built by the port's builder (--protein), loaded by each
    package, with one device index of each."""
    import contextlib
    import io
    from centrifuger_tpu.build import load_index as jax_load_index
    from centrifuger_tpu.fm.device import DeviceFM
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.cli import build_cli
    from centrifuger_tpu_torch.fm.device import TorchFM
    prefix = str(tmp_path_factory.mktemp("unfused_protein") / "idx")
    with contextlib.redirect_stderr(io.StringIO()):
        assert build_cli.main([
            "-r", os.path.join(PFX, "ref.fa"), "--taxonomy-tree",
            os.path.join(PFX, "nodes.dmp"), "--name-table", os.path.join(PFX, "names.dmp"),
            "--conversion-table", os.path.join(PFX, "ref_seqid.map"), "--protein",
            "-o", prefix]) == 0
    (jfm, jtax), (fm, tax) = jax_load_index(prefix)[:2], load_index(prefix)[:2]
    return (jfm, jtax, DeviceFM(jfm)), (fm, tax, TorchFM.from_index(fm, "cpu"), prefix)


def protein_queries(case):
    """-k 0: the fixture's nucleotide reads, paired with later ones, one mate
    empty.  long: the fixture's reads end to end, 10,000 bp (over the fused
    engine's 8,192), beside one short unit.  mixed: pairs and single reads in
    one batch, one mate empty."""
    reads = []
    with open(os.path.join(PFX, "reads_1.fq")) as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                reads.append(np.frombuffer(line.strip().encode(), np.uint8))
    if case == "long":
        return [(np.concatenate(reads * 2), None), (reads[7], None)]
    qs = [(reads[i], reads[24 + i]) for i in range(24)]
    qs[5] = (qs[5][0], np.zeros(0, np.uint8))
    if case == "mixed":
        qs = [(r1, None) if i % 3 == 1 else (r1, r2) for i, (r1, r2) in enumerate(qs)]
    return qs


@pytest.mark.parametrize("case", ["k0", "long", "mixed"])
def test_unfused_protein_matches_jax(protein_index, case, monkeypatch):
    """The translated search of the non-fused engine against ClassifierJax's,
    and ClassifierTorch (which hands it the batch, or, mixed, runs it on the
    fused program) against ClassifierFused."""
    from centrifuger_tpu.classify import engine_jax
    from centrifuger_tpu.classify.engine_fused import ClassifierFused
    from centrifuger_tpu.classify.engine_jax import ClassifierJax
    from centrifuger_tpu.classify.params import ClassifierParam as JaxParam
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.engine_unfused import ClassifierTorchUnfused
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    monkeypatch.setattr(engine_jax, "_bucket_size",
                        lambda x, floor=4096: engine_jax._next_pow2(max(x, 8)))
    (jfm, jtax, jdev), (fm, tax, tdev, _) = protein_index
    p = PARAMS[case]
    qs = protein_queries(case)
    if case == "long":
        assert len(qs[0][0]) > port_fused_l_max()
    want = ClassifierJax(jfm, jtax, JaxParam(**p), protein=True, dev=jdev).query_batch(qs)
    port = ClassifierTorchUnfused(fm, tax, ClassifierParam(**p), protein=True, dev=tdev)
    got = port.query_batch(qs)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _results_equal(w, g), i
    assert sum(len(w.tax_ids) > 0 for w in want) >= len(qs) // 2
    if case == "k0":
        assert max(len(w.tax_ids) for w in want) > 1
    jfused = ClassifierFused(jfm, jtax, JaxParam(**p), protein=True, dev=jdev)
    fused = ClassifierTorch(fm, tax, ClassifierParam(**p), protein=True, dev=tdev)
    for i, (g, w) in enumerate(zip(fused.query_batch(qs), jfused.query_batch(qs))):
        assert _results_equal(w, g), i


def _hit(l, k):
    return (k, k + 1, l, k)


A20, B15, C20, D25, E15, F20, G25 = (_hit(l, k) for k, l in enumerate(
    (20, 15, 20, 25, 15, 20, 25), 1))
# case -> (mate 2, {lane - lane0: chains}, the chosen (hit, strand) list);
# min_hit_len 10, so a hit of l scores (l - 5)^2: 15 -> 100, 20 -> 225, 25 -> 400
CHOICES = {
    # plus frames 0 and 1 tie (1 x 225): the earlier wins; plus 225 > minus 100
    "frame_tie": (False, {0: [A20], 1: [C20], 3: [B15]}, [(A20, 1)]),
    # minus takes frame 5 (2 x 325) over frame 3 (1 x 225); 325 = 325 keeps
    # both strands, plus first
    "strand_tie": (False, {1: [A20, B15], 3: [C20], 5: [F20, E15]},
                   [(A20, 1), (B15, 1), (F20, -1), (E15, -1)]),
    # read 2's reverse-complement frames (9-11) join plus, its forward frames
    # (6-8) minus: 225 + 400 against 225
    "mate2_joins_opposite": (True, {0: [A20], 6: [C20], 9: [D25]}, [(A20, 1), (D25, 1)]),
    # no mate 2: its lanes, were they read, would tip the strands
    "no_mate2": (False, {0: [A20], 3: [B15], 6: [D25], 9: [G25]}, [(A20, 1)]),
}


@pytest.mark.parametrize("case", sorted(CHOICES))
def test_translated_choice(protein_index, case):
    """The frame-and-strand choice both engines share (_translated_choice)
    on hand-made chains of the second unit of a batch, directly and through
    the fused engine's flagged-unit path, which is held to ClassifierFused's
    on the same chains."""
    from centrifuger_tpu.classify.engine_fused import ClassifierFused
    from centrifuger_tpu.classify.params import ClassifierParam as JaxParam
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    (jfm, jtax, jdev), (fm, tax, tdev, _) = protein_index
    mate2, lanes, want = CHOICES[case]
    table = {12 + k: v for k, v in lanes.items()}
    table.update({k: [_hit(40, 100 + k)] for k in range(12)})   # unit 0's
    hits_at = lambda lane: list(table.get(lane, []))
    port = ClassifierTorch(fm, tax, ClassifierParam(min_hit_len=10), protein=True, dev=tdev)
    assert port._translated_choice(hits_at, 12, mate2) == want
    r = np.frombuffer(b"ACGTTGCA" * 6, np.uint8)
    qs = [(r, r), (r, r if mate2 else None)]
    [(qi, hs, qlen)] = port._fallback_unit_hits_protein(qs, np.array([1]), hits_at, 2)
    assert (qi, qlen) == (1, 96 if mate2 else 48)
    got = [(h.sp, h.ep, h.l, h.offset, h.strand) for h in hs]
    assert got == [h + (s,) for h, s in want]
    jfused = ClassifierFused(jfm, jtax, JaxParam(min_hit_len=10), protein=True, dev=jdev)
    [(jqi, jhs, jqlen)] = jfused._fallback_unit_hits_protein(qs, np.array([1]), hits_at, 2)
    assert (jqi, jqlen) == (qi, qlen)
    assert [(h.sp, h.ep, h.l, h.offset, h.strand) for h in jhs] == got
