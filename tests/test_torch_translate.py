"""The fused protein engine's six-frame translation (kernel K13): the flat
pack (ClassifierTorch._pack_reads_protein_flat) and translate_lanes against
the host pack it replaces on the fused path (_pack_reads_protein, which
tests/test_torch_protein.py holds to the JAX package), byte for byte.

The CPU tests run the plain twin; the tests marked `cuda` run the kernel on
the card against the twin (they skip without one) and import no JAX:

  python -m pytest --noconftest -m cuda tests/test_torch_translate.py
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from centrifuger_tpu_torch import kernels
from centrifuger_tpu_torch.classify import device_engine as de

torch.set_num_threads(1)   # the suite runs in several worker processes

PFX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "tiny_protein")
CASES = ("single", "paired", "none_mate", "short", "mixed_long", "odd_bytes", "one_long")


def fixture_reads():
    reads = []
    with open(os.path.join(PFX, "reads_1.fq")) as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                reads.append(np.frombuffer(line.strip().encode(), np.uint8).copy())
    reads[3][10:14] = ord("N")
    return reads


def random_read(rng, n, alphabet=b"ACGTN", p=(0.24, 0.24, 0.24, 0.24, 0.04)):
    return rng.choice(np.frombuffer(alphabet, np.uint8), n, p=p)


def make_case(case, seed=0):
    """Queries of one case: the fixture's reads single-end and paired (an N
    read, an empty mate), a None mate, mates of 0-5 bases, mixed lengths up
    to 8,192, bytes other than ACGTN, and one mate of 8,192 among 1,199 of
    150."""
    rng = np.random.default_rng(seed)
    reads = fixture_reads()
    if case == "single":
        return [(r, None) for r in reads[:40]]
    if case == "paired":
        qs = [(reads[i], reads[-1 - i][:60 + i % 40]) for i in range(40)]
        qs[5] = (qs[5][0], np.zeros(0, np.uint8))
        return qs
    if case == "none_mate":
        return [(reads[i], None if i % 3 == 0 else reads[i + 1]) for i in range(30)]
    if case == "short":
        return [(random_read(rng, a), random_read(rng, b)) for a in range(6) for b in range(6)]
    if case == "mixed_long":
        lens = [8192, 8191, 8190, 1, 0, 150, 299, 3000, 4097, 17, 32, 95, 96, 97]
        return [(random_read(rng, n), random_read(rng, int(rng.integers(0, 8193))))
                for n in lens]
    if case == "one_long":     # L 2,752 for every lane: the twin takes several chunks
        qs = [(random_read(rng, 150), random_read(rng, 150)) for _ in range(600)]
        qs[300] = (random_read(rng, 8192), qs[300][1])
        return qs
    if case == "odd_bytes":
        return [(random_read(rng, int(rng.integers(0, 200)), b"ACGTNaR.",
                             (0.2, 0.2, 0.2, 0.2, 0.05, 0.05, 0.05, 0.05)),
                 random_read(rng, int(rng.integers(0, 200)), b"acgtnR.C",
                             (0.1,) * 6 + (0.2, 0.2)))
                for _ in range(40)]
    raise ValueError(case)


def full_batch(seed=1, pairs=8192):
    """A serving batch: 8,192 pairs of 2 x 150 bases, 1% N."""
    rng = np.random.default_rng(seed)
    p = (0.2475,) * 4 + (0.01,)
    return [(random_read(rng, 150, p=p), random_read(rng, 150, p=p)) for _ in range(pairs)]


def protein_classifier(tmp_path_factory, device):
    """ClassifierTorch on tiny_protein indexed by the port's build_cli (--protein)."""
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    from centrifuger_tpu_torch.cli import build_cli
    prefix = str(tmp_path_factory.mktemp("translate_protein") / "idx")
    with contextlib.redirect_stderr(io.StringIO()):
        assert build_cli.main([
            "-r", os.path.join(PFX, "ref.fa"), "--taxonomy-tree",
            os.path.join(PFX, "nodes.dmp"), "--name-table", os.path.join(PFX, "names.dmp"),
            "--conversion-table", os.path.join(PFX, "ref_seqid.map"), "--protein",
            "-o", prefix]) == 0
    fm, tax, _, _ = load_index(prefix)
    return ClassifierTorch(fm, tax, ClassifierParam(), protein=True, device=device)


def translated(eng, queries, device="cpu"):
    """(codes, lengths, nr, L) through the flat pack and translate_lanes on
    `device`, as numpy arrays."""
    flat, starts, nr, L = eng._pack_reads_protein_flat(queries)
    codes, lengths = de.translate_lanes(torch.from_numpy(flat).to(device),
                                        torch.from_numpy(starts).to(device), L,
                                        eng._frame_table.to(device))
    if device != "cpu":
        torch.cuda.synchronize()
    return codes.cpu().numpy(), lengths.cpu().numpy(), nr, L


def assert_lanes_equal(got, want):
    codes, lengths, nr, L = got
    wcodes, wlengths, wnr, wL = want
    assert (nr, L) == (wnr, wL)
    assert codes.shape == wcodes.shape and codes.dtype == np.uint8
    assert np.array_equal(lengths, wlengths) and lengths.dtype == np.int32
    assert np.array_equal(codes, wcodes)


# ------------------------------------------------------------- on the CPU

@pytest.fixture(scope="module")
def cpu_engine(tmp_path_factory):
    return protein_classifier(tmp_path_factory, "cpu")


@pytest.mark.parametrize("case", CASES)
def test_flat_pack_and_twin_match_the_host_pack(cpu_engine, case):
    queries = make_case(case)
    want = cpu_engine._pack_reads_protein(queries)
    assert_lanes_equal(translated(cpu_engine, queries), want)
    flat, starts, nr, _ = cpu_engine._pack_reads_protein_flat(queries)
    assert starts.dtype == np.int32 and len(starts) == len(queries) * nr + 1
    assert flat.dtype == np.uint8 and len(flat) == starts[-1]


@pytest.mark.parametrize("mates", [1, 2, 7])
def test_twin_chunks_agree(cpu_engine, monkeypatch, mates):
    """The twin in chunks of 1, 2 or 7 mates gives its lanes whole."""
    queries = make_case("paired")
    want = translated(cpu_engine, queries)
    monkeypatch.setattr(de, "PLAIN_CHUNK", mates * 3 * want[3] + 2)
    assert_lanes_equal(translated(cpu_engine, queries), want)


@pytest.mark.parametrize("paired", [False, True])
def test_protein_dispatch_translates_as_the_host_pack(cpu_engine, paired):
    """The fused dispatch (flat pack, upload, translate_lanes) gives the rows
    and chains of fused_classify_protein on _pack_reads_protein's lanes."""
    eng = cpu_engine
    queries = make_case("paired" if paired else "single")
    codes, lengths, nr, L = eng._pack_reads_protein(queries)
    mhl = eng.param.min_hit_len
    want = de.fused_classify_protein(
        eng.dev, torch.from_numpy(codes), torch.from_numpy(lengths), nr, mhl,
        L // (mhl + 1) + 1, eng.param.max_result, eng.param.max_result_per_hit_factor,
        eng.K_OUT, len(queries) * eng.U_CAP)
    got = eng._dispatch_fused(queries)["out"]
    for key in ("packed", "hits", "nhits", "host_blob"):
        assert torch.equal(got[key], want[key]), key
    assert (got["packed"][:, 3] > 0).sum() > len(queries) // 2    # most units classified


def test_translate_lanes_checks_its_arguments(cpu_engine):
    flat, starts, _, L = cpu_engine._pack_reads_protein_flat(make_case("single"))
    flat, starts, table = torch.from_numpy(flat), torch.from_numpy(starts), \
        cpu_engine._frame_table
    with pytest.raises(TypeError):
        de.translate_lanes(flat, starts.long(), L, table)
    with pytest.raises(TypeError):
        de.translate_lanes(flat.int(), starts, L, table)
    with pytest.raises(ValueError):
        de.translate_lanes(flat, starts, L + 2, table)
    with pytest.raises(ValueError):
        de.translate_lanes(flat, starts, L, table[:-1])
    codes, lengths = de.translate_lanes(flat, starts[:1], L, table)     # no mates
    assert codes.shape == (0, L) and lengths.shape == (0,)


# --------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def gpu_engine(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return protein_classifier(tmp_path_factory, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ("full_batch",))
def test_translate_kernel_matches_twin(gpu_engine, case):
    queries = full_batch() if case == "full_batch" else make_case(case)
    assert_lanes_equal(translated(gpu_engine, queries, "cuda"),
                       translated(gpu_engine, queries))


@pytest.mark.cuda
def test_protein_batches_launch_translate_once_each(gpu_engine):
    """Every fused protein batch launches K13 once, and the rows equal the
    CPU twins'."""
    batches = [make_case(c, seed=s) for s, c in enumerate(("paired", "single", "odd_bytes"))]
    kernels.reset_launches()
    got = list(gpu_engine.query_pipelined_packed(batches))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["translate_frames"] == len(batches)
    cpu = protein_classifier_cpu_twin(gpu_engine)
    for (packed, _, _), queries in zip(got, batches):
        want = cpu._dispatch_fused(queries)["out"]["packed"].numpy()
        assert np.array_equal(packed, want)


def protein_classifier_cpu_twin(eng):
    """The same index and parameters on the CPU (the twins)."""
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    return ClassifierTorch(eng.fm, eng.tax, eng.param, protein=True, device="cpu")


@pytest.mark.cuda
def test_profiler_keeps_the_translate_kernel(gpu_engine):
    """cfr_bench/trace.py counts a kernel's events by `<name>_kernel<`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gpu_engine.query_batch(make_case("paired"))       # built and loaded
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gpu_engine.query_batch(make_case("paired"))
        torch.cuda.synchronize()
    names = [m.group(1) for e in prof.events() if e.device_type == DeviceType.CUDA
             for m in [re.search(r"(\w+)_kernel<", e.name)] if m]
    assert kernels.LAUNCHES["translate_frames"] == 1
    assert names.count("translate_frames") == 1
