"""The port's sharded index (kernel K10) and data-parallel step (kernel K11)
against centrifuger_tpu.parallel on the CPU, exactly (integers, tolerance 0).

ShardedIndex over D CPU shards is held to the JAX ShardedIndex on the
8-device virtual CPU mesh of conftest.py (D = 2 and 8): chain search, fused
classify, resolve with and without the rowmap, the routed gather itself and
the per-shard memory contract; ClassifierTorch on a ShardedIndex to
ClassifierFused on the JAX one; classify_dp_step over two devices to the JAX
step on a 2-device mesh.  int64 sharded indexes are held to the port's
unsharded int64 results, which tests/test_torch_int64.py holds to JAX.  The
CLI's --shards gives the goldens, ignores a protein index and refuses the
runblock layout, as the JAX CLI does.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from centrifuger_tpu.fm.builder import FMBuildParams, build_fm
from centrifuger_tpu.fm.device import DeviceFM
from centrifuger_tpu.parallel import mesh as jax_mesh
from centrifuger_tpu.parallel import sharded as jax_sharded
from centrifuger_tpu.testutil import synthetic_fm, sample_reads
from centrifuger_tpu_torch.classify import device_engine as de
from centrifuger_tpu_torch.fm import device as fd
from centrifuger_tpu_torch.fm.device import TorchFM, fm_arrays
from centrifuger_tpu_torch.parallel.mesh import _replica, classify_dp_step, make_mesh
from centrifuger_tpu_torch.parallel.sharded import ShardedIndex, routed_gather

from conftest import FIXTURE_DIR
from test_sharded import _codes
from test_torch_kernels import pack_reads
from test_torch_protein import protein_prefix  # noqa: F401 (a fixture)

torch.set_num_threads(1)   # the suite runs in several worker processes

MHL = 23
CPU = ["cpu"]


def needs_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh of conftest.py")


@pytest.fixture(scope="module")
def index():
    """tests/test_sharded.py's index (3 genomes of 9 kb) built with a rowmap,
    its reads, and the same index without the rowmap."""
    _, genomes = synthetic_fm(n_genomes=3, genome_len=9000, seed=13)
    fm = build_fm(np.concatenate(genomes), [len(g) for g in genomes], np.arange(3), "ACGT",
                  FMBuildParams(row_map=True))
    bare = build_fm(np.concatenate(genomes), [len(g) for g in genomes], np.arange(3),
                    "ACGT", FMBuildParams())
    return {True: fm, False: bare}, sample_reads(genomes, 16, 100, seed=14)


def both(fm, D):
    """(the JAX ShardedIndex on a D-device mesh, the port's on D CPU shards)."""
    jsh = jax_sharded.ShardedIndex(DeviceFM(fm), jax_mesh.make_mesh(n_devices=D), axis="dp")
    return jsh, ShardedIndex(fm_arrays(fm), D, CPU)


@pytest.mark.parametrize("D", [2, 8])
def test_chain_search_matches_jax_sharded(index, D):
    needs_mesh()
    fms, reads = index
    codes, lengths = _codes(reads)
    jsh, sh = both(fms[True], D)
    want = jsh.chain_search(codes, lengths, MHL, 8)
    hits, nhits = fd.chain_search_lanes(sh, torch.from_numpy(codes),
                                        torch.from_numpy(lengths), MHL, 8)
    got = dict(nhits=nhits, sp=hits[:, :, 0], ep=hits[:, :, 1], l=hits[:, :, 2],
               off=hits[:, :, 3])
    for k in ("nhits", "sp", "ep", "l", "off"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (D, k)
    assert int(nhits.sum()) > 0
    # the memory contract: a shard holds about total / D (pad rows only)
    per, total = sh.per_shard_bytes()
    assert per <= total / D * 1.05 + 4096, (D, per, total)
    jper, jtotal = jsh.per_chip_bytes()
    assert (per, total) == (jper, jtotal)


@pytest.mark.parametrize("rowmap", [True, False])
@pytest.mark.parametrize("D", [2, 8])
def test_fused_classify_matches_jax_sharded(index, D, rowmap):
    needs_mesh()
    fms, reads = index
    L, U = 128, len(reads)
    H = L // (MHL + 1) + 1
    pack2, vmask, lengths = pack_reads(reads, L)
    jsh, sh = both(fms[rowmap], D)
    want = jsh.fused_classify((jnp.asarray(pack2), jnp.asarray(vmask)), jnp.asarray(lengths),
                              1, MHL, H, 1, 40, 8, U * 8)
    got = de.fused_classify(sh, torch.from_numpy(pack2), torch.from_numpy(vmask),
                            torch.from_numpy(lengths), 1, MHL, H, 1, 40, 8, U * 8)
    for k in ("packed", "hits", "nhits"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (D, k)
    assert int(got["nhits"].sum()) > 0


@pytest.mark.parametrize("rowmap", [True, False])
@pytest.mark.parametrize("D", [2, 8])
def test_resolve_rows_matches_jax_sharded(index, D, rowmap):
    needs_mesh()
    fm = index[0][rowmap]
    rows = np.arange(0, fm.n, 97, dtype=np.int64)[:64]
    rows[:4] = [0, fm.n - 1, fm.first_isa, 16]
    valid = np.ones(len(rows), bool)
    valid[5] = False
    jsh, sh = both(fm, D)
    want = np.asarray(jsh.resolve_rows(rows.astype(np.int32), valid))
    got = fd.resolve_rows(sh, torch.from_numpy(rows.astype(np.int32)),
                          torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), want)
    assert (sh.rowmap is not None) == rowmap


@pytest.mark.parametrize("width", [None, 3])
@pytest.mark.parametrize("D", [2, 8])
def test_routed_gather_matches_jax(D, width):
    """K10's plain version against _routed_gather under shard_map, ids out
    of range included (they give 0)."""
    needs_mesh()
    from jax import shard_map
    rng = np.random.default_rng(D)
    n = 53
    table = rng.integers(1, 1 << 30, (n,) if width is None else (n, width)).astype(np.int32)
    rps = -(-n // D)
    padded = np.zeros((rps * D,) + table.shape[1:], np.int32)
    padded[:n] = table
    idx = rng.integers(0, n, 8 * D)
    idx[:4] = [-1, rps * D, rps * D + 7, n]     # out of range, and a pad row
    spec = P("dp", *([None] * (table.ndim - 1)))
    fn = shard_map(lambda t, i: jax_sharded._routed_gather(t, i, rps, "dp"),
                   mesh=jax_mesh.make_mesh(n_devices=D), in_specs=(spec, P("dp")),
                   out_specs=spec, check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(padded), jnp.asarray(idx.astype(np.int32))))
    shards = list(torch.from_numpy(padded).split(rps))
    got = routed_gather(shards, torch.from_numpy(idx), rps)
    assert np.array_equal(got.numpy(), want)
    assert not got[:4].any()


def test_unrouted_access_raises(index):
    sh = ShardedIndex(fm_arrays(index[0][True]), 3, CPU)
    for name in ("rows", "rowmap", "sampled_sa"):
        table = getattr(sh, name)
        assert table is not None
        with pytest.raises(RuntimeError, match="without routing"):
            table[torch.tensor([0])]
        with pytest.raises(RuntimeError, match="without routing"):
            len(table)
    assert sh.layout == "plain_sharded" and sh.n_shards == 3


def test_sharded_index_from_a_torch_fm_keeps_no_whole_table(index):
    fm = index[0][True]
    tfm = TorchFM(fm_arrays(fm), device="cpu")
    sh = ShardedIndex(tfm, 4, CPU)
    per, total = sh.per_shard_bytes()
    whole = sum(getattr(tfm, k).numel() * getattr(tfm, k).element_size()
                for k in ("rows", "rowmap", "sampled_sa"))
    assert whole <= total <= whole + 4 * 3 * 512 and per <= total / 4 + 512
    assert sh.per_device_bytes() == {"cpu": total + sh.replicated_bytes()}
    assert all(t.data_ptr() != getattr(tfm, k).data_ptr()
               for k, ts in sh.shards.items() for t in ts)
    with pytest.raises(ValueError, match="plain serving layout"):
        ShardedIndex(TorchFM(fm_arrays(fm), device="cpu", serve_layout="runblock"), 2, CPU)


def test_over_devices_splits_whole_units(index):
    """fused_classify over several devices: each takes its run of whole units
    and the outputs are gathered in unit order.  Three views of the CPU stand
    for three cards."""
    fms, reads = index
    sh = ShardedIndex(fm_arrays(fms[True]), 2, CPU)
    L = 128
    H = L // (MHL + 1) + 1
    pack2, vmask, lengths = (torch.from_numpy(a) for a in pack_reads(reads, L))
    want = de.fused_classify(sh, pack2, vmask, lengths, 2, MHL, H, 1, 40, 8, 8 * 8)
    sh.views = [sh, sh, sh]
    got = de.fused_classify(sh, pack2, vmask, lengths, 2, MHL, H, 1, 40, 8, 8 * 8)
    for k in ("packed", "hits", "nhits", "host_blob"):
        assert torch.equal(got[k], want[k]), k


def test_classifier_on_sharded_index_matches_jax(tmp_path_factory):
    """ClassifierTorch on a ShardedIndex against ClassifierFused on the JAX
    ShardedIndex (tests/test_sharded.py::test_sharded_engine_end_to_end)."""
    needs_mesh()
    from test_golden_classify import get_index
    from centrifuger_tpu.build import load_index as jax_load_index
    from centrifuger_tpu.classify.engine_fused import ClassifierFused
    from centrifuger_tpu.classify.params import ClassifierParam as JaxParam
    from centrifuger_tpu.io.fastq_fast import iter_fastq_batches
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.params import ClassifierParam

    prefix = get_index("tiny", tmp_path_factory)
    jfm, jtax, _, _ = jax_load_index(prefix)
    _, queries = next(iter_fastq_batches(os.path.join(FIXTURE_DIR, "tiny", "reads_1.fq"), 64))
    jcl = ClassifierFused(jfm, jtax, JaxParam())
    jsh = jax_sharded.ShardedIndex(jcl.dev, jax_mesh.make_mesh(n_devices=8), axis="dp")
    want = ClassifierFused(jfm, jtax, JaxParam(), dev=jsh).query_batch(queries)
    fm, tax, _, _ = load_index(prefix)
    sh = ShardedIndex(fm_arrays(fm), 8, CPU)
    got = ClassifierTorch(fm, tax, ClassifierParam(), dev=sh).query_batch(queries)
    assert len(want) == len(got) == len(queries)
    for w, g in zip(want, got):
        assert (w.score, w.secondary_score, w.hit_length, w.tax_ids, w.seq_names) == \
            (g.score, g.secondary_score, g.hit_length, g.tax_ids, g.seq_names)


def test_classify_dp_step_matches_jax(index):
    """K11 over two devices against the JAX step on a 2-device mesh."""
    needs_mesh()
    fms, reads = index
    fm = fms[False]           # the LF-walk resolve of the start rows
    codes, lengths = _codes(reads)
    want = jax_mesh.classify_dp_step(DeviceFM(fm), jax_mesh.make_mesh(n_devices=2), MHL,
                                     8)(codes, lengths)
    step = classify_dp_step(TorchFM(fm_arrays(fm), device="cpu"), ["cpu", "cpu"], MHL, 8)
    got = step(torch.from_numpy(codes), torch.from_numpy(lengths))
    for k in ("nhits", "sp", "ep", "l", "off", "seqids", "total_hits"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert int(got["total_hits"]) == int(got["nhits"].sum()) > 0
    assert make_mesh(devices=["cpu", "cpu"], n_devices=1) == [torch.device("cpu")]


def test_dp_replica_keeps_the_original_and_counts_its_own_traffic(index):
    """classify_dp_step's replica of an index for another device: its
    buffers, the generic layout's sub-tables' included, move and the
    original's stay; its sub-tables count traffic on the replica; on the
    original's device it gives the original's results."""
    fms, reads = index
    fm = TorchFM(fm_arrays(fms[False]), device="cpu", _generic=True)
    assert fm.ind is not None
    moved = _replica(fm, torch.device("meta"))
    assert all(t.device.type == "meta" for t in moved.buffers())
    assert all(t.device.type == "cpu" for t in fm.buffers())
    rep = _replica(fm, torch.device("cpu"))
    codes, lengths = (torch.from_numpy(a) for a in _codes(reads))
    rep.traffic = 0
    got = fd.chain_search_lanes(rep, codes, lengths, MHL, 8)
    assert fm.traffic is None and rep.traffic > 0
    fm.traffic = 0
    want = fd.chain_search_lanes(fm, codes, lengths, MHL, 8)
    assert fm.traffic == rep.traffic
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("rowmap", [True, False])
def test_int64_sharded_matches_unsharded_int64(index, rowmap):
    """int64 x sharded (K9 x K10): the fused program, the chains of code
    lanes and the resolve equal the port's unsharded int64 index's."""
    fms, reads = index
    fields = fm_arrays(fms[rowmap])
    tfm = TorchFM(fields, device="cpu", force_idtype="int64")
    sh = ShardedIndex(fields, 3, CPU, force_idtype="int64")
    assert sh.idtype == torch.int64
    L = 128
    H = L // (MHL + 1) + 1
    pack2, vmask, lengths = (torch.from_numpy(a) for a in pack_reads(reads, L))
    want = de.fused_classify(tfm, pack2, vmask, lengths, 1, MHL, H, 1, 40, 8, 16 * 8)
    got = de.fused_classify(sh, pack2, vmask, lengths, 1, MHL, H, 1, 40, 8, 16 * 8)
    for k in ("packed", "hits", "nhits", "host_blob"):
        assert torch.equal(got[k], want[k]), k
    codes, clen = (torch.from_numpy(a) for a in _codes(reads))
    got, want = fd.chain_search_lanes(sh, codes, clen, MHL, 8), \
        fd.chain_search_lanes(tfm, codes, clen, MHL, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    rows = torch.arange(0, fms[rowmap].n, 37, dtype=torch.int64)
    valid = torch.ones(len(rows), dtype=torch.bool)
    assert torch.equal(fd.resolve_rows(sh, rows, valid), fd.resolve_rows(tfm, rows, valid))


def test_sharded_index_defaults_to_cuda_and_raises_without_it(index):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default devices do not raise")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedIndex(fm_arrays(index[0][True]), 2)


# ---------------------------------------------------------------- the CLI

def run_cli(fx, prefix, extra, paired=True):
    from test_torch_golden import run_port_cli
    return run_port_cli(fx, prefix, extra, paired)


def golden(fx, tag="k1"):
    with open(os.path.join(FIXTURE_DIR, fx, "golden_class_%s.tsv" % tag)) as f:
        return f.read()


@pytest.mark.parametrize("extra", [
    ["--shards", "2", "--batch-size", "64"],
    ["--shards", "4", "--batch-size", "64", "--no-rowmap"],
    ["--engine", "jax", "--shards", "2"],
])
def test_cli_shards_golden(tmp_path_factory, extra):
    """tests/test_cli_serve_modes.py's --shards cases through the port's CLI
    on the CPU (sorted lines, as there; the port's TSV is in order too)."""
    from test_torch_golden import port_index
    out = run_cli("tiny", port_index("tiny", tmp_path_factory), extra)
    assert sorted(out.splitlines()) == sorted(golden("tiny").splitlines()), extra
    assert out == golden("tiny")


def test_cli_shards_ignored_for_protein(protein_prefix):
    out = run_cli("tiny_protein", protein_prefix, ["--shards", "2"], paired=False)
    assert out == golden("tiny_protein")


def test_cli_shards_refuse_runblock(capsys):
    from centrifuger_tpu_torch.cli import classify_cli
    prefix = os.path.join(FIXTURE_DIR, "tiny", "none")
    with pytest.raises(SystemExit) as e:
        classify_cli.main(["-x", prefix, "-u", "r.fq", "--device", "cpu", "--shards", "2",
                           "--serve-layout", "runblock"])
    assert e.value.code != 0
    assert "plain serving layout" in capsys.readouterr().err


def test_cli_rounds_the_batch_to_the_shards(tmp_path_factory, monkeypatch):
    """--batch-size rounds up to a multiple of --shards, as the JAX CLI's does,
    and the make_classifier the CLI calls gets the shard count."""
    from test_torch_golden import port_index
    from centrifuger_tpu_torch.cli import classify_cli
    sizes, made = [], []
    batch_queries = classify_cli._batch_queries
    make = classify_cli.make_classifier

    def spy_batch(batch, *rest):
        sizes.append(len(batch))
        return batch_queries(batch, *rest)

    def spy_make(*a, **k):
        made.append(k["shards"])
        return make(*a, **k)
    monkeypatch.setattr(classify_cli, "_batch_queries", spy_batch)
    monkeypatch.setattr(classify_cli, "make_classifier", spy_make)
    out = run_cli("tiny", port_index("tiny", tmp_path_factory),
                  ["--shards", "3", "--batch-size", "16"])
    assert out == golden("tiny")
    assert sizes == [18, 18, 18, 6] and made == [3]
