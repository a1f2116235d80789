"""int64 indexes in the port (kernel K9's plain twins) against centrifuger_tpu
on the CPU, exactly (integers, tolerance 0).

TorchFM(force_idtype="int64") is held to DeviceFM(force_idtype="int64") on
its tables, chain_search, resolve_rows (rowmap and LF walk), prefix_search
and fused_classify, for the plain layout, for runblock (which an int64 index
serves as generic), for protein and for a wide-ftab index, and to the port's
own int32 results.  DeviceFM needs jax_enable_x64 for int64, which is
process-global, so the JAX side runs in subprocesses (one per index) that
write their arrays to .npz files; the inputs are made here with numpy.

The 40-bit occ that only an index of 2^32 symbols reaches is checked on
offset rows (fm/device.py:offset_wide_rows), the forced-int64 goldens go
through the CLI, and the guards and the host blob are checked on their own.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from centrifuger_tpu.fm.builder import FMBuildParams, build_fm
from centrifuger_tpu.testutil import synthetic_fm, sample_reads
from centrifuger_tpu_torch.classify import device_engine as de
from centrifuger_tpu_torch.fm import device as fd
from centrifuger_tpu_torch.fm.device import TorchFM, fm_arrays

# (the JAX subprocesses import this module for build_case: what it imports
# at the top stays light, the CLI helpers are imported where they are used)
from test_torch_kernels import PROTEIN_ALPHABET, pack_reads, synthetic_protein_fm

torch.set_num_threads(1)   # the suite runs in several worker processes

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
CASES = ("plain", "runblock", "protein", "wideftab")
OFFSET = 5 * 2 ** 32 + 12345          # the offset-rows constant O
MHL = {"protein": 11}                 # min hit length per case (default 23)
ENC = np.full(256, 255, np.uint8)
ENC[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def build_case(case):
    """(FMIndexData with a rowmap, genomes or records) of one test index:
    the same in this process and in the JAX subprocesses."""
    if case == "protein":
        _, recs = synthetic_protein_fm()
        params = FMBuildParams(precompute_width=4, has_end_marker=True, row_map=True)
        return build_fm(np.concatenate(recs), [len(r) for r in recs],
                        np.arange(len(recs)), PROTEIN_ALPHABET, params), recs
    _, genomes = synthetic_fm(n_genomes=3, genome_len=9000, seed=21)
    params = FMBuildParams(sample_rate=16, row_map=True,
                           precompute_width=12 if case == "wideftab" else 10)
    return build_fm(np.concatenate(genomes), [len(g) for g in genomes],
                    np.arange(len(genomes)), "ACGT", params), genomes


def serve_layout(case):
    return "runblock" if case == "runblock" else "plain"


def make_inputs(case, parts):
    """Seeded inputs of every primitive: chain lanes, SA rows, prefix lanes,
    the fused program's reads and, on the plain index, rank queries."""
    rng = np.random.default_rng(CASES.index(case))
    fm = parts[0]
    out = {}
    if case == "protein":
        recs = parts[1]
        Q, nr, L = 16, 1, 64
        B = 6 * nr * Q
        codes = np.full((B, L), 255, np.uint8)
        lengths = np.zeros(B, np.int32)
        for i in range(B):
            r = recs[rng.integers(0, len(recs))]
            ln = int(rng.integers(0, L + 1))
            p = int(rng.integers(0, max(len(r) - ln, 1)))
            frag = r[p:p + ln].copy()
            frag[rng.random(len(frag)) < 0.03] = rng.integers(1, 21)
            codes[i, :len(frag)] = frag
            lengths[i] = len(frag)
        out.update(codes=codes, lengths=lengths, fused_codes=codes, fused_lengths=lengths,
                   nr=np.int32(nr))
    else:
        reads = sample_reads(parts[1], 48, 100, seed=int(rng.integers(1 << 30)), err=0.01)
        L = 128
        codes = np.full((2 * len(reads), L), 255, np.uint8)
        lengths = np.zeros(2 * len(reads), np.int32)
        for i, r in enumerate(reads):
            c = ENC[np.asarray(r, np.uint8)]
            codes[2 * i, :len(c)] = c
            codes[2 * i + 1, :len(c)] = np.where(c == 255, 255, 3 - c)[::-1]
            lengths[2 * i:2 * i + 2] = len(c)
        pack2, vmask, plen = pack_reads(reads, L)
        out.update(codes=codes, lengths=lengths, pack2=pack2, vmask=vmask, plen=plen,
                   nr=np.int32(2))
    rows = np.concatenate([[0, fm.first_isa, fm.n - 1],
                           rng.integers(0, fm.n, 125)]).astype(np.int64)
    out.update(rows=rows, valid=rng.random(len(rows)) < 0.9)
    ms = np.minimum(out["lengths"], rng.integers(0, out["codes"].shape[1] + 1,
                                                  len(out["lengths"])))
    out.update(ms=ms.astype(np.int32))
    if case == "plain":
        pos = np.concatenate([[-1, 0, fm.n - 1, 1918, 1919, 1920],
                              rng.integers(0, fm.n, 506)]).astype(np.int64)
        out.update(rank_c=rng.integers(0, 4, len(pos)).astype(np.int64), rank_pos=pos)
    return out


# The JAX side of one case, under x64 in its own process.
SCRIPT = r'''
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import jax.numpy as jnp
from centrifuger_tpu.fm.device import DeviceFM
from test_torch_int64 import build_case, serve_layout, MHL

case, inp, outp = sys.argv[3], sys.argv[4], sys.argv[5]
fm, _ = build_case(case)
x = dict(np.load(inp))
out = {}
mhl = MHL.get(case, 23)
H = x["codes"].shape[1] // (mhl + 1) + 1
dev = DeviceFM(fm, serve_layout=serve_layout(case), force_idtype="int64")
assert jax.config.jax_enable_x64 and dev.idtype == jnp.int64
for k, v in dev.arrs.items():
    out["arr_" + k] = np.asarray(v)
cs = dev.chain_search(x["codes"], x["lengths"], mhl, H)
for k in ("sp", "ep", "l", "off", "nhits"):
    out["chain_" + k] = np.asarray(cs[k])
out["resolve_rowmap"] = np.asarray(dev.resolve_rows(x["rows"], x["valid"]))
out["prefix"] = np.stack([np.asarray(t) for t in dev.prefix_search(x["codes"], x["ms"])])
nr = int(x["nr"])
if case == "protein":
    Q = len(x["fused_codes"]) // (6 * nr)
    f = dev.fused_classify(x["fused_codes"], x["fused_lengths"], nr, mhl, H, 1, 40, 8,
                           Q * 8, protein=True)
else:
    Q = len(x["plen"]) // nr
    f = dev.fused_classify((jnp.asarray(x["pack2"]), jnp.asarray(x["vmask"])),
                           jnp.asarray(x["plen"]), nr, mhl, H, 1, 40, 8, Q * 8)
for k in ("packed", "fb_units", "fb_hits", "fb_nh"):
    out["fused_" + k] = np.asarray(f[k])
if case == "plain":
    rows = x["offset_rows"]
    pos = x["rank_pos"]
    r, s = dev._plain_rank_sym_from_rows(jnp.asarray(rows[(pos + 1) // 1920]),
                                         jnp.asarray(x["rank_c"]), jnp.asarray(pos))
    out["offset_rank"], out["offset_sym"] = np.asarray(r), np.asarray(s)
    # the cast of device_engine.py:463-465 applied to an sp past 2^31
    out["jax_cast"] = np.asarray(jnp.asarray(x["big_sp"]).astype(jnp.int32))
fm.rowmap = None
dev = DeviceFM(fm, serve_layout=serve_layout(case), force_idtype="int64")
out["resolve_lf"] = np.asarray(dev.resolve_rows(x["rows"], x["valid"]))
np.savez(outp, **out)
print("JAX-INT64-OK")
'''


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{case: (fm, inputs, JAX outputs)}, the four JAX processes side by
    side (the wide-ftab one holds a 4^12-entry ftab, about 0.7 GB)."""
    d = tmp_path_factory.mktemp("int64")
    built, procs = {}, {}

    def start(case):
        parts = build_case(case)
        x = make_inputs(case, parts)
        if case == "plain":
            t = TorchFM(fm_arrays(parts[0]), device="cpu", force_idtype="int64")
            x["offset_rows"] = fd.offset_wide_rows(t.rows.numpy().view(np.uint32), OFFSET)
            x["big_sp"] = np.array([2 ** 31 + 5, 2 ** 33 + 7], np.int64)
        np.savez(d / ("in_%s.npz" % case), **x)
        built[case] = (parts[0], x)
        procs[case] = subprocess.Popen(
            [sys.executable, "-c", SCRIPT, REPO, TESTS, case, str(d / ("in_%s.npz" % case)),
             str(d / ("out_%s.npz" % case))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, JAX_PLATFORMS="cpu",
                     JAX_COMPILATION_CACHE_DIR=str(d / "xla_cache")))

    def finish(case):
        out, err = procs[case].communicate(timeout=600)
        assert procs[case].returncode == 0 and "JAX-INT64-OK" in out, err[-3000:]

    for case in CASES:
        start(case)
    for case in CASES:
        finish(case)
    return {c: built[c] + (dict(np.load(d / ("out_%s.npz" % c))),) for c in CASES}


def port(fm, case, idtype, rowmap=True):
    fields = fm_arrays(fm)
    if not rowmap:
        fields["rowmap"] = None
    return TorchFM(fields, device="cpu", serve_layout=serve_layout(case), force_idtype=idtype)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def run_port(fm, case, x, idtype):
    """The port's primitives on one case's inputs -> {name: numpy array}."""
    tfm = port(fm, case, idtype)
    idt = np.int64 if idtype == "int64" else np.int32
    mhl = MHL.get(case, 23)
    H = x["codes"].shape[1] // (mhl + 1) + 1
    out = {}
    hits, nh = fd.chain_search_lanes(tfm, t(x["codes"]), t(x["lengths"]), mhl, H)
    assert hits.dtype == tfm.idtype
    out["chain"] = hits.numpy()
    out["nhits"] = nh.numpy()
    rows, valid = t(x["rows"].astype(idt)), t(x["valid"])
    out["resolve_rowmap"] = fd.resolve_rows(tfm, rows, valid).numpy()
    out["resolve_lf"] = fd.resolve_rows(port(fm, case, idtype, rowmap=False), rows, valid).numpy()
    out["prefix"] = torch.stack(fd.prefix_search(tfm, t(x["codes"]), t(x["ms"]))).numpy()
    nr = int(x["nr"])
    if case == "protein":
        Q = len(x["fused_codes"]) // (6 * nr)
        f = de.fused_classify_protein(tfm, t(x["fused_codes"]), t(x["fused_lengths"]), nr,
                                      mhl, H, 1, 40, 8, Q * de.U_CAP)
    else:
        Q = len(x["plen"]) // nr
        f = de.fused_classify(tfm, t(x["pack2"]), t(x["vmask"]), t(x["plen"]), nr, mhl, H,
                              1, 40, 8, Q * de.U_CAP)
    for k in ("packed", "fb_units", "fb_hits", "fb_nh"):
        out["fused_" + k] = f[k].numpy()
    return tfm, out


@pytest.fixture(scope="module")
def ports(cases):
    """{case: (TorchFM int64, its outputs, the int32 outputs)}."""
    res = {}
    for case, (fm, x, _) in cases.items():
        tfm, o64 = run_port(fm, case, x, "int64")
        res[case] = (tfm, o64, run_port(fm, case, x, "int32")[1])
    return res


def eq(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), what


# ------------------------------------------------------------ the tables

@pytest.mark.parametrize("case", CASES)
def test_tables_match_device_fm(cases, ports, case):
    """fm_arrays + force_idtype carry the index into the port with the tables
    DeviceFM(force_idtype="int64") builds, bit for bit and int64 wherever
    DeviceFM's are."""
    _, _, want = cases[case]
    tfm = ports[case][0]
    assert tfm.idtype == torch.int64
    assert tfm.layout == {"runblock": "generic", "protein": "generic"}.get(case, "plain")
    pairs = {"psum": tfm.psum, "ftab2": tfm.ftab, "sampled_sa": tfm.sampled_sa,
             "sel_rows": tfm.sel_rows, "sel_vals": tfm.sel_vals,
             "end_marker_sa": tfm.end_marker_sa, "rowmap": tfm.rowmap,
             "plain_rows": tfm.rows}
    if tfm.layout == "generic":
        pairs.update(ind_words=tfm.ind.words, ind_cum=tfm.ind.cum, lit_words=tfm.lit.words,
                     lit_occ=tfm.lit.occ, run_words=tfm.run.words, run_occ=tfm.run.occ)
    for name, ours in pairs.items():
        key = "arr_" + name
        if ours is None:
            assert key not in want, name
            continue
        theirs = want[key]
        if theirs.dtype == np.uint32:
            theirs = theirs.view(np.int32)
        ours = ours.numpy()
        assert ours.dtype == theirs.dtype, (name, ours.dtype, theirs.dtype)
        assert np.array_equal(ours, theirs.reshape(ours.shape)), name


# ------------------------------------------------------------ primitives

@pytest.mark.parametrize("case", CASES)
def test_chain_search_matches_jax(cases, ports, case):
    _, _, want = cases[case]
    got = ports[case][1]
    assert want["chain_sp"].dtype == np.int64
    nh = want["chain_nhits"]
    eq(got["nhits"], nh, "nhits")
    live = np.arange(got["chain"].shape[1])[None, :] < nh[:, None]
    for i, k in enumerate(("sp", "ep", "l", "off")):
        eq(np.where(live, got["chain"][:, :, i], 0), np.where(live, want["chain_" + k], 0), k)
    assert nh.sum() > 20


@pytest.mark.parametrize("resolve", ["resolve_rowmap", "resolve_lf"])
@pytest.mark.parametrize("case", CASES)
def test_resolve_rows_matches_jax(cases, ports, case, resolve):
    _, x, want = cases[case]
    got = ports[case][1][resolve]
    assert got.dtype == np.int64 and want[resolve].dtype == np.int64
    eq(got, want[resolve], resolve)
    assert got[x["valid"]].any()


@pytest.mark.parametrize("case", CASES)
def test_prefix_search_matches_jax(cases, ports, case):
    _, _, want = cases[case]
    got = ports[case][1]["prefix"]
    assert got.dtype == np.int64
    eq(got, want["prefix"], "prefix (l, sp, ep)")


@pytest.mark.parametrize("case", CASES)
def test_fused_classify_matches_jax(cases, ports, case):
    """packed, and the flagged units' slice; the JAX program's fb_hits are
    int32 (a cast that is exact below 2^31, see test_blob_keeps_int64_chains)."""
    _, _, want = cases[case]
    got = ports[case][1]
    for k in ("packed", "fb_units", "fb_hits", "fb_nh"):
        eq(got["fused_" + k], want["fused_" + k], k)
    assert got["fused_fb_hits"].dtype == np.int64
    assert (got["fused_packed"][:, 3] > 0).sum() > len(got["fused_packed"]) // 2


@pytest.mark.parametrize("case", CASES)
def test_int64_equals_int32(ports, case):
    _, o64, o32 = ports[case]
    assert o32["chain"].dtype == np.int32
    for k in o64:
        eq(o64[k], o32[k], k)


# ------------------------------------------------------------ 40-bit occ

def test_offset_rows_40bit_occ(cases, ports):
    """Offset rows: every occ column + O, split into the lo word and the hi
    byte.  The port's twin equals DeviceFM._plain_rank_sym_from_rows under
    x64 on the same rows, and the original rank plus O at pos >= 0."""
    fm, x, want = cases["plain"]
    tfm = ports["plain"][0]
    off = fd.offset_rows_view(tfm, OFFSET)
    assert (off.rows.numpy().view(np.uint32)[:, fd.WIDE_HI] > 0).all()
    c, pos = t(x["rank_c"]), t(x["rank_pos"])
    r, s = fd.rank_sym(off, c, pos)
    r0, s0 = fd.rank_sym(tfm, c, pos)
    eq(r, want["offset_rank"], "rank")
    eq(s, want["offset_sym"], "symbol")
    eq(s, s0, "symbol")
    eq(r, torch.where(pos >= 0, r0 + OFFSET, 0), "rank + O")
    assert int(r.max()) > 2 ** 34
    with pytest.raises(ValueError):
        fd.offset_rows_view(port(fm, "plain", "int32"), OFFSET)


# --------------------------------------------------------------- goldens

KS = [("k1", []), ("k2", ["-k", "2"]), ("k5", ["-k", "5"])]


def golden(fx, tag):
    from conftest import FIXTURE_DIR
    return os.path.join(FIXTURE_DIR, fx, "golden_class_%s.tsv" % tag)


@pytest.mark.parametrize("tag,extra", KS)
@pytest.mark.parametrize("fx,paired", [("tiny", True), ("tiny_single", False),
                                       ("small", True), ("tiny_protein", False)])
def test_cli_goldens_int64(tmp_path_factory, monkeypatch, fx, paired, tag, extra):
    """The fixtures classified through the CLI by ClassifierTorch on a
    forced-int64 index (make_classifier(..., force_idtype="int64"), the plain
    twins): the goldens, byte for byte."""
    from test_golden_classify import assert_tsv_equal
    from test_torch_golden import port_index, run_port_cli
    from centrifuger_tpu_torch.cli import classify_cli
    prefix = protein_index(tmp_path_factory) if fx == "tiny_protein" \
        else port_index(fx, tmp_path_factory)
    make, made = classify_cli.make_classifier, []

    def make_int64(*args, **kw):
        made.append(make(*args, force_idtype="int64", **kw))
        return made[-1]
    monkeypatch.setattr(classify_cli, "make_classifier", make_int64)
    got = run_port_cli(fx, prefix, extra, paired)
    assert made and made[0].dev.idtype == torch.int64
    assert_tsv_equal(got, golden(fx, tag))


_PROTEIN_IDX = {}


def protein_index(tmp_path_factory):
    """tiny_protein built by the port's builder (cached per process)."""
    if "p" not in _PROTEIN_IDX:
        import contextlib
        import io
        from conftest import FIXTURE_DIR
        from centrifuger_tpu_torch.cli import build_cli
        d = os.path.join(FIXTURE_DIR, "tiny_protein")
        prefix = str(tmp_path_factory.mktemp("port_protein64") / "idx")
        with contextlib.redirect_stderr(io.StringIO()):
            assert build_cli.main([
                "-r", os.path.join(d, "ref.fa"), "--taxonomy-tree",
                os.path.join(d, "nodes.dmp"), "--name-table", os.path.join(d, "names.dmp"),
                "--conversion-table", os.path.join(d, "ref_seqid.map"), "--protein",
                "-o", prefix]) == 0
        _PROTEIN_IDX["p"] = prefix
    return _PROTEIN_IDX["p"]


# ---------------------------------------------------------------- guards

def big_fields(fm):
    fields = fm_arrays(fm)
    fields["n"] = 1 << 31
    return fields


def test_big_n_picks_int64_and_refuses_a_rowmap():
    fm, _ = build_case("plain")
    assert fm.rowmap is not None
    assert fd.index_dtype(1 << 31) == torch.int64
    assert fd.index_dtype(fd.INT32_LIMIT - 1) == torch.int32
    assert fd.index_dtype(fd.INT32_LIMIT) == torch.int64
    with pytest.raises(ValueError, match="rowmap"):
        TorchFM(big_fields(fm), device="cpu")
    fields = big_fields(fm)
    fields["rowmap"] = None
    tfm = TorchFM(fields, device="cpu", serve_layout="runblock")
    assert tfm.idtype == torch.int64 and tfm.layout == "generic"
    assert tfm.psum.dtype == tfm.ftab.dtype == tfm.ind.cum.dtype == torch.int64
    with pytest.raises(ValueError, match="int64"):
        TorchFM(fields, device="cpu", force_idtype="int32")


@pytest.mark.parametrize("layout,want", [("plain", "plain"), ("runblock", "generic")])
def test_forced_int64_layout(layout, want):
    """A forced int64 on a small index keeps its rowmap (read as int32) and
    serves runblock through the generic layout, as DeviceFM does."""
    fm, _ = build_case("plain")
    tfm = TorchFM(fm_arrays(fm), device="cpu", serve_layout=layout, force_idtype="int64")
    assert (tfm.idtype, tfm.layout) == (torch.int64, want)
    assert tfm.rowmap.dtype == torch.int32
    assert TorchFM(fm_arrays(fm), device="cpu", serve_layout=layout).layout == layout
    with pytest.raises(ValueError):
        TorchFM(fm_arrays(fm), device="cpu", force_idtype="int16")


# ------------------------------------------------------------------ blob

def test_blob_keeps_int64_chains(cases, tmp_path_factory):
    """Chains with sp, ep past 2^31 go through the fused program's host blob
    and the host finish stage's unpack whole, where the JAX program's int32
    cast wraps them."""
    from test_torch_golden import port_index
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    fm, tax, _, _ = load_index(port_index("tiny", tmp_path_factory))
    eng = ClassifierTorch(fm, tax, ClassifierParam(), device="cpu", force_idtype="int64")
    nr, Q, H = 2, 3, 5
    lpu = 2 * nr
    rng = np.random.default_rng(4)
    big = 2 ** 31 + rng.integers(0, 2 ** 33, (lpu * Q, H, 2))
    hits = np.concatenate([big, rng.integers(20, 100, (lpu * Q, H, 2))], axis=2)
    hits = torch.from_numpy(hits.astype(np.int64))
    nhits = torch.from_numpy(rng.integers(1, H + 1, lpu * Q).astype(np.int32))
    packed = torch.zeros(Q, 5 + eng.K_OUT, dtype=torch.int32)
    packed[[0, 2], 4] = de.FLAG_ADJUST
    out = de.pack_results(packed, hits, nhits, lpu)
    assert out["host_blob"].dtype == torch.int32
    got_packed, got = eng._pull_results(out)
    assert np.array_equal(got_packed, packed.numpy())
    assert got["fb_units"].tolist() == [0, 2, -1]
    assert got["fb_hits"].dtype == np.int64
    want = hits.reshape(Q, lpu, H, 4)[[0, 2]].reshape(-1, H, 4).numpy()
    assert np.array_equal(got["fb_hits"][:2 * lpu], want)
    hits_at = eng._fallback_hits_accessor(got, np.array([0, 2]), nr)
    for lane in list(range(lpu)) + list(range(2 * lpu, 3 * lpu)):
        want_lane = [tuple(h) for h in hits[lane, :int(nhits[lane])].tolist()]
        assert hits_at(lane) == want_lane and want_lane[0][0] >= 2 ** 31
    # what the JAX program's cast (device_engine.py:463-465) makes of such an
    # sp, computed under x64 in the plain case's subprocess
    assert cases["plain"][2]["jax_cast"].tolist() == [-2 ** 31 + 5, 7]
