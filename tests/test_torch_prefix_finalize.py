"""K5 (prefix search) and K3 (finalize) at their edges: the port's plain
twins against centrifuger_tpu, exactly (integers, tolerance 0), and a numpy
model of the warp's row expansion in finalize_units.cu.

K5: fd.prefix_search on CPU tensors (the twin) against DeviceFM.prefix_search
on lanes with ms < 0, 0 and < pw, a 255 in the first pw-mer, empty ftab
k-mers, a 255 mid-extension, ms = L and ms > L, searches that cover all of ms
and lanes searched for thousands of steps; on the plain, 2-shard, run-block
and generic layouts.

K3: finalize_units_plain against the packed rows of the JAX fused_classify
on hand-made chains (its chain search replaced by the given hits): a unit
with no hits, strand ties, lanes full to H, rows at n - 1, units past the row
budget; nr = 1 and 2, with and without the rowmap, and the protein frame
choice with its ties.

The model computes what the warp of finalize_units does with a unit's
chains: which thread stages which hit (every hit once, 32 a round), the
lane scores and strand choice, which present hit each thread takes, the
exclusive scan of hit_counts, and which s_rows slot each thread writes.  It
is held to the rows the twin hands its resolve and to the twin's flags.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from centrifuger_tpu.classify.device_engine import fused_classify as jax_fused_classify
from centrifuger_tpu.fm.device import DeviceFM
from centrifuger_tpu_torch.classify import device_engine as de
from centrifuger_tpu_torch.fm import device as fd
from centrifuger_tpu_torch.parallel.sharded import ShardedIndex

from test_torch_kernels import (family_fm, finalize_edge_units, prefix_edge_lanes,
                                prefix_long_lanes, synthetic_protein_fm)

torch.set_num_threads(1)   # the suite runs in several worker processes

MHL = 23
MHL_PROTEIN = 11
HITK = 40                  # max_result 1 x hitk_factor 40 = max_entries
K_OUT = 8
W = de.U_CAP
LAYOUTS = ["plain", "sharded2", "runblock", "generic"]


@pytest.fixture(scope="module")
def index():
    """A run-rich nucleotide index with its rowmap (pw 10, so that many
    ftab k-mers are empty) and its genomes."""
    return family_fm(row_map=True)


def on_layout(fm, layout, rowmap=True):
    fields = fd.fm_arrays(fm)
    if not rowmap:
        fields["rowmap"] = None
    if layout == "sharded2":
        return ShardedIndex(fields, 2, ["cpu"])
    if layout == "generic":
        return fd.TorchFM(fields, device="cpu", _generic=True)
    return fd.TorchFM(fields, device="cpu", serve_layout=layout)


# ------------------------------------------------------------ K5

@pytest.fixture(scope="module")
def prefix_cases(index):
    """{name: (codes, ms, the JAX (l, sp, ep))}: the edge lanes and the long
    lanes, each searched once by DeviceFM."""
    fm, genomes = index
    dev = DeviceFM(fm)
    cases = {"edges": prefix_edge_lanes(genomes, fm.precompute_width, 100, 1),
             "long": prefix_long_lanes(genomes, 4, 2000, 2)}
    return {k: (codes, ms, tuple(np.asarray(t) for t in dev.prefix_search(codes, ms)))
            for k, (codes, ms) in cases.items()}


def test_prefix_edge_lanes_reach_each_case(index, prefix_cases):
    """The edge lanes take every start and stop of the search (JAX's
    answers): ms < pw gives l 0 and the empty range; a 255 d codes before
    ms gives l = d; an empty ftab k-mer gives pw - 1; a search can cover all
    of ms, and stop short of it."""
    pw = index[0].precompute_width
    codes, ms, (l, sp, ep) = prefix_cases["edges"]
    assert (l[:5] == 0).all() and (sp[:5] == 1).all() and (ep[:5] == 0).all()
    assert np.array_equal(l[5:5 + pw], np.arange(pw))
    assert (l == pw - 1).sum() >= 2
    running = l >= pw
    assert (l[running] == ms[running]).any() and (l[running] < ms[running]).any()
    assert (ms >= codes.shape[1]).sum() == 4
    assert (sp[running] <= ep[running]).all()


@pytest.mark.parametrize("case", ["edges", "long"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefix_search_matches_jax(index, prefix_cases, layout, case):
    tfm = on_layout(index[0], layout)
    codes, ms, want = prefix_cases[case]
    got = fd.prefix_search(tfm, torch.from_numpy(codes), torch.from_numpy(ms))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
    if case == "long":
        assert int(got[0].max()) >= 1000


# ------------------------------------------------------------ K3

class GivenChains:
    """A DeviceFM whose chain search returns the given chains, so that the
    JAX fused_classify finalizes hand-made hits."""

    def __init__(self, dev, hits, nhits):
        self._dev = dev
        self._chains = {k: jnp.asarray(hits[:, :, i].astype(np.int32))
                        for i, k in enumerate(("sp", "ep", "l", "off"))}
        self._chains["nhits"] = jnp.asarray(nhits)

    def _chain_search_impl(self, codes, lanelens, mhl, H):
        return self._chains

    def __getattr__(self, name):
        return getattr(self._dev, name)


def jax_packed(fm, hits, nhits, nr, mhl, rowmap=True, protein=False):
    """The JAX program's packed rows [Q, 5 + K_OUT] for the given chains."""
    saved = fm.rowmap
    if not rowmap:
        fm.rowmap = None
    try:
        dev = DeviceFM(fm)
    finally:
        fm.rowmap = saved
    lpu = (6 if protein else 2) * nr
    Q, H = len(nhits) // lpu, hits.shape[1]
    U = Q * nr
    if protein:
        reads = jnp.zeros((6 * U, 8), jnp.uint8)
        lengths = jnp.zeros(6 * U, jnp.int32)
    else:
        reads = (jnp.zeros((U, 2), jnp.uint8), jnp.zeros((U, 1), jnp.uint8))
        lengths = jnp.zeros(U, jnp.int32)
    out = jax_fused_classify(GivenChains(dev, hits, nhits), reads, lengths, nr, mhl, H, 1,
                             HITK, K_OUT, Q * W, protein=protein)
    return np.asarray(out["packed"])


def port_packed(tfm, hits, nhits, nr, mhl, protein=False):
    return de.finalize_units_plain(tfm, torch.from_numpy(hits).int(), torch.from_numpy(nhits),
                                   nr, mhl, HITK, K_OUT, protein).numpy()


@pytest.mark.parametrize("H", [6, 40])
@pytest.mark.parametrize("rowmap", [True, False])
@pytest.mark.parametrize("nr", [1, 2])
def test_finalize_matches_jax(index, nr, rowmap, H):
    fm = index[0]
    hits, nhits = finalize_edge_units(fm.n, 64, 2 * nr, H, MHL, seed=10 * H + nr)
    got = port_packed(on_layout(fm, "plain", rowmap), hits, nhits, nr, MHL)
    assert np.array_equal(got, jax_packed(fm, hits, nhits, nr, MHL, rowmap))
    assert (got[0] == 0).all()                                  # no hits
    assert got[1, 4] & de.FLAG_ADJUST                           # the tie kept both
    assert (got[:, 4] & de.FLAG_ROW_OVERFLOW).any() and (got[:, 4] == 0).any()
    assert (got[:, 3] > 1).any()


@pytest.mark.parametrize("H", [4, 40])
@pytest.mark.parametrize("nr", [1, 2])
def test_finalize_protein_matches_jax(nr, H):
    """The frame choice (ties keep the earlier frame) and the LF walk to
    end-marker rows."""
    fm, _ = synthetic_protein_fm()
    hits, nhits = finalize_edge_units(fm.n, 32, 6 * nr, H, MHL_PROTEIN, seed=H + nr,
                                      protein=True)
    tfm = fd.TorchFM(fd.fm_arrays(fm), device="cpu")
    got = port_packed(tfm, hits, nhits, nr, MHL_PROTEIN, protein=True)
    assert np.array_equal(got, jax_packed(fm, hits, nhits, nr, MHL_PROTEIN, protein=True))
    assert (got[:, 0] > 0).sum() > 16


# ------------------------------------- the warp's row expansion, modelled

def hit_counts(sp, ep, me):
    """(rows, step, forward count, simple) of one hit (finalize_units.cu)."""
    rng = ep - sp + 1
    simple = rng <= me
    step = max((rng + me - 1) // me, 1)
    cf = (rng + step - 1) // step
    cb = min((ep - sp) // step + 1, max(1, me - cf))
    return (rng if simple else cf + cb), step, cf, simple


def warp_unit(hits, nh, mhl, me, nr, protein):
    """One unit as its warp runs it: (s_rows [W], nvalid, overflow).  hits
    [lpu, H, 4] and nh [lpu] are the unit's lanes."""
    lpu = len(nh)
    adj = 5 if protein else 15
    cum = np.cumsum(np.concatenate([nh, np.zeros(32 - lpu, np.int64)]))  # warp scan
    C = int(cum[31])
    # staging: round c0, thread t loads hit i = c0 + t of the lane-major list
    score = np.zeros(32, np.int64)
    stash, loaded = {}, []
    for c0 in range(0, C, 32):
        for t in range(min(32, C - c0)):
            i = c0 + t
            r = int((cum[:12] <= i).sum())
            m = i - (int(cum[r - 1]) if r else 0)
            loaded.append((r, m))
            e = hits[r, m]
            if e[2] >= mhl:
                score[r] += (e[2] - adj) ** 2
            if m < W:
                stash[r, m] = e
    assert sorted(loaded) == [(r, m) for r in range(lpu) for m in range(nh[r])]
    # strand (protein: frame) choice by shuffles of thread r's score
    if protein:
        qs = np.concatenate([nh, np.zeros(32 - lpu, np.int64)]) * score

        def chosen(g0):
            best, tag = 0, 0
            for fr in range(3):
                if qs[g0 + fr] > best:
                    best, tag = qs[g0 + fr], fr
            return g0 + tag
        f1, r1 = chosen(0), chosen(3)
        f2, r2 = (chosen(6), chosen(9)) if nr == 2 else (-1, -1)
    else:
        f1, r1, f2, r2 = (0, 1, 2, 3) if nr == 2 else (0, 1, -1, -1)
    plus, minus = score[f1], score[r1]
    if nr == 2:
        plus, minus = plus + score[r2], minus + score[f2]
    tp, tm = plus >= minus, minus >= plus
    if nr == 2:
        slots = [(f1 if tp else -1, 1), (r2 if tp else -1, 1),
                 (r1 if tm else -1, 0), (f2 if tm else -1, 0)]
    else:
        slots = [(f1 if tp else -1, 1), (r1 if tm else -1, 0)]
    slot_n = [nh[lane] if lane >= 0 else 0 for lane, _ in slots]
    P = sum(slot_n)
    # thread t takes the t-th present hit, slot-major; t < W
    cnt = np.zeros(32, np.int64)
    mine = {}
    for t in range(min(P, W)):
        s = int(np.searchsorted(np.cumsum(slot_n), t, side="right"))
        m = t - sum(slot_n[:s])
        e = stash[slots[s][0], m]            # a stashed hit: m < W
        mine[t] = e, hit_counts(int(e[0]), int(e[1]), me)
        cnt[t] = mine[t][1][0]
    incl = np.cumsum(cnt)
    first = incl - cnt                        # the exclusive scan
    total = int(incl[31])
    rows = np.zeros(W, np.int64)
    writer = {}
    for t, (e, (_, step, cf, simple)) in mine.items():
        for j in range(int(first[t]), min(int(incl[t]), W)):
            assert j not in writer
            writer[j] = t
            pos = j - first[t]
            rows[j] = e[0] + pos if simple else \
                (e[0] + pos * step if pos < cf else e[1] - (pos - cf) * step)
    nvalid = min(total, W)
    assert sorted(writer) == list(range(nvalid))
    return rows, nvalid, P > W or total > W


@pytest.mark.parametrize("protein", [False, True])
@pytest.mark.parametrize("H", [6, 40])
@pytest.mark.parametrize("nr", [1, 2])
def test_warp_row_expansion_model(index, monkeypatch, nr, H, protein):
    """Which thread writes which s_rows slot, from the exclusive scan of
    hit_counts over the first W present hits: the rows the twin resolves,
    and its FLAG_ROW_OVERFLOW."""
    if protein:
        fm, mhl, lpu = synthetic_protein_fm()[0], MHL_PROTEIN, 6 * nr
    else:
        fm, mhl, lpu = index[0], MHL, 2 * nr
    Q = 64
    hits, nhits = finalize_edge_units(fm.n, Q, lpu, H, mhl, seed=3 * H + nr, protein=protein)
    handed = []
    resolve = de.resolve_rows_plain

    def spy(fm_, rows, valid):
        handed.append((rows.numpy().reshape(Q, W), valid.numpy().reshape(Q, W)))
        return resolve(fm_, rows, valid)
    monkeypatch.setattr(de, "resolve_rows_plain", spy)
    packed = port_packed(fd.TorchFM(fd.fm_arrays(fm), device="cpu"), hits, nhits, nr, mhl,
                         protein)
    (rows, valid), = handed
    hits = hits.reshape(Q, lpu, H, 4)
    nhits = nhits.reshape(Q, lpu).astype(np.int64)
    for q in range(Q):
        m_rows, nvalid, overflow = warp_unit(hits[q], nhits[q], mhl, HITK, nr, protein)
        assert valid[q].sum() == nvalid and valid[q, :nvalid].all(), q
        assert np.array_equal(rows[q, :nvalid], m_rows[:nvalid]), q
        assert bool(packed[q, 4] & de.FLAG_ROW_OVERFLOW) == overflow, q
    assert (packed[:, 4] & de.FLAG_ROW_OVERFLOW).any() and (valid.sum(1) == W).any()
    if not protein:
        assert ((valid.sum(1) > 0) & (valid.sum(1) < W)).any()
