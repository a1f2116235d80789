"""The group rank of kernels K1 and K2 (rank_plain.cuh group_rank / group_lf)
and the kernel launch path, on the CPU.

A numpy model computes exactly what the G threads of a RankGroup do on a
wide row: which words thread t loads (words [W t, W t + W), W = 128 / G, in
16-byte loads, each made only where it holds a word the rank needs), the masked
2-bit count of each thread's words, the group sum, and which thread supplies
the occ, hi, prev and symbol words.  It is held to the plain twins
(TorchFM._plain_rank_sym / _plain_lf) and to the JAX DeviceFM, at every
`upto` of a row, pos = -1, (pos + 1) % 1920 == 0 and the last row, on
whole rows, int64 offset rows and rows routed over 2 shards.

The launch path: the FMView each index keeps for its launches equals a fresh
one field by field and is rebuilt when a buffer is swapped; misaligned rows
are refused; each entry point's ctypes prototype is set once.
"""

import ctypes

import numpy as np
import pytest
import torch

from centrifuger_tpu.fm.builder import FMBuildParams, build_fm
from centrifuger_tpu.fm.device import DeviceFM
from centrifuger_tpu.testutil import synthetic_fm
from centrifuger_tpu_torch import kernels
from centrifuger_tpu_torch.fm import device as fd
from centrifuger_tpu_torch.parallel.sharded import ShardedIndex

torch.set_num_threads(1)   # the suite runs in several worker processes

G = 32                     # threads a group: a warp (RankGroup in rank_plain.cuh)
W = 128 // G               # words a thread holds
M32 = 0xFFFFFFFF
OFFSET = 5 * 2 ** 32 + 12345      # offset rows: every occ + OFFSET (40-bit occ)


def popcount(v):
    v = v.astype(np.uint64)
    return np.array([bin(int(x)).count("1") for x in v.reshape(-1)],
                    np.int64).reshape(v.shape)


def held(slices, w):
    """Row word w [M] from the thread that holds it (thread w // W, its word
    w % W), as the group's shuffles fetch it."""
    return slices[np.arange(len(slices)), w // W, w % W].astype(np.int64)


def group_slices(fetch, pos):
    """(slices [M, G, W] uint32, loaded [M, G, W / 4] bool, upto [M]): the
    words each thread of the group holds for pos's row, a load that holds no
    word of [0, 6 + ceil(upto / 16)) not made (its words read 0)."""
    upto = (pos + 1) % fd.WIDE_BLOCK
    row = fetch((pos + 1) // fd.WIDE_BLOCK).astype(np.uint32)          # [M, 128]
    need = fd.WIDE_OFF + (upto + 15) // 16
    first = W * np.arange(G)[:, None] + 4 * np.arange(W // 4)[None, :]  # [G, W / 4]
    loaded = first[None] < need[:, None, None]
    q = row.reshape(-1, G, W // 4, 4) * loaded[..., None]
    return q.reshape(-1, G, W).astype(np.uint32), loaded, upto


def group_count(slices, c, upto):
    """Each thread's count of c among the first upto slots in its words, and
    the group's sum (the warp reduction)."""
    t = np.arange(G)[:, None]
    i = np.arange(W)[None, :]
    j = W * t + i - fd.WIDE_OFF                                        # data word
    need = fd.WIDE_OFF + (upto + 15) // 16
    left = upto[:, None] - 16 * (W * np.arange(G)[None, :] - fd.WIDE_OFF)    # [M, G]
    nb = 2 * np.clip(left[:, :, None] - 16 * i[None], 0, 16)
    low = np.where(nb >= 32, 0x55555555,
                   ((np.int64(1) << np.minimum(nb, 31)) - 1) & 0x55555555)
    keep = np.where(((j >= 0) & (j < fd.WIDE_DATA))[None], low, 0)
    w = slices.astype(np.int64)
    x = ~(w ^ (c[:, None, None] * 0x55555555)) & M32
    cnt = popcount(x & (x >> 1) & keep).sum(-1)
    cnt = np.where(W * np.arange(G)[None, :] < need[:, None], cnt, 0)    # idle threads
    return cnt.sum(1)


def group_sym(slices, loaded, pos, upto):
    """The symbol word from the thread that holds it: prev_word where
    upto == 0, else data word (upto - 1) // 16."""
    w = np.where(upto == 0, fd.WIDE_PREV, fd.WIDE_OFF + (upto - 1) // 16)
    assert loaded[np.arange(len(pos)), w // W, (w % W) // 4].all(), \
        "the symbol word was not loaded"
    return (held(slices, w) >> ((pos & 15) * 2)) & 3


def group_rank(fetch, c, pos, idx64):
    """(rank_inclusive(c, pos), symbol at pos) as the group computes them."""
    slices, loaded, upto = group_slices(fetch, pos)
    cnt = group_count(slices, c, upto)
    occ = held(slices, c)                                              # occ_A..occ_T: words 0..3
    if idx64:
        hi = held(slices, np.full(len(pos), fd.WIDE_HI))
        occ = occ + (((hi >> (8 * c)) & 0xFF) << 32)
    rank = np.where(pos < 0, 0, occ + cnt)
    return rank, group_sym(slices, loaded, pos, upto)


def group_lf(fetch, p, idx64, psum, last_chr, first_isa):
    slices, loaded, upto = group_slices(fetch, p)
    sym = group_sym(slices, loaded, p, upto)
    rank, _ = group_rank(fetch, sym, p, idx64)
    corr = ((sym == last_chr) & (p < first_isa)).astype(np.int64)
    return psum[sym] + rank + corr - 1


def group_bytes(pos, isz):
    """(bytes the group's loads read, bytes TorchFM._row_words counts): the
    loads are 16 bytes each, so the count does not depend on G."""
    upto = (pos + 1) % fd.WIDE_BLOCK
    need = fd.WIDE_OFF + (upto + 15) // 16
    return 16 * ((need + 3) // 4), isz + 4 * ((upto + 15) // 16)


# ---------------------------------------------------------------- indexes

@pytest.fixture(scope="module")
def index():
    fm, _ = synthetic_fm(n_genomes=3, genome_len=12000, seed=11)
    tfm = fd.TorchFM(fd.fm_arrays(fm), device="cpu")
    t64 = fd.TorchFM(fd.fm_arrays(fm), device="cpu", force_idtype="int64")
    return dict(fm=fm, jax=DeviceFM(fm), whole=tfm,
                int64_offset=fd.offset_rows_view(t64, OFFSET), int64=t64,
                sharded2=ShardedIndex(fd.fm_arrays(fm), 2, ["cpu"]))


def fetch_of(tfm):
    """The model's row fetch: the whole table, or routed to the owner shard."""
    if tfm.layout == "plain_sharded":
        shards, rps = [s.numpy() for s in tfm.shards["rows"]], tfm.rps["rows"]
        return lambda r: np.stack([shards[x // rps][x % rps] for x in r])
    rows = tfm.rows.numpy()
    return lambda r: rows[r]


def positions(n, case):
    """pos >= -1 of a case: every upto 0..1919 of the first, a middle and the
    last row (pos = -1, (pos + 1) % 1920 == 0 and n - 1 among them), or
    random ones."""
    last = n // fd.WIDE_BLOCK
    r = {"first_row": 0, "middle_row": last // 2, "last_row": last}.get(case)
    if r is None:
        return np.random.default_rng(3).integers(-1, n, 4096)
    pos = r * fd.WIDE_BLOCK + np.arange(fd.WIDE_BLOCK) - 1
    return pos[pos < n]


ROWS = ["whole", "int64_offset", "sharded2"]
CASES = ["first_row", "middle_row", "last_row", "random"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rows", ROWS)
def test_group_rank_model(index, rows, case):
    tfm = index[rows]
    pos = positions(tfm.n, case)
    if case == "first_row":
        assert pos[0] == -1
    if case != "random":
        assert sorted((pos + 1) % fd.WIDE_BLOCK) == list(range(len(pos)))
    idx64 = tfm.idtype == torch.int64
    for c in range(4):
        cs = np.full(len(pos), c)
        rank, sym = group_rank(fetch_of(tfm), cs, pos, idx64)
        tr, ts = tfm._plain_rank_sym(torch.from_numpy(cs), torch.from_numpy(pos))
        assert np.array_equal(rank, tr.numpy()) and np.array_equal(sym, ts.numpy())
        if rows == "whole":
            jr, js = index["jax"]._plain_rank_sym(cs.astype(np.int32), pos.astype(np.int32))
            ok = pos >= 0
            assert np.array_equal(rank, np.asarray(jr))
            assert np.array_equal(sym[ok], np.asarray(js)[ok])
        if rows == "int64_offset":
            base, bsym = index["int64"]._plain_rank_sym(torch.from_numpy(cs),
                                                        torch.from_numpy(pos))
            assert np.array_equal(rank, np.where(pos < 0, 0, base.numpy() + OFFSET))
            assert np.array_equal(sym, bsym.numpy())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rows", ROWS)
def test_group_lf_model(index, rows, case):
    tfm = index[rows]
    p = positions(tfm.n, case)
    p = p[p >= 0]
    got = group_lf(fetch_of(tfm), p, tfm.idtype == torch.int64, tfm.psum.numpy().astype(np.int64),
                   tfm.last_chr, tfm.first_isa)
    assert np.array_equal(got, tfm._plain_lf(torch.from_numpy(p)).numpy())
    if rows != "int64_offset":   # offset rows have a meaning for rank_sym only
        assert np.array_equal(got, np.asarray(index["jax"].lf(p.astype(np.int32))))


@pytest.mark.parametrize("idtype", ["int32", "int64"])
def test_group_reads_the_counted_words(index, idtype):
    """At every upto the group's 16-byte loads cover the header and the data
    words the rank needs and read 20-32 bytes more than TorchFM._row_words
    counts (the header's prev word and the rounding up to 16 bytes)."""
    tfm = index["whole" if idtype == "int32" else "int64"]
    pos = positions(tfm.n, "first_row")
    read, counted = group_bytes(pos, tfm.isz)
    tfm.traffic = 0
    tfm._row_words(torch.from_numpy(pos))
    assert tfm.traffic == counted.sum()
    tfm.traffic = None
    extra = read - counted
    assert extra.min() >= 20 - 4 * (tfm.isz == 8) and extra.max() <= 32


# ------------------------------------------------------------ launch path

def view_fields(view):
    return {name: getattr(view, name) for name, _ in kernels.FMView._fields_}


def index_of(kind):
    """A small index with a rowmap on the layout `kind`, on the CPU."""
    genomes = [np.random.default_rng(4 + i).integers(0, 4, 6000).astype(np.uint8)
               for i in range(2)]
    fm = build_fm(np.concatenate(genomes), [len(g) for g in genomes], np.arange(2), "ACGT",
                  FMBuildParams(row_map=True))
    fields = fd.fm_arrays(fm)
    if kind == "sharded2":
        return ShardedIndex(fields, 2, ["cpu"])
    if kind == "generic":
        return fd.TorchFM(fields, device="cpu", _generic=True)
    return fd.TorchFM(fields, device="cpu", serve_layout=kind)


@pytest.mark.parametrize("kind", ["plain", "runblock", "generic", "sharded2"])
def test_cached_view_equals_fresh_view(kind):
    tfm = index_of(kind)
    view = tfm.kernel_view()
    assert tfm.kernel_view() is view
    assert view_fields(view.fm_view) == view_fields(kernels._fm_view(tfm))
    assert view.device == tfm.device
    assert ctypes.addressof(view.pointer.contents) == ctypes.addressof(view.fm_view)


@pytest.mark.parametrize("kind", ["plain", "sharded2"])
def test_view_rebuilt_when_rowmap_is_turned_off(kind):
    tfm = index_of(kind)
    before = tfm.kernel_view()
    assert before.fm_view.has_rowmap == 1
    saved = tfm.rowmap
    tfm.rowmap = None
    after = tfm.kernel_view()
    assert after is not before and after.fm_view.has_rowmap == 0
    assert after.fm_view.rowmap is None and after.fm_view.rowmap_shards is None
    assert view_fields(after.fm_view) == view_fields(kernels._fm_view(tfm))
    tfm.rowmap = saved
    assert view_fields(tfm.kernel_view().fm_view) == view_fields(before.fm_view)


def test_view_of_offset_rows_is_its_own(index):
    t64 = fd.TorchFM(fd.fm_arrays(index["fm"]), device="cpu", force_idtype="int64")
    base = t64.kernel_view()
    off = fd.offset_rows_view(t64, OFFSET)
    assert off.kernel_view() is not base and t64.kernel_view() is base
    assert off.kernel_view().fm_view.rows == off.rows.data_ptr() != base.fm_view.rows
    assert view_fields(off.kernel_view().fm_view) == view_fields(kernels._fm_view(off))


def test_view_dropped_when_buffers_move():
    tfm = index_of("plain")
    view = tfm.kernel_view()
    tfm.to(torch.float64)     # _apply runs over the buffers (integer ones stay)
    assert tfm.kernel_view() is not view


@pytest.mark.parametrize("kind", ["plain", "sharded2"])
def test_misaligned_rows_refused(kind):
    tfm = index_of(kind)
    rows = tfm.shards["rows"][1] if kind == "sharded2" else tfm.rows
    shifted = torch.empty(rows.numel() + 1, dtype=rows.dtype)[1:].view(rows.shape)
    shifted.copy_(rows)
    assert shifted.data_ptr() % 16 == 4
    if kind == "sharded2":
        tfm.shards["rows"][1] = shifted
    else:
        tfm.rows = shifted
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfm.kernel_view()


class _FakeEntry:
    """A C entry point that records its prototype and its calls."""

    def __init__(self):
        object.__setattr__(self, "prototypes", 0)
        object.__setattr__(self, "calls", [])

    def __setattr__(self, name, value):
        if name == "argtypes":
            object.__setattr__(self, "prototypes", self.prototypes + 1)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _FakeLib:
    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = _FakeEntry()
        setattr(self, name, fn)
        return fn


class _OnCard(torch.Tensor):
    """A CPU tensor the launch path takes for a card's."""

    @property
    def is_cuda(self):
        return True


def test_launch_path_sets_prototypes_once(monkeypatch):
    tfm = index_of("plain")
    libs = []
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "_ENTRY_FNS", {})
    monkeypatch.setattr(kernels, "build_all", lambda: 0.0)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda p: libs.append(_FakeLib(p)) or libs[-1])
    monkeypatch.setattr(kernels, "_stream", lambda index: 1234)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(kernels, "LAUNCHES", kernels.collections.Counter())

    def card(t):
        return torch.Tensor._make_subclass(_OnCard, t)
    rows, valid = card(torch.arange(5, dtype=torch.int32)), card(torch.ones(5, dtype=torch.bool))
    out = card(torch.empty(5, dtype=torch.int32))
    for _ in range(3):
        kernels.launch("resolve_rows", tfm, rows, valid, 5, out)
    fn = kernels._ENTRY_FNS["resolve_rows"]
    assert len(libs) == 1 and fn.prototypes == 1 and len(fn.calls) == 3
    view = tfm.kernel_view()
    assert all(c[0] is view.pointer and c[-1] == 1234 for c in fn.calls)
    assert fn.calls[0][1:-1] == (rows.data_ptr(), valid.data_ptr(), 5, out.data_ptr())
    assert fn.argtypes[0] is ctypes.POINTER(kernels.FMView) and fn.restype is ctypes.c_int
    assert kernels.LAUNCHES == {"resolve_rows:plain": 3}
    tfm.rowmap = None
    kernels.launch("resolve_rows", tfm, rows, valid, 5, out)
    assert fn.calls[-1][0] is tfm.kernel_view().pointer is not view.pointer
    assert fn.prototypes == 1 and len(libs) == 1
    with pytest.raises(ValueError, match="CPU tensor"):
        kernels.launch("resolve_rows", tfm, rows.as_subclass(torch.Tensor), valid, 5, out)
