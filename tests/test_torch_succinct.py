"""The port's succinct library (centrifuger_tpu_torch/succinct: bits,
bitvectors, codes, sequences, hashing, mapper, permutation) and testutil
against the JAX package's: the same inputs, made from a seed, build an object
in each package; every attribute must be equal, walked recursively, every
query must give the same output, and the JAX tests' brute-force oracles
(tests/test_succinct_breadth.py) hold for the port's classes."""

import copy
import importlib
import types

import numpy as np
import pytest

MODULES = ("bits", "bitvector", "bitvectors", "codes", "sequences", "hashing", "mapper",
           "permutation", "csa", "trees")


def _package(root):
    return types.SimpleNamespace(**{m: importlib.import_module("%s.succinct.%s" % (root, m))
                                    for m in MODULES})


PORT = _package("centrifuger_tpu_torch")
JAX = _package("centrifuger_tpu")


def assert_same(p, j, where="obj", seen=None):
    """p (a port value) equals j (the JAX package's), recursively: arrays by
    dtype and values, scalars by type and value, lists / tuples / dicts item
    by item, objects by class name, module and their own attributes."""
    seen = set() if seen is None else seen
    assert type(p).__name__ == type(j).__name__, (where, type(p), type(j))
    if isinstance(j, np.ndarray):
        assert p.dtype == j.dtype and p.shape == j.shape, (where, p.dtype, j.dtype)
        assert np.array_equal(p, j), where
    elif isinstance(j, (list, tuple)):
        assert len(p) == len(j), where
        for k, (a, b) in enumerate(zip(p, j)):
            assert_same(a, b, "%s[%d]" % (where, k), seen)
    elif isinstance(j, dict):
        assert list(p) == list(j), where
        for k in j:
            assert_same(p[k], j[k], "%s[%r]" % (where, k), seen)
    elif isinstance(j, (type(None), bool, int, float, str, bytes, np.generic)):
        assert p == j, (where, p, j)
    else:
        jmod = type(j).__module__
        assert jmod.startswith("centrifuger_tpu."), (where, jmod)
        assert type(p).__module__ == "centrifuger_tpu_torch" + jmod[len("centrifuger_tpu"):], \
            (where, type(p).__module__)
        if (id(p), id(j)) in seen:
            return
        seen.add((id(p), id(j)))
        pa, ja = _attributes(p), _attributes(j)
        assert list(pa) == list(ja), (where, list(pa), list(ja))
        for k in ja:
            assert_same(pa[k], ja[k], "%s.%s" % (where, k), seen)


def _attributes(obj):
    out = dict(vars(obj)) if hasattr(obj, "__dict__") else {}
    for cls in type(obj).__mro__:
        for s in getattr(cls, "__slots__", ()):
            if hasattr(obj, s):
                out[s] = getattr(obj, s)
    return dict(sorted(out.items()))


def both(build):
    """(port object, JAX object) of build(package), held equal."""
    p, j = build(PORT), build(JAX)
    assert_same(p, j, "built")
    return p, j


def _call(obj, name, args, kw):
    try:
        return getattr(obj, name)(*copy.deepcopy(args), **copy.deepcopy(kw))
    except Exception as e:  # noqa: BLE001 - the two packages must raise alike
        return ("raised", type(e).__name__, str(e))


def query(p, j, name, *args, **kw):
    """p.name(*args) held to j.name(*args); returns the port's answer."""
    got, want = _call(p, name, args, kw), _call(j, name, args, kw)
    assert_same(got, want, "%s.%s" % (type(p).__name__, name))
    return got


# ------------------------------------------------------------------ arrays

@pytest.mark.parametrize("width", [1, 3, 5, 7, 11, 13, 17, 31, 33, 57, 64])
def test_fixed_array(width):
    rng = np.random.default_rng(width)
    n = 1000
    vals = rng.integers(0, (1 << width) - 1, size=n, endpoint=True, dtype=np.uint64)
    p, j = both(lambda pk: pk.bits.FixedArray.from_values(vals, width))
    idx = rng.integers(0, n, size=500)
    assert (query(p, j, "read", idx) == vals[idx]).all()
    assert (query(p, j, "read", np.arange(n)) == vals).all()
    words = PORT.bits.pack_fixed(vals, width)
    assert_same(words, JAX.bits.pack_fixed(vals, width))
    assert_same(PORT.bits.read_fixed(words, idx, width), JAX.bits.read_fixed(words, idx, width))
    starts = rng.integers(0, n * width - width + 1, size=300).astype(np.uint64)
    got = PORT.bits.read_bits(words, starts, width)
    assert_same(got, JAX.bits.read_bits(words, starts, width))
    # the bits at an element's own start are that element
    assert (PORT.bits.read_bits(words, idx.astype(np.uint64) * np.uint64(width), width)
            == vals[idx]).all()
    query(p, j, "nbytes")


def test_fixed_array_write_and_lcp():
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 100, size=300, dtype=np.uint64)
    p, j = both(lambda pk: pk.bits.FixedArray.from_values(vals, 9))
    for i in [0, 7, 55, 299]:
        query(p, j, "write", i, 77)
        vals[i] = 77
    assert_same(p, j)
    assert (query(p, j, "read", np.arange(300)) == vals).all()
    vals2 = vals.copy()
    vals2[50:60] = vals2[100:110]
    p2, j2 = both(lambda pk: pk.bits.FixedArray.from_values(vals2))
    m = query(p2, j2, "prefix_match_len", 50, 100, 40)
    brute = 0
    while brute < 40 and vals2[50 + brute] == vals2[100 + brute]:
        brute += 1
    assert m == brute


@pytest.mark.parametrize("u", [3, 5, 6, 10, 17])
def test_fraction_bit_array(u):
    rng = np.random.default_rng(u)
    vals = rng.integers(0, u, size=777, dtype=np.uint64)
    p, j = both(lambda pk: pk.bits.FractionBitArray(vals, u))
    assert (query(p, j, "read", np.arange(777)) == vals).all()
    query(p, j, "nbytes")


@pytest.mark.parametrize("mode", ["dense", "sampled", "direct"])
def test_variable_size_array(mode):
    rng = np.random.default_rng(len(mode))
    vals = np.concatenate([rng.integers(0, 10, 300, dtype=np.uint64),
                           rng.integers(0, 1 << 20, 300, dtype=np.uint64),
                           rng.integers(0, 1 << 50, 100, dtype=np.uint64)])
    rng.shuffle(vals)
    p, j = both(lambda pk: pk.bits.VariableSizeArray(vals, mode=mode))
    idx = rng.integers(0, len(vals), size=400)
    assert (query(p, j, "read", idx) == vals[idx]).all()
    assert query(p, j, "read", np.int64(5)) == vals[5]
    query(p, j, "nbytes")


def test_interleaved_array():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 12, 500, dtype=np.uint64)
    b = rng.integers(0, 1 << 9, 500, dtype=np.uint64)
    p, j = both(lambda pk: pk.bits.InterleavedFixedArray(a, b))
    idx = rng.integers(0, 500, size=300)
    assert (query(p, j, "read_a", idx) == a[idx]).all()
    assert (query(p, j, "read_b", idx) == b[idx]).all()
    query(p, j, "nbytes")


# -------------------------------------------------------------- bitvectors

def _bv(pk, bits):
    return pk.bitvector.Bitvector.from_bits(bits)


@pytest.mark.parametrize("p", [0.01, 0.3, 0.5, 0.9])
@pytest.mark.parametrize("speed", ["binary", "dense"])
def test_select_support(p, speed):
    rng = np.random.default_rng(int(p * 100) + len(speed))
    n = 5000
    bits = rng.random(n) < p
    for value, pos in ((1, np.flatnonzero(bits)), (0, np.flatnonzero(~bits))):
        ps, js = both(lambda pk: pk.bitvectors.SelectSupport(_bv(pk, bits), value, speed=speed))
        assert ps.total == len(pos)
        if len(pos):
            k = rng.integers(1, len(pos), size=200, endpoint=True)
            assert (query(ps, js, "select", k) == pos[k - 1]).all()
            assert query(ps, js, "select", int(k[0])) == pos[k[0] - 1]
        query(ps, js, "nbytes")


@pytest.mark.parametrize("m,n", [(0, 100), (1, 100), (50, 10000), (5000, 10000),
                                 (100, 1 << 20)])
def test_sparse_bitvector(m, n):
    rng = np.random.default_rng(m + n)
    pos = np.sort(rng.choice(n, size=m, replace=False)).astype(np.int64)
    p, j = both(lambda pk: pk.bitvectors.SparseBitvector(pos, n))
    if m:
        k = rng.integers(1, m, size=min(200, m), endpoint=True)
        assert (query(p, j, "select1", k) == pos[k - 1]).all()
        assert (query(p, j, "access", pos[:50]) == 1).all()
    qs = rng.integers(0, n, size=300)
    assert (query(p, j, "rank1_inclusive", qs) == np.searchsorted(pos, qs, side="right")).all()
    query(p, j, "rank1_inclusive", -1)
    notin = np.setdiff1d(qs, pos)[:50]
    if len(notin):
        assert (query(p, j, "access", notin) == 0).all()
    query(p, j, "nbytes")


@pytest.mark.parametrize("p", [0.02, 0.3, 0.5, 0.97])
def test_rrr_bitvector(p):
    rng = np.random.default_rng(int(p * 100))
    n = 4321
    bits = rng.random(n) < p
    cb, jb = both(lambda pk: pk.bitvectors.CompressedBitvector(bits))
    qs = rng.integers(0, n, size=400)
    brute = np.cumsum(bits)
    assert (query(cb, jb, "rank1_inclusive", qs) == brute[qs]).all()
    assert (query(cb, jb, "access", qs) == bits[qs]).all()
    assert query(cb, jb, "rank1_inclusive", n + 5) == brute[-1]
    if p <= 0.05:
        assert query(cb, jb, "nbytes") < n // 8


@pytest.mark.parametrize("kind", ["runs", "empty"])
def test_runlength_bitvector(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "runs":
        bits = np.repeat(np.arange(200) % 2, rng.integers(1, 200, size=200)).astype(bool)
    else:
        bits = np.zeros(300, bool)
    n = len(bits)
    rl, jl = both(lambda pk: pk.bitvectors.RunLengthBitvector(bits))
    qs = rng.integers(0, n, size=400)
    brute = np.cumsum(bits)
    assert (query(rl, jl, "rank1_inclusive", qs) == brute[qs]).all()
    assert (query(rl, jl, "access", qs) == bits[qs]).all()
    ones = np.flatnonzero(bits)
    if len(ones):
        k = rng.integers(1, len(ones), size=200, endpoint=True)
        assert (query(rl, jl, "select1", k) == ones[k - 1]).all()
        assert query(rl, jl, "nbytes") < n // 8


# ------------------------------------------------------------------- codes

@pytest.mark.parametrize("freqs", [
    "random2", "random4", "random7", "random26", [5, 5, 5, 5, 5], [1, 1, 2, 2, 4, 4, 8],
    [0, 7, 0, 0], [3, 0, 3, 0, 3], [900, 50, 30, 20]])
def test_huffman(freqs):
    rng = np.random.default_rng(len(str(freqs)))
    if isinstance(freqs, str):
        freqs = rng.integers(1, 1000, size=int(freqs[6:]))
    freqs = np.asarray(freqs)
    sigma = len(freqs)
    hc, jc = both(lambda pk: pk.codes.HuffmanCode(freqs))
    present = np.flatnonzero(freqs > 0)
    if len(present) > 1:
        # Kraft equality for a full binary code
        assert abs(sum(2.0 ** -int(b) for b in hc.lengths if b > 0) - 1.0) < 1e-9
    syms = rng.choice(present, size=500)
    words, total = query(hc, jc, "encode", syms)
    assert (query(hc, jc, "decode", words, total, len(syms)) == syms).all()
    bits = query(hc, jc, "space_bits", freqs)
    n = freqs.sum()
    q = freqs[present] / n
    assert bits <= -(q * np.log2(q)).sum() * n + n  # within a bit a symbol of entropy
    with pytest.raises(ValueError):
        PORT.codes.HuffmanCode(np.zeros(sigma, np.int64))


@pytest.mark.parametrize("code", ["gamma", "delta"])
def test_elias(code):
    rng = np.random.default_rng(len(code))
    vals = np.concatenate([rng.integers(1, 1 << 20, size=400, dtype=np.uint64),
                           np.array([1, 2, 3, 255, 256, (1 << 31), (1 << 32) - 1], np.uint64)])
    enc = getattr(PORT.codes, "elias_%s_encode" % code)
    dec = getattr(PORT.codes, "elias_%s_decode" % code)
    words, total, starts = enc(vals)
    assert_same((words, total, starts), getattr(JAX.codes, "elias_%s_encode" % code)(vals))
    got = dec(words, starts)
    assert_same(got, getattr(JAX.codes, "elias_%s_decode" % code)(words, starts))
    assert (got == vals).all()


# --------------------------------------------------------------- sequences

def check_sequence(p, j, codes, sigma, rng, selectable=False):
    """The brute-force oracle of test_succinct_breadth.py, every answer also
    held to the JAX object's."""
    n = len(codes)
    qs = rng.integers(0, n, size=200)
    assert (np.atleast_1d(query(p, j, "access", qs)) == codes[qs]).all(), "access"
    assert query(p, j, "access", int(qs[0])) == codes[qs[0]]
    for c in range(sigma):
        brute = np.cumsum(codes == c)
        assert (np.atleast_1d(query(p, j, "rank", c, qs)) == brute[qs]).all(), c
        assert query(p, j, "rank", c, int(qs[1])) == brute[qs[1]]
        if selectable:
            pos = np.flatnonzero(codes == c)
            if len(pos):
                k = rng.integers(1, len(pos), size=50, endpoint=True)
                assert (np.atleast_1d(query(p, j, "select", c, k)) == pos[k - 1]).all()
    query(p, j, "nbytes")
    assert_same(p, j, "after the queries")


@pytest.mark.parametrize("sigma", [2, 4, 5, 8])
def test_sequence_plain(sigma):
    rng = np.random.default_rng(sigma)
    codes = rng.integers(0, sigma, size=3000)
    p, j = both(lambda pk: pk.sequences.SequencePlain(codes, sigma))
    check_sequence(p, j, codes, sigma, rng, selectable=True)


@pytest.mark.parametrize("sigma,bv_kind,huffman", [
    (4, "plain", False), (4, "plain", True), (6, "plain", False),
    (4, "rrr", False), (8, "plain", True), (4, "sparse", False), (4, "runlength", False),
])
def test_sequence_wavelet(sigma, bv_kind, huffman):
    rng = np.random.default_rng(sigma * 10 + len(bv_kind) + huffman)
    q = np.arange(1, sigma + 1, dtype=float) ** 2
    codes = rng.choice(sigma, size=2000, p=q / q.sum())
    if bv_kind == "runlength":
        codes = np.sort(codes)
    p, j = both(lambda pk: pk.sequences.SequenceWavelet(codes, sigma, bv_kind=bv_kind,
                                                        huffman=huffman))
    check_sequence(p, j, codes, sigma, rng)


def test_sequence_runlength():
    rng = np.random.default_rng(300)
    runs = rng.integers(1, 60, size=300)
    heads = rng.integers(0, 4, size=300)
    keep = np.concatenate([[True], heads[1:] != heads[:-1]])
    codes = np.repeat(heads[keep], runs[keep])
    p, j = both(lambda pk: pk.sequences.SequenceRunLength(codes, 4))
    check_sequence(p, j, codes, 4, rng)


@pytest.mark.parametrize("block", [64, 7])
def test_sequence_hybrid(block):
    rng = np.random.default_rng(block)
    codes = np.concatenate([np.repeat(rng.integers(0, 4, size=40), 256),
                            rng.integers(0, 4, size=3000)])
    p, j = both(lambda pk: pk.sequences.SequenceHybrid(codes, 4, block=block))
    check_sequence(p, j, codes, 4, rng)


# --------------------------------------------- hashing / mapper / permutation

def test_universal_hash():
    rng = np.random.default_rng(97)
    keys = rng.integers(0, 1 << 63, size=500, dtype=np.uint64)
    vals = []
    for seed in (3, 4):
        h, jh = both(lambda pk: pk.hashing.UniversalHash(97, seed=seed))
        vals.append(query(h, jh, "__call__", keys))
        assert (vals[-1] == h(keys)).all() and (0 <= vals[-1]).all() and (vals[-1] < 97).all()
    assert (vals[0] != vals[1]).any()


@pytest.mark.parametrize("n,gamma,tries", [(1, 1.23, 64), (2, 1.23, 64), (10, 1.23, 64),
                                           (500, 1.23, 64), (3000, 1.23, 64),
                                           (50, 1.15, 8), (50, 1.05, 8)])
def test_perfect_hash(n, gamma, tries):
    """A bijection onto [0, n); (50, 1.15) peels on its fourth attempt and
    (50, 1.05) on none, so both packages retry in the same order."""
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 62, size=2 * n, dtype=np.uint64))[:n]
    assert len(keys) == n
    if gamma == 1.05:
        for pk in (PORT, JAX):
            with pytest.raises(RuntimeError, match="peeling failed"):
                pk.hashing.PerfectHash(keys, gamma=gamma, max_tries=tries)
        return
    mph, jph = both(lambda pk: pk.hashing.PerfectHash(keys, gamma=gamma, max_tries=tries))
    vals = query(mph, jph, "lookup", keys)
    assert sorted(vals.tolist()) == list(range(n))
    query(mph, jph, "nbytes")


def test_compact_mapper():
    rng = np.random.default_rng(100000)
    ids = np.unique(rng.integers(0, 100000, size=300))
    m, jm = both(lambda pk: pk.mapper.CompactMapper(ids))
    dense = query(m, jm, "to_compact", ids)
    assert (dense == np.arange(len(ids))).all()
    assert (query(m, jm, "to_orig", dense) == ids).all()
    non = np.setdiff1d(np.arange(1000), ids)[:50]
    assert query(m, jm, "contains", ids[:50]).all()
    assert not query(m, jm, "contains", non).any()
    both(lambda pk: pk.mapper.CompactMapper(ids, universe=200000))
    query(m, jm, "nbytes")


def test_partial_sum():
    rng = np.random.default_rng(200)
    lengths = rng.integers(0, 50, size=200).astype(np.int64)
    lengths[lengths < 5] = 0  # plenty of empty segments
    ps, jp = both(lambda pk: pk.mapper.PartialSum(lengths))
    cums = np.cumsum(lengths)
    xs = rng.integers(0, int(cums[-1]), size=500)
    assert (query(ps, jp, "search", xs) == np.searchsorted(cums, xs, side="right")).all()
    starts = np.concatenate([[0], cums[:-1]])
    idx = np.flatnonzero(lengths > 0)
    assert (query(ps, jp, "accumulated_sum", idx) == starts[idx]).all()
    query(ps, jp, "nbytes")


@pytest.mark.parametrize("t", [2, 8, 64])
def test_permutation(t):
    rng = np.random.default_rng(t)
    n = 500
    pi = rng.permutation(n)
    p, j = both(lambda pk: pk.permutation.Permutation(pi, t=t))
    assert (query(p, j, "next", np.arange(n)) == pi).all()
    inv = np.argsort(pi)
    for i in rng.integers(0, n, size=60):
        assert query(p, j, "prev", int(i)) == inv[i]
    for i in range(n):
        query(p.inv, j.inv, "shortcut", i)
    query(p, j, "nbytes")


def test_sequence_permutation():
    rng = np.random.default_rng(23)
    sigma, n = 23, 1500
    codes = rng.integers(0, sigma, size=n)
    seq, js = both(lambda pk: pk.permutation.SequencePermutation(codes, sigma, block=128))
    for i in rng.integers(0, n, size=40):
        assert query(seq, js, "access", int(i)) == codes[i]
    for _ in range(40):
        c, i = int(rng.integers(0, sigma)), int(rng.integers(0, n))
        assert query(seq, js, "rank", c, i) == int((codes[:i + 1] == c).sum())
    for c in range(0, sigma, 5):
        pos = np.flatnonzero(codes == c)
        k = int(rng.integers(1, len(pos) + 1))
        assert query(seq, js, "select", c, k) == pos[k - 1]
    query(seq, js, "nbytes")


def test_inverted_index():
    rng = np.random.default_rng(9)
    sigma, n = 9, 2000
    codes = rng.integers(0, sigma, size=n)
    inv, ji = both(lambda pk: pk.permutation.InvertedIndex(codes, sigma))
    for c in range(sigma):
        pos = np.flatnonzero(codes == c)
        assert query(inv, ji, "count", c) == len(pos)
        assert (query(inv, ji, "posting", c, np.arange(1, len(pos) + 1)) == pos).all()
        xs = rng.integers(0, n, size=30)
        assert (query(inv, ji, "count_upto", c, xs) == np.searchsorted(pos, xs, "right")).all()
    query(inv, ji, "nbytes")


# ----------------------------------------------------------------- testutil

@pytest.mark.parametrize("kw", [dict(n_genomes=3, genome_len=6000, seed=2),
                                dict(n_genomes=2, genome_len=4000, seed=5, runs=False,
                                     rbbwt_b=16, sample_rate=8, precompute_width=6)])
def test_testutil(kw):
    from centrifuger_tpu import testutil as jt
    from centrifuger_tpu_torch import testutil as pt
    fm, genomes = pt.synthetic_fm(**kw)
    jfm, jgenomes = jt.synthetic_fm(**kw)
    assert_same(fm, jfm, "synthetic_fm")
    assert_same(genomes, jgenomes, "genomes")
    for args in ((50, 100), (20, 150, 3, 0.05)):
        assert_same(pt.sample_reads(genomes, *args), jt.sample_reads(jgenomes, *args))
