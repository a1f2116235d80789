"""The group ranks of kernels K7 and K8 (the group section of
rank_runblock.cuh, and mega_group_pair / mega_group_lf_rank of
rank_mega.cuh), on the CPU.

A numpy model computes what the 32 threads of a warp (RankGroup) do in each
of the two memory rounds of a BackwardExtend step or an LF step.

  round 1  thread 16 h + k of rank h: k < 8 word k of the 8 indicator words
           that hold bit bi (where a bit of it lies below bi + 1), k = 8 the
           count of ones before them, k = 9 the word before them (where
           bi + 1 starts them); both ranks' popcounts summed by one
           reduction, a byte each; the count and bi's type word shuffled
           from the thread that holds them.
  round 2  thread 8 p + k of probe p (the literal and the run stream of each
           rank): words [k W, k W + W) of the probe's 256-symbol block or
           row (where the count or the symbol needs one of them), thread
           8 p the occ entry of c, thread 8 p + 1 the word before the block
           (the symbol where pos + 1 starts a block); an LF step's threads
           t < sigma load occ entry t of both probes, and the count of the
           symbol is taken from the same words; the four counts summed by
           one reduction, a byte each.

The model is held to the plain twins (TorchFM._runblock_rank_sym, bwt_rank,
bwt_access, backward_extend, lf) and to the JAX DeviceFM (fm/device.py
:521, :372, :413, :612, :644) at every position of small indexes: the
mega-table, and the generic layout at 2, 4 and 8 bits a symbol (a nucleotide
index, a 10-letter alphabet, protein with sigma 21), int32 and int64; one
block over the whole BWT (b_lt_n false); an empty run stream.  Every load is
checked to lie inside its buffer, each byte of a reduction to stay below 256,
each shuffled word to have been loaded, and the edge cases to be reached:
pos = -1, the prev word (a position that ends a block), bi + 1 at an
indicator-row boundary, both block types, other == 0, the last row and
block.  And the identity that lets the symbol come from the rank's own block:
bwt_access reads the position that the rank of the block's own stream counts
to.
"""

import numpy as np
import pytest
import torch

from centrifuger_tpu.fm.builder import FMBuildParams, build_fm
from centrifuger_tpu.fm.device import DeviceFM
from centrifuger_tpu.testutil import synthetic_fm
from centrifuger_tpu_torch.fm import device as fd
from centrifuger_tpu_torch.fm.device_fused import MEGA_WORDS

from test_torch_kernels import family_fm, synthetic_protein_fm

torch.set_num_threads(1)   # the suite runs in several worker processes

UNITS = 32                 # threads of the warp: the model's unit u is thread u
M32 = 0xFFFFFFFF


def popcount(v):
    return fd._popcount32_np(np.asarray(v, np.int64) & M32).astype(np.int64)


def low_bits(nb):
    """The low nb bits, nb in [0, 32]."""
    return np.where(nb >= 32, M32, (np.int64(1) << np.minimum(nb, 31)) - 1)


def swar(w, c, width):
    """swar_match<W>: the low bit of every W-bit slot of w equal to c."""
    if width == 2:
        x = ~(w ^ (c * 0x55555555)) & M32
        return x & (x >> 1) & 0x55555555
    if width == 4:
        x = ~(w ^ (c * 0x11111111)) & M32
        x = x & (x >> 1)
        x = x & (x >> 2)
        return x & 0x11111111
    x = w ^ (c * 0x01010101)
    z = x | (x >> 4)
    z = z | (z >> 2)
    z = z | (z >> 1)
    return ~z & 0x01010101


def fetch(buf, idx, on):
    """buf[idx] where `on` (0 elsewhere); every load made lies inside buf."""
    idx = np.asarray(idx, np.int64)
    assert ((idx >= 0) & (idx < len(buf)))[on].all(), "a load outside its buffer"
    return np.where(on, buf[np.clip(idx, 0, len(buf) - 1)], 0)


def flat(t):
    """A table's words (uint32 bits) or counts as a flat int64 array."""
    a = t.numpy().reshape(-1)
    return (a.view(np.uint32) if a.dtype == np.int32 else a).astype(np.int64)


class Reached:
    """The edge cases a sweep reached."""

    def __init__(self):
        self.seen = set()

    def add(self, name, mask):
        if np.asarray(mask).any():
            self.seen.add(name)


# ------------------------------------------------------------- the model

def ind_pair(sides, reached):
    """Round 1 of two ranks: (r1 [2][M], typ [2][M])."""
    M = len(sides[0]["within"])
    rows = np.arange(M)
    w = np.zeros((M, UNITS), np.int64)
    on = np.zeros((M, UNITS), bool)
    cum = np.zeros((M, UNITS), np.int64)
    for u in range(UNITS):
        h, k = divmod(u, 16)
        s = sides[h]
        if k < 8:
            on[:, u] = s["need"] & (32 * k < s["within"])
            w[:, u] = fetch(s["arr"], s["w"] + k, on[:, u])
        elif k == 8:
            cum[:, u] = fetch(s["cum_arr"], s["cum"], s["need"])
        elif k == 9:
            on[:, u] = s["need"] & (s["within"] == 0)
            w[:, u] = fetch(s["arr"], s["w"] - 1, on[:, u])
    packed = np.zeros(M, np.int64)
    for h in range(2):
        s = sides[h]
        part = sum(popcount(w[:, 16 * h + k] & low_bits(np.clip(s["within"] - 32 * k, 0, 32)))
                   for k in range(8))
        assert (part < 256).all(), "a rank's popcount passes its byte"
        packed += part << (8 * h)
    r1, typ = [], []
    for h in range(2):
        s = sides[h]
        r1.append(cum[:, 16 * h + 8] + ((packed >> (8 * h)) & 255))
        tu = 16 * h + np.where(s["within"] == 0, 9, (s["within"] - 1) >> 5)
        assert on[rows, tu][s["need"]].all(), "the type word was not loaded"
        typ.append((w[rows, tu] >> s["bit"]) & 1)
        reached.add("bi + 1 starts an indicator row", s["need"] & (s["within"] == 0))
    return r1, typ


class StreamRound:
    """Round 2: four probes of 8 units; c [M] (BackwardExtend) or None (LF:
    occ entries [0, sigma) of probes 0 and 1)."""

    def __init__(self, probes, width, c, sigma, reached):
        self.p, self.W, self.PER, self.reached = probes, width, 32 // width, reached
        M = len(probes[0]["rem"])
        self.rows = np.arange(M)
        self.w = np.zeros((M, UNITS, width), np.int64)
        self.on = np.zeros((M, UNITS), bool)
        self.prev = np.zeros((M, UNITS), np.int64)
        self.occ = np.zeros((2, M, UNITS), np.int64)
        for u in range(UNITS):
            pi, k = divmod(u, 8)
            q = probes[pi]
            words = np.where(q["count"], -(-q["rem"] // self.PER), 0)
            sw = np.where(q["sym"] & (q["rem"] > 0), (q["rem"] - 1) // self.PER, -1)
            self.on[:, u] = (k * width < words) | ((sw >= 0) & (sw // width == k))
            for j in range(width):
                self.w[:, u, j] = fetch(q["arr"], q["w"] + k * width + j, self.on[:, u])
            if k == 1:
                self.prev[:, u] = fetch(q["arr"], q["w"] - 1, q["sym"] & (q["rem"] == 0))
            if c is not None and k == 0:
                self.occ[0, :, u] = fetch(q["occ_arr"], q["occ"] + c, q["count"])
            if c is None and u < sigma:
                for x in range(2):
                    px = probes[x]
                    self.occ[x, :, u] = fetch(px["occ_arr"], px["occ"] + u, px["count"])

    def sym(self, pi):
        q = self.p[pi]
        r = q["rem"]
        j = np.maximum(r - 1, 0) // self.PER
        u = 8 * pi + j // self.W
        used = q["sym"] & (r > 0)
        assert self.on[self.rows, u][used].all(), "the symbol's word was not loaded"
        self.reached.add("the symbol is the word before the block", q["sym"] & (r == 0))
        word = np.where(r == 0, self.prev[:, 8 * pi + 1], self.w[self.rows, u, j % self.W])
        slot = ((r + 255) & 255) % self.PER
        return (word >> (slot * self.W)) & ((1 << self.W) - 1)

    def counts(self, c):
        packed = np.zeros(len(c), np.int64)
        for pi in range(4):
            q = self.p[pi]
            cnt = np.zeros(len(c), np.int64)
            for k in range(8):
                for j in range(self.W):
                    keep = np.clip(q["rem"] - self.PER * (k * self.W + j), 0, self.PER)
                    cnt += popcount(swar(self.w[:, 8 * pi + k, j], c, self.W)
                                    & low_bits(keep * self.W))
            cnt = np.where(q["count"], cnt, 0)
            assert (cnt < 256).all(), "a probe's count passes its byte"
            packed += cnt << (8 * pi)
        return packed

    def rank(self, pi, packed):
        """The stream rank of probe pi (occ of c from unit 8 pi)."""
        q = self.p[pi]
        return np.where(q["count"], self.occ[0, :, 8 * pi] + ((packed >> (8 * pi)) & 255), 0)

    def rank_lf(self, pi, c, packed):
        q = self.p[pi]
        assert (c < UNITS).all()
        return np.where(q["count"], self.occ[pi, self.rows, c] + ((packed >> (8 * pi)) & 255), 0)


def rb_pos(fm, bi, inb, r1, typ, reached):
    b = fm.b
    ranki = np.where(typ == 1, r1, bi + 1 - r1) if fm.b_lt_n else np.ones_like(bi)
    other = bi + 1 - ranki
    is_lit = typ == 0
    reached.add("a literal block", is_lit)
    reached.add("a run block", ~is_lit)
    reached.add("other == 0", other == 0)
    return dict(inb=inb, other=other, is_lit=is_lit,
                lit=np.where(is_lit, (ranki - 1) * b + inb, other * b - 1),
                run=np.where(is_lit, other - 1, ranki - 1))


class MegaModel:
    """K8: the [R, 21] mega-table."""

    width = 2

    def __init__(self, fm):
        self.fm, self.mega = fm, flat(fm.mega)
        self.sigma = fm.sigma

    def side(self, bi, need):
        row = (bi + 1) >> 8
        return dict(arr=self.mega, w=row * MEGA_WORDS + 2, cum_arr=self.mega,
                    cum=row * MEGA_WORDS, within=(bi + 1) & 255, bit=bi & 31, need=need)

    def probe(self, lit, spos, count, sym):
        row = (self.fm.m_lit if lit else self.fm.m_run) + ((spos + 1) >> 8)
        return dict(arr=self.mega, w=row * MEGA_WORDS + 5, occ_arr=self.mega,
                    occ=row * MEGA_WORDS, rem=(spos + 1) & 255, count=count & (spos >= 0),
                    sym=sym)

    def rank(self, A, c, lit_r, run_r, run_sym):
        b = self.fm.b
        run_part = np.where(run_sym == c, (run_r - 1) * b + A["inb"] + 1, run_r * b)
        return np.where(A["is_lit"], lit_r + run_r * b, run_part + lit_r)


class GenericModel:
    """K7: the indicator bitvector and the two packed streams as stored."""

    def __init__(self, fm):
        self.fm, self.width, self.sigma = fm, fm.lit.width, fm.sigma
        self.ind, self.cum = flat(fm.ind.words), flat(fm.ind.cum)
        self.streams = {True: (flat(fm.lit.words), flat(fm.lit.occ), fm.lit_n),
                        False: (flat(fm.run.words), flat(fm.run.occ), fm.run_n)}

    def side(self, bi, need):
        grp = (bi + 1) >> 8
        return dict(arr=self.ind, w=grp * 8, cum_arr=self.cum, cum=grp,
                    within=(bi + 1) & 255, bit=bi & 31, need=need)

    def probe(self, lit, pos, count, sym):
        words, occ, n = self.streams[lit]
        on = (n > 0) & (pos >= 0)
        q = np.minimum(pos, n - 1)
        blk = (q + 1) >> 8
        return dict(arr=words, w=blk * 8 * self.width, occ_arr=occ, occ=blk * self.sigma,
                    rem=(q + 1) & 255, count=on & count, sym=on & sym)

    def rank(self, A, c, lit_r, run_r, run_sym):
        b = self.fm.b
        other0 = A["other"] == 0
        lit_rank = lit_r + np.where(other0, 0, run_r * b)
        ret = np.where(run_sym == c, (run_r - 1) * b + A["inb"] + 1, run_r * b) \
            if self.fm.run_n else np.zeros_like(c)
        return np.where(A["is_lit"], lit_rank, ret + np.where(other0, 0, lit_r))


def model_of(fm):
    return MegaModel(fm) if fm.layout == "runblock" else GenericModel(fm)


def group_pair(md, c, pa, need_a, pb, count_b, reached):
    """(rank of c at pa where need_a, rank of c at pb where count_b, the
    symbol at pb where not count_b): mega_group_pair / generic_group_pair."""
    b = md.fm.b
    pac = np.maximum(pa, 0)
    bi0, inb0, bi1, inb1 = pac // b, pac % b, pb // b, pb % b
    r1, typ = ind_pair([md.side(bi0, need_a), md.side(bi1, np.ones_like(need_a))], reached)
    A = rb_pos(md.fm, bi0, inb0, r1[0], typ[0], reached)
    B = rb_pos(md.fm, bi1, inb1, r1[1], typ[1], reached)
    probes = [md.probe(True, A["lit"], need_a, np.zeros_like(need_a)),
              md.probe(False, A["run"], need_a, need_a & ~A["is_lit"]),
              md.probe(True, B["lit"], count_b, ~count_b & B["is_lit"]),
              md.probe(False, B["run"], count_b, ~B["is_lit"])]
    rnd = StreamRound(probes, md.width, c, md.sigma, reached)
    cnt = rnd.counts(c)
    run_sym_a = np.where(probes[1]["sym"], rnd.sym(1), 0)
    run_sym_b = np.where(probes[3]["sym"], rnd.sym(3), 0)
    ra = np.where(need_a, md.rank(A, c, rnd.rank(0, cnt), rnd.rank(1, cnt), run_sym_a), 0)
    rb = np.where(count_b, md.rank(B, c, rnd.rank(2, cnt), rnd.rank(3, cnt), run_sym_b), 0)
    sym_b = np.where(B["is_lit"], np.where(probes[2]["sym"], rnd.sym(2), 0), run_sym_b)
    return ra, rb, sym_b


def group_lf_rank(md, p, reached):
    """(symbol at p, its rank at p): mega_group_lf_rank / generic_group_lf_rank."""
    b = md.fm.b
    bi, inb = p // b, p % b
    need = np.ones(len(p), bool)
    r1, typ = ind_pair([md.side(bi, need), md.side(bi, ~need)], reached)
    A = rb_pos(md.fm, bi, inb, r1[0], typ[0], reached)
    off = dict(arr=np.zeros(1, np.int64), w=np.zeros_like(p), occ_arr=np.zeros(1, np.int64),
               occ=np.zeros_like(p), rem=np.zeros_like(p), count=~need, sym=~need)
    probes = [md.probe(True, A["lit"], need, A["is_lit"]),
              md.probe(False, A["run"], need, ~A["is_lit"]), off, off]
    rnd = StreamRound(probes, md.width, None, md.sigma, reached)
    c = np.where(A["is_lit"], np.where(probes[0]["sym"], rnd.sym(0), 0),
                 np.where(probes[1]["sym"], rnd.sym(1), 0))
    cnt = rnd.counts(c)
    rank = md.rank(A, c, rnd.rank_lf(0, c, cnt), rnd.rank_lf(1, c, cnt), c)
    return c, rank


def extend(md, c, sp, ep, reached):
    """extend_from_ranks over the group pair (MegaLanes / GenericLanes)."""
    fm = md.fm
    r_sp, r_ep, sym_ep = group_pair(md, c, sp - 1, sp > 0, ep, sp != ep, reached)
    off = fm.psum.numpy().astype(np.int64)[c]
    last = c == fm.last_chr
    s = off + r_sp + (last & (sp <= fm.first_isa))
    nep = np.where(sp == ep, s - (sym_ep != c), off + r_ep + (last & (ep < fm.first_isa)) - 1)
    return s, nep


def lf(md, p, reached):
    fm = md.fm
    c, rank = group_lf_rank(md, p, reached)
    corr = (c == fm.last_chr) & (p < fm.first_isa)
    return fm.psum.numpy().astype(np.int64)[c] + rank + corr - 1


# ------------------------------------------------------------- indexes

def width4_fm():
    """An index over a 10-letter alphabet: streams of 4 bits a symbol."""
    rng = np.random.default_rng(3)
    recs = []
    for i in range(30):
        r = rng.integers(0, 10, int(rng.integers(200, 500))).astype(np.uint8)
        if i % 3 == 2:
            r = recs[-1].copy()
            r[rng.integers(0, len(r), 3)] = 1
        recs.append(r)
    return build_fm(np.concatenate(recs), [len(r) for r in recs], np.arange(len(recs)),
                    "ACDEFGHIKL", FMBuildParams(precompute_width=3))


def no_run_fm():
    """Random sequence with 64-symbol blocks: no run block, an empty run
    stream."""
    rng = np.random.default_rng(4)
    g = [rng.integers(0, 4, 9000).astype(np.uint8) for _ in range(2)]
    return build_fm(np.concatenate(g), [len(x) for x in g], np.arange(2), "ACGT",
                    FMBuildParams(rbbwt_b=64))


CASES = {
    # name: (host index maker, TorchFM keywords, the JAX DeviceFM's keywords)
    "mega": (lambda: family_fm()[0], dict(serve_layout="runblock"),
             dict(serve_layout="runblock")),
    "mega_no_runs": (no_run_fm, dict(serve_layout="runblock"), dict(serve_layout="runblock")),
    "mega_one_block": (lambda: synthetic_fm(n_genomes=2, genome_len=3000, seed=4,
                                            rbbwt_b=1)[0],
                       dict(serve_layout="runblock"), dict(serve_layout="runblock")),
    "w2": (lambda: family_fm()[0], dict(_generic=True), dict(serve_layout="runblock")),
    "w2_i64": (lambda: family_fm()[0], dict(_generic=True, force_idtype="int64"), None),
    "w2_no_runs": (no_run_fm, dict(_generic=True), dict(serve_layout="runblock")),
    "w4": (width4_fm, {}, {}),
    "w8": (lambda: synthetic_protein_fm()[0], {}, {}),
    "w8_i64": (lambda: synthetic_protein_fm()[0], dict(force_idtype="int64"), None),
    "w8_one_block": (lambda: synthetic_protein_fm(rbbwt_b=1 << 20)[0], {}, {}),
}

_BUILT = {}


def case(name):
    """(host index, TorchFM, its model, DeviceFM or None, the int32 TorchFM
    of an int64 case)."""
    if name not in _BUILT:
        make, kw, jax_kw = CASES[name]
        fm = make()
        tfm = fd.TorchFM(fd.fm_arrays(fm), device="cpu", **kw)
        ref = None
        if "force_idtype" in kw:
            ref = fd.TorchFM(fd.fm_arrays(fm), device="cpu",
                             **{k: v for k, v in kw.items() if k != "force_idtype"})
        _BUILT[name] = (fm, tfm, model_of(tfm), None if jax_kw is None else
                        DeviceFM(fm, **jax_kw), ref)
    return _BUILT[name]


def t64(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def i32(a):
    return np.asarray(a, np.int32)


def twin_rank_sym(tfm, c, pos):
    """The twins' rank of c at pos >= -1 and symbol at max(pos, 0)."""
    if tfm.layout == "runblock":
        r, s = tfm._runblock_rank_sym(t64(c), t64(pos))
    else:
        r, s = tfm.rank_sym(t64(c), t64(pos))
    return r.numpy(), s.numpy()


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("name", list(CASES))
def test_group_rank_and_access_model(name):
    """Every position pos in [-1, n): the pair's rank of sp - 1 (the first
    rank), the rank of ep (the second) and the symbol at ep (the second, where
    the ep count is skipped), against the twins and DeviceFM."""
    fm, tfm, md, dev, ref = case(name)
    assert tfm.layout == ("runblock" if name.startswith("mega") else "generic")
    if not name.startswith("mega"):
        assert md.width == int(name[1])
    rng = np.random.default_rng(1)
    n = tfm.n
    pos = np.arange(-1, n)
    c = rng.integers(0, tfm.sigma, len(pos))
    pb = rng.permutation(np.maximum(pos, 0))
    reached = Reached()
    ra, rb, _ = group_pair(md, c, pos, pos >= 0, pb, np.ones(len(pos), bool), reached)
    _, _, sym = group_pair(md, c, pos, pos >= 0, pb, np.zeros(len(pos), bool), reached)
    want_a, _ = twin_rank_sym(tfm, c, pos)
    want_b, want_sym = twin_rank_sym(tfm, c, pb)
    assert np.array_equal(ra, want_a) and np.array_equal(rb, want_b)
    assert np.array_equal(sym, want_sym)
    if ref is not None:   # int64: the int32 index's values
        assert np.array_equal(ra, twin_rank_sym(ref, c, pos)[0])
    if dev is not None:
        ok = pos >= 0
        if tfm.layout == "runblock":
            jr, js = dev._runblock_rank_sym(i32(c), i32(pos))
            assert np.array_equal(ra, np.asarray(jr))
        else:
            jr = dev.bwt_rank(i32(c[ok]), i32(pos[ok]))
            assert np.array_equal(ra[ok], np.asarray(jr))
        assert np.array_equal(sym, np.asarray(dev.bwt_access(i32(pb))))
    want = {"a literal block", "other == 0", "the symbol is the word before the block"}
    if fm.bwt.run.n:
        want.add("a run block")
    if (n - 1) // tfm.b >= 255:   # 256 blocks or more: a second indicator row
        want.add("bi + 1 starts an indicator row")
    assert want <= reached.seen, want - reached.seen
    assert (pos == -1).any() and (pos == n - 1).any()


@pytest.mark.parametrize("name", list(CASES))
def test_group_extend_model(name):
    """BackwardExtend over the group pair (MegaLanes / GenericLanes): from
    every sp, ranges one row wide, a few rows wide and reaching n - 1."""
    fm, tfm, md, dev, _ = case(name)
    rng = np.random.default_rng(2)
    n = tfm.n
    sp = np.arange(n)
    ep = np.minimum(sp + rng.integers(0, 300, n), n - 1)
    ep[::2] = sp[::2]
    c = rng.integers(0, tfm.sigma, n)
    c[::3] = tfm.last_chr
    reached = Reached()
    nsp, nep = extend(md, c, sp, ep, reached)
    tsp, tep = tfm.backward_extend(t64(c), t64(sp), t64(ep))
    assert np.array_equal(nsp, tsp.numpy()) and np.array_equal(nep, tep.numpy())
    if dev is not None:
        jsp, jep = dev.backward_extend(i32(c), i32(sp), i32(ep))
        assert np.array_equal(nsp, np.asarray(jsp)) and np.array_equal(nep, np.asarray(jep))
    assert (nsp <= nep).any() and (nsp > nep).any()


@pytest.mark.parametrize("name", list(CASES))
def test_group_lf_model(name):
    """An LF step from one fetch of its rows (the symbol, then its count from
    the same words), at every row."""
    fm, tfm, md, dev, _ = case(name)
    p = np.arange(tfm.n)
    got = lf(md, p, Reached())
    assert np.array_equal(got, tfm.lf(t64(p)).numpy())
    if dev is not None:
        assert np.array_equal(got, np.asarray(dev.lf(i32(p))))


@pytest.mark.parametrize("name", [k for k in CASES if not k.startswith("mega")])
def test_access_reads_the_rank_position(name):
    """The identity behind the symbol's free round: bwt_access's stream
    index equals the (clipped) position that the rank of the block's own
    stream counts to, at every idx (literal block: idx - b r1 = (r0 - 1) b +
    inb; run block: (idx - b r0) / b = r1 - 1 = ranki - 1)."""
    fm, tfm, md, _, _ = case(name)
    b, n = tfm.b, tfm.n
    idx = np.arange(n)
    bi, inb = idx // b, idx % b
    bits = fm.bwt.indicator
    typ = np.asarray(bits.access(bi)).astype(np.int64)
    r1 = np.asarray(bits.rank1_inclusive(bi)).astype(np.int64)
    r0 = bi + 1 - r1
    ranki = np.where(typ == 1, r1, r0) if tfm.b_lt_n else np.ones_like(bi)
    lit = typ == 0
    access_idx = np.where(lit, idx - b * r1, (idx - b * r0) // b)
    rank_pos = np.where(lit, (ranki - 1) * b + inb, ranki - 1)
    assert np.array_equal(access_idx, rank_pos)
    for is_lit, sn in ((True, tfm.lit_n), (False, tfm.run_n)):
        m = lit == is_lit
        if sn == 0:
            continue
        clipped = np.clip(rank_pos[m], 0, sn - 1)
        stream = fm.bwt.lit if is_lit else fm.bwt.run
        assert np.array_equal(np.asarray(stream.access(clipped)),
                              np.asarray(fm.bwt.access(idx[m])))


@pytest.mark.parametrize("name", [k for k in CASES if not k.startswith("mega")])
def test_whole_blocks_lie_inside_the_buffers(name):
    """The group loads whole stream blocks and whole indicator groups where
    the one-thread rank stops at the words it needs: for every position up
    to n - 1 the block (and its occ row) and the 8-word group lie inside
    their buffers."""
    _, tfm, md, _, _ = case(name)
    pos = np.arange(tfm.n)
    grp = (pos // tfm.b + 1) >> 8
    assert (grp * 8 + 8 <= tfm.ind.words.numel()).all()
    assert (grp < tfm.ind.cum.numel()).all()
    for stream, sn in ((tfm.lit, tfm.lit_n), (tfm.run, tfm.run_n)):
        if sn == 0:
            continue
        blk = (np.arange(sn) + 1) >> 8
        assert stream.words.shape[1] == 8 * md.width
        assert (blk < stream.words.shape[0]).all()
        assert ((blk + 1) * tfm.sigma <= stream.occ.numel()).all()
