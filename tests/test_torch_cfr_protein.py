"""The reference-built protein index, tests/fixtures/tiny_protein/refidx.*.cfr,
through the port's .cfr reader (interop/cfr.py): its .1.cfr is a
Sequence_RunBlockOneTree BWT (per-symbol _alphabetRB bitvectors, then one
wavelet tree over the mixed block stream). The decoded index equals the one
the port builds from ref.fa with --protein; the load-time self-check raises on
a corrupted copy; cfr-classify-torch on the .cfr-only prefix gives the
reference's goldens byte for byte. The JAX package's reader parses every
.1.cfr as the nucleotide layout and raises on this file: there the port parts
from it on purpose."""

import contextlib
import io
import os
import shutil
import struct

import numpy as np
import pytest

from conftest import FIXTURE_DIR
from test_golden_classify import assert_tsv_equal

PFX = os.path.join(FIXTURE_DIR, "tiny_protein")
CFR = os.path.join(PFX, "refidx")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """tiny_protein built by the port's builder (--protein), loaded."""
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.cli import build_cli
    prefix = str(tmp_path_factory.mktemp("port_protein") / "idx")
    with contextlib.redirect_stderr(io.StringIO()):
        assert build_cli.main([
            "-r", os.path.join(PFX, "ref.fa"), "--taxonomy-tree",
            os.path.join(PFX, "nodes.dmp"), "--name-table", os.path.join(PFX, "names.dmp"),
            "--conversion-table", os.path.join(PFX, "ref_seqid.map"), "--protein",
            "-o", prefix]) == 0
    return load_index(prefix)


def test_one_tree_load_matches_the_port_build(built):
    from centrifuger_tpu_torch.interop.cfr import load_cfr_index, load_cfr_meta
    assert load_cfr_meta(CFR)["sequence_type"] == "amino_acid"
    fm, tax, seq_length, meta = load_cfr_index(CFR)
    bfm, btax, bseq_length, _ = built
    assert meta["sequence_type"] == "amino_acid"
    assert not hasattr(fm, "source_prefix")     # no wide-row cache beside it
    assert (fm.n, fm.sigma, fm.alphabet) == (12004, 21, "$ARNDCEQGHILKMFPSTWYV")
    assert np.array_equal(fm.bwt.decode(), bfm.bwt.decode())
    assert fm.bwt.b == bfm.bwt.b == fm.n          # the b == 1 "no compression" case
    for k in ("sigma", "alphabet", "last_chr", "first_isa", "code_bits",
              "precompute_width", "sample_rate", "adjusted_sa0", "has_end_marker",
              "selected_rows"):
        assert getattr(fm, k) == getattr(bfm, k), k
    for k in ("psum", "ftab_start", "ftab_len", "sampled_sa", "end_marker_sa"):
        assert np.array_equal(getattr(fm, k), getattr(bfm, k)), k
    assert seq_length == bseq_length
    assert tax.names == btax.names and np.array_equal(tax.parent, btax.parent)


def test_jax_loader_still_raises():
    """The JAX reader parses the one-tree file as two trees and raises (its
    first tree decodes 0 codes); the port does not copy that."""
    from centrifuger_tpu.interop.cfr import load_cfr_index as jax_load
    with pytest.raises(ValueError):
        jax_load(CFR)


# ------------------------------------------------------- the load-time check

def _leaf_pair_node(data):
    """(offset of the words, bit count) of the largest wavelet-tree node of
    the .1.cfr whose two children are leaves: a bit flipped there turns one
    code into its sibling and moves no other code."""
    from centrifuger_tpu_torch.interop import cfr
    r = cfr._R(data)
    r.u64(), r.u64(), r.u64(), r.u8()               # n, code_bits, firstISA, lastChr
    r.u64(), r.u64()                                # Sequence::_space, n
    sigma = cfr._read_alphabet(r)["n"]
    r.u64(), r.u64()                                # b, block count
    cfr._read_bitvector_plain(r)                    # indicator
    for _ in range(sigma):
        cfr._read_bitvector_plain(r)                # _alphabetRB
    r.u64(), r.u64()                                # the tree's _space, n
    cfr._read_alphabet(r)
    node_cnt = r.i32()
    r.i32()
    best = None
    for _ in range(node_cnt):
        r.u64(), r.i32()
        children = (r.i32(), r.i32())
        at = r.o + 32                               # past the Bitvector_Plain header
        bn, _ = cfr._read_bitvector_plain(r)
        if children == (-1, -1) and (best is None or bn > best[1]):
            best = (at, bn)
    return best


def _bit(data, at, i):
    return (data[at + i // 8] >> (i % 8)) & 1


@pytest.mark.parametrize("flip", ["one_bit", "two_bits_counts_kept"])
def test_self_check_raises_on_a_corrupted_copy(tmp_path, flip):
    """One flipped bit changes a symbol's count (psum catches it); two
    opposite flips in one node keep every count, and the sampled ftab rows'
    backward searches catch them."""
    from centrifuger_tpu_torch.interop.cfr import load_cfr_index
    data = bytearray(open(CFR + ".1.cfr", "rb").read())
    at, bn = _leaf_pair_node(data)
    assert bn > 100
    if flip == "one_bit":
        flips = [bn // 3]
        match = "disagrees with psum at symbol"
    else:
        ones = [i for i in range(bn) if _bit(data, at, i)]
        zeros = [i for i in range(bn) if not _bit(data, at, i)]
        flips = [ones[0], zeros[-1]] if ones[0] < zeros[-1] else [zeros[0], ones[-1]]
        match = "disagrees with the stored ftab at row"
    for i in flips:
        data[at + i // 8] ^= 1 << (i % 8)
    bad = str(tmp_path / "refidx")
    with open(bad + ".1.cfr", "wb") as f:
        f.write(data)
    for part in (2, 3, 4):
        shutil.copy("%s.%d.cfr" % (CFR, part), "%s.%d.cfr" % (bad, part))
    with pytest.raises(ValueError, match=match) as e:
        load_cfr_index(bad)
    assert bad + ".1.cfr" in str(e.value)


def test_select_directory_names_the_one_tree_bitvector():
    from centrifuger_tpu_torch.interop import cfr
    record = struct.pack("<QQiiii", 0, 64, 0, 0, 1, 3) + struct.pack("<Q", 1) \
        + struct.pack("<QQ", 0, 1) + struct.pack("<QQ", 0, 0) \
        + struct.pack("<QQi", 0, 1, 1)
    with pytest.raises(NotImplementedError, match=r"one-tree _alphabetRB\[3\]"):
        cfr._read_bitvector_plain(cfr._R(record), "one-tree _alphabetRB[3]")


# ------------------------------------------------------------- the CLI

@pytest.mark.parametrize("tag,extra", [("k1", []), ("k2", ["-k", "2"]), ("k5", ["-k", "5"])])
def test_cli_cfr_prefix_gives_the_goldens(tag, extra):
    from centrifuger_tpu_torch.cli import classify_cli
    before = sorted(os.listdir(PFX))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert classify_cli.main(["-x", CFR, "--device", "cpu",
                                  "-u", os.path.join(PFX, "reads_1.fq")] + extra) == 0
    golden = os.path.join(PFX, "golden_class_%s.tsv" % tag)
    assert_tsv_equal(buf.getvalue(), golden)
    with open(golden) as f:
        assert buf.getvalue() == f.read()
    assert sorted(os.listdir(PFX)) == before      # no cache file beside the prefix


# ------------------------------------------- the compressed branch (b < n)

def _split_one_tree(codes, b):
    """The one-tree split of codes with block size b, by the port's run-block
    rule (a block is a run block when its codes are all equal): the indicator
    bits, the mixed stream (a literal block's codes, one code for a run
    block) and, per symbol, which of its occurrences in the mixed stream
    stand for a run block."""
    n = len(codes)
    starts = np.arange(0, n, b)
    ends = np.minimum(starts + b, n)
    is_run = np.array([(codes[s:e] == codes[s]).all() for s, e in zip(starts, ends)])
    mixed, flags = [], []
    for s, e, run in zip(starts, ends, is_run):
        part = codes[s:s + 1] if run else codes[s:e]
        mixed.extend(part.tolist())
        flags.extend([run] * len(part))
    mixed, flags = np.array(mixed, np.uint8), np.array(flags, bool)
    return is_run, mixed, [flags[mixed == c] for c in range(21)]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("b", [2, 3, 7, 16, 64])
def test_one_tree_rebuild_round_trip(seed, b):
    """A round-trip of the port's own rule, not a check against a
    reference-built file (no file in the repo has a run block): random
    sigma-21 codes with long runs, split and rebuilt."""
    from centrifuger_tpu_torch.fm.runblock import RunBlockSeq
    from centrifuger_tpu_torch.interop.cfr import _reconstruct_codes_one_tree
    rng = np.random.default_rng(seed)
    runs = rng.integers(0, 21, 300).astype(np.uint8)
    lens = np.where(rng.random(300) < 0.3, rng.integers(20, 200, 300),
                    rng.integers(1, 4, 300))
    codes = np.repeat(runs, lens)
    is_run, mixed, rb = _split_one_tree(codes, b)
    assert 0 < is_run.sum() < len(is_run)
    rbs = RunBlockSeq.from_codes(codes, 21, b=b)
    assert np.array_equal(rbs.indicator.access(np.arange(rbs.block_cnt)) == 1, is_run)
    assert np.array_equal(_reconstruct_codes_one_tree(len(codes), b, is_run, mixed, rb),
                          codes)
    # bits past a bitvector's end read 0: a symbol with no run block may
    # store an empty one
    lit_only = [c for c in range(21) if len(rb[c]) and not rb[c].any()]
    short = [np.zeros(0, bool) if c in lit_only else bits for c, bits in enumerate(rb)]
    assert np.array_equal(
        _reconstruct_codes_one_tree(len(codes), b, is_run, mixed, short), codes)
    # _alphabetRB bits that disagree with the indicator are refused
    c = int(np.flatnonzero([bits.any() for bits in rb])[0])
    wrong = [bits.copy() for bits in rb]
    wrong[c][np.flatnonzero(wrong[c])[0]] = False
    with pytest.raises(ValueError, match="disagrees with the indicator"):
        _reconstruct_codes_one_tree(len(codes), b, is_run, mixed, wrong)
