# Port copy of centrifuger_tpu.interop.cfr, the load side (host code, no accelerator).
"""Reader for the reference centrifuger `.cfr` index format.

Parses the raw little-endian struct dumps written by the reference's
SAVE_VAR/SAVE_ARR macros (compactds/Utils.hpp:67-71) for the four index files
(Builder::Save, reference Builder.hpp:280-313):
  prefix.1.cfr  FM-index (FMIndex::Save, compactds/FMIndex.hpp:571-586)
  prefix.2.cfr  taxonomy  (Taxonomy::Save, Taxonomy.hpp:1114-1133)
  prefix.3.cfr  seq lengths (size_t pairs)
  prefix.4.cfr  plaintext metadata

The run-block BWT is reconstructed by vectorized wavelet-tree decoding into
our flat PackedSeq representation, from either of the reference's layouts:
Sequence_RunBlock (nucleotide: literal and run streams, two wavelet trees) or
Sequence_RunBlockOneTree (protein: one wavelet tree over the mixed stream and
per-symbol _alphabetRB bitvectors), chosen by the sequence_type of
prefix.4.cfr; a one-tree decode is checked against the stored F column and
ftab before it is served; all auxiliary tables (sampled SA seqids,
ftab, selected rows, end markers) are copied verbatim, so a reference-built
index drops into this framework with identical classification output.
The writer is cfr_write.py (cfr-build-torch --emit-cfr).
"""

import os
import struct

import numpy as np

from ..fm.index import FMIndexData
from ..fm.runblock import RunBlockSeq
from ..spans import span
from ..taxonomy.taxonomy import Taxonomy


class _R:
    def __init__(self, data):
        self.d = data
        self.o = 0

    def u64(self):
        v = struct.unpack_from("<Q", self.d, self.o)[0]
        self.o += 8
        return v

    def i32(self):
        v = struct.unpack_from("<i", self.d, self.o)[0]
        self.o += 4
        return v

    def u8(self):
        v = self.d[self.o]
        self.o += 1
        return v

    def bytes(self, n):
        v = self.d[self.o:self.o + n]
        self.o += n
        return v

    def arr(self, dtype, count):
        dt = np.dtype(dtype)
        v = np.frombuffer(self.d, dtype=dt, count=count, offset=self.o)
        self.o += dt.itemsize * count
        return v.copy()


def _words_for_bits(n):
    return (n + 63) // 64


def _read_alphabet(r):
    r.u64()  # _space
    method = r.i32()
    n = r.u64()
    out = {"method": method, "n": n, "list": b""}
    if n != 0:
        out["list"] = bytes(r.bytes(n))
        out["code"] = r.arr("<i4", 256)
        out["codelen"] = r.arr("<i2", 256)
    return out


def _read_bitvector_plain(r, what="bitvector"):
    r.u64()  # Bitvector::_space
    n = r.u64()
    r.i32()  # _rb
    r.i32()  # _sb
    r.i32()  # _selectSpeed
    r.i32()  # _selectTypeSupport
    words = np.zeros(0, dtype=np.uint64)
    if n > 0:
        words = r.arr("<u8", _words_for_bits(n))
        # DS_Rank9
        r.u64()  # _space
        word_cnt = r.u64()
        blk = (word_cnt + 7) // 8
        r.arr("<u8", blk * 2)
        # DS_Select
        r.u64()  # _space
        sn = r.u64()
        speed = r.i32()
        if speed != 0 and sn != 0:
            raise NotImplementedError(
                "select directories in .cfr not supported (%s)" % what)
    return n, words


def _bits_from_words(words, n):
    b = np.frombuffer(words.tobytes(), dtype=np.uint8)
    bits = np.unpackbits(b, bitorder="little")[:n]
    return bits.astype(bool)


def _read_wavelet(r):
    """Parse Sequence_WaveletTree and decode to a uint8 code array."""
    r.u64()  # Sequence::_space
    n = r.u64()
    alpha = _read_alphabet(r)
    node_cnt = r.i32()
    r.i32()  # _selectSpeed
    nodes = []
    for _ in range(node_cnt):
        prefix = r.u64()
        prefix_len = r.i32()
        children = (r.i32(), r.i32())
        bn, words = _read_bitvector_plain(r)
        nodes.append(dict(prefix=prefix, prefix_len=prefix_len,
                          children=children, n=bn, words=words))
    if n == 0 or node_cnt == 0:
        return np.zeros(0, dtype=np.uint8), alpha

    # vectorized decode: route element indices down the tree, assigning the
    # accumulated code at leaves (mirrors Sequence_WaveletTree::Access), then
    # map (path code, length) back to the PLAIN symbol index via the stored
    # alphabet code tables — required for Huffman-coded alphabets
    # (Alphabet.hpp:74-91), where the path code need not equal the list index.
    out = np.zeros(n, dtype=np.uint8)
    path_to_sym = {}
    if alpha["n"]:
        for i, ch in enumerate(alpha["list"]):
            path_to_sym[(int(alpha["code"][ch]),
                         int(alpha["codelen"][ch]))] = i
    stack = [(0, np.arange(n, dtype=np.int64), 0, 0)]  # (node, idx, code, depth)
    while stack:
        ti, idx, code, depth = stack.pop()
        node = nodes[ti]
        bits = _bits_from_words(node["words"], node["n"])[:len(idx)]
        for b in (0, 1):
            sel = idx[bits == b] if b == 1 else idx[~bits]
            child = node["children"][b]
            ncode = (code << 1) | b
            if len(sel) == 0:
                continue
            if child == -1:
                out[sel] = path_to_sym.get((ncode, depth + 1), ncode)
            else:
                stack.append((child, sel, ncode, depth + 1))
    return out, alpha


def _read_fixed_array(r):
    r.u64()  # _size
    l = r.i32()
    n = r.u64()
    words = r.arr("<u8", _words_for_bits(n * l))
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    bits = np.unpackbits(np.frombuffer(words.tobytes(), np.uint8),
                         bitorder="little")[:n * l]
    vals = bits.reshape(n, l).astype(np.int64)
    shifts = (np.int64(1) << np.arange(l, dtype=np.int64))
    return (vals * shifts[None, :]).sum(axis=1)


def load_cfr_fm(path, protein=False):
    """Parse prefix.1.cfr into an FMIndexData; protein selects the one-tree
    BWT layout (the .4.cfr says amino_acid)."""
    with open(path, "rb") as f:
        r = _R(f.read())
    fm = FMIndexData()
    n = r.u64()
    code_bits = r.u64()
    first_isa = r.u64()
    last_chr_char = r.u8()

    # Sequence_RunBlock
    r.u64()  # Sequence::_space
    rb_n = r.u64()
    rb_alpha = _read_alphabet(r)  # runblock's own alphabet
    b = r.u64()
    block_cnt = r.u64()
    ind_n, ind_words = _read_bitvector_plain(r)
    if protein:
        # Sequence_RunBlockOneTree: one _alphabetRB bitvector per symbol of
        # the sequence's alphabet, then one wavelet tree over the mixed stream
        alphabet_rb = [_read_bitvector_plain(r, "one-tree _alphabetRB[%d]" % c)
                       for c in range(rb_alpha["n"])]
        mixed_codes, _ = _read_wavelet(r)
    else:
        lit_codes, lit_alpha = _read_wavelet(r)
        run_codes, run_alpha = _read_wavelet(r)

    alphabets = _read_alphabet(r)
    plain_coder = _read_alphabet(r)
    alphabet = plain_coder["list"].decode()
    sigma = len(alphabet)
    psum = r.arr("<u8", sigma + 1).astype(np.int64)

    # _FMIndexAuxData::Save (reference FMIndex.hpp:100-134)
    r.u64()            # n
    r.i32()            # sampleStrategy
    sample_rate = r.i32()
    r.u64()            # sampleSize
    precompute_width = r.u64()
    precompute_size = r.u64()
    adjusted_sa0 = r.u64()
    sampled_sa = _read_fixed_array(r)
    pr = r.arr("<u8", precompute_size * 2).reshape(precompute_size, 2)
    max_lcp = r.u64()
    if max_lcp > 0:
        r.arr("<u8", _words_for_bits(n))
        r.arr("<u8", _words_for_bits(n))
    sel_size = r.u64()
    r.i32()            # selectedSAFilterSampleRate
    sel = r.arr("<u8", sel_size * 2).reshape(sel_size, 2) if sel_size else \
        np.zeros((0, 2), dtype=np.uint64)
    has_end_marker = False
    end_marker = None
    if r.o < len(r.d):
        has_end_marker = r.u8() != 0
        if has_end_marker:
            end_marker = _read_fixed_array(r)

    # rebuild the run-block sequence from the decoded streams: reconstruct the
    # full BWT codes and re-split with the stored block size (the split rule is
    # deterministic, Sequence_RunBlock.hpp:249-269)
    ind_bits = _bits_from_words(ind_words, ind_n) if ind_n else np.zeros(0, bool)
    if protein:
        rb_bits = [_bits_from_words(w, bn) if bn else np.zeros(0, bool)
                   for bn, w in alphabet_rb]
        bwt = _reconstruct_codes_one_tree(n, b, ind_bits, mixed_codes, rb_bits)
        _check_one_tree_counts(bwt, psum, path)
    else:
        bwt = _reconstruct_codes(n, b, ind_bits, lit_codes, run_codes)
    rbs = RunBlockSeq.from_codes(bwt, sigma, b=int(b) if b < n else 1)

    fm.n = int(n)
    fm.alphabet = alphabet
    fm.sigma = sigma
    fm.code_bits = int(code_bits)
    fm.first_isa = int(first_isa)
    # last_chr is stored as the raw character; convert to plain code
    fm.last_chr = alphabet.index(chr(last_chr_char))
    fm.precompute_width = int(precompute_width)
    fm.sample_rate = int(sample_rate)
    fm.adjusted_sa0 = int(adjusted_sa0)
    fm.has_end_marker = has_end_marker
    fm.psum = psum
    fm.ftab_start = pr[:, 0].astype(np.int64)
    fm.ftab_len = pr[:, 1].astype(np.int64)
    fm.sampled_sa = sampled_sa
    if sel_size:
        order = np.argsort(sel[:, 0])
        fm.selected_rows = sel[order, 0].astype(np.int64)
        fm.selected_vals = sel[order, 1].astype(np.int64)
    fm.end_marker_sa = end_marker
    fm.bwt = rbs
    if protein:
        _check_one_tree_ftab(fm, pr, path)
    return fm


def _reconstruct_codes(n, b, ind_bits, lit_codes, run_codes):
    """Invert the run-block split (Sequence_RunBlock::Decompress semantics)."""
    n = int(n)
    b = int(b)
    out = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return out
    block_cnt = (n + b - 1) // b
    starts = np.arange(block_cnt, dtype=np.int64) * b
    ends = np.minimum(starts + b, n)
    sizes = ends - starts
    is_run = np.zeros(block_cnt, dtype=bool)
    is_run[:len(ind_bits)] = ind_bits[:block_cnt]
    # run blocks: one code each, repeated
    run_sizes = sizes[is_run]
    if run_sizes.size:
        out_positions = np.repeat(starts[is_run], run_sizes) + \
            _concat_aranges(run_sizes)
        out[out_positions] = np.repeat(run_codes[:is_run.sum()], run_sizes)
    lit_sizes = sizes[~is_run]
    if lit_sizes.size:
        out_positions = np.repeat(starts[~is_run], lit_sizes) + \
            _concat_aranges(lit_sizes)
        out[out_positions] = lit_codes[:lit_sizes.sum()]
    return out


def _reconstruct_codes_one_tree(n, b, ind_bits, mixed, alphabet_rb):
    """Invert the one-tree split (Sequence_RunBlockOneTree): the mixed stream
    holds, block by block, a literal block's codes and one code for a run
    block; bit j of alphabet_rb[c] says whether the j-th c of the mixed stream
    stands for a run block (bits past a bitvector's end read 0).  Those bits
    must agree with the indicator, or the layout was misread: ValueError."""
    n = int(n)
    b = int(b)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    mixed = np.asarray(mixed, dtype=np.uint8)
    block_cnt = (n + b - 1) // b
    starts = np.arange(block_cnt, dtype=np.int64) * b
    sizes = np.minimum(starts + b, n) - starts
    is_run = np.zeros(block_cnt, dtype=bool)
    is_run[:len(ind_bits)] = ind_bits[:block_cnt]
    per_block = np.where(is_run, 1, sizes)
    if int(per_block.sum()) != len(mixed):
        raise ValueError("one-tree mixed stream holds %d codes, the indicator "
                         "needs %d" % (len(mixed), int(per_block.sum())))
    mixed_is_run = np.repeat(is_run, per_block)
    # occurrence number of each mixed code among the codes equal to it
    order = np.argsort(mixed, kind="stable")
    counts = np.bincount(mixed, minlength=len(alphabet_rb))
    if len(counts) > len(alphabet_rb):
        raise ValueError("one-tree mixed stream has code %d past the %d "
                         "_alphabetRB bitvectors" % (len(counts) - 1, len(alphabet_rb)))
    flags = np.zeros(len(mixed), dtype=bool)
    for c, bits in enumerate(alphabet_rb):
        if len(bits) > counts[c]:
            raise ValueError("one-tree _alphabetRB[%d] has %d bits for %d codes"
                             % (c, len(bits), counts[c]))
        start = int(counts[:c].sum())
        flags[order[start:start + len(bits)]] = bits
    if not np.array_equal(flags, mixed_is_run):
        first = int(np.flatnonzero(flags != mixed_is_run)[0])
        raise ValueError("one-tree _alphabetRB disagrees with the indicator at "
                         "mixed position %d (code %d)" % (first, mixed[first]))
    reps = np.repeat(np.where(is_run, sizes, 1), per_block)
    return np.repeat(mixed, reps)


# stored ftab rows that a one-tree load recomputes by backward search
ONE_TREE_CHECK_ROWS = 256


def _check_one_tree_counts(codes, psum, path):
    """The first half of a one-tree load's gate: the decoded codes' symbol
    counts must equal psum's differences (ValueError naming the file and the
    first differing symbol)."""
    want = np.diff(psum)
    got = np.bincount(codes, minlength=len(want))
    if len(got) != len(want) or not np.array_equal(got, want):
        bad = len(want) if len(got) != len(want) else int(np.flatnonzero(got != want)[0])
        raise ValueError("%s: the decoded one-tree BWT disagrees with psum at "
                         "symbol %d" % (path, bad))


def _check_one_tree_ftab(fm, pr, path):
    """The second half: ONE_TREE_CHECK_ROWS stored ftab rows, drawn with a
    fixed seed (three in four from the non-empty rows, the rest from the
    whole table), must equal the backward search of their k-mer over the
    served BWT (ValueError naming the file and the first differing row)."""
    rows = len(pr)
    if rows == 0:
        return
    rng = np.random.default_rng(0)
    full = np.flatnonzero(pr[:, 1] > 0)
    k = min(len(full), ONE_TREE_CHECK_ROWS * 3 // 4)
    pick = np.concatenate([rng.choice(full, k, replace=False),
                           rng.integers(0, rows, ONE_TREE_CHECK_ROWS - k)])
    pick = np.unique(pick)
    # k-mer characters, the first in the lowest code_bits (the ftab's order)
    mask = (1 << fm.code_bits) - 1
    chars = [(pick >> (fm.code_bits * j)) & mask for j in range(fm.precompute_width)]
    valid = np.all([ch < fm.sigma for ch in chars], axis=0)
    start = np.zeros(len(pick), np.int64)
    length = np.zeros(len(pick), np.int64)
    if valid.any():
        cv = [np.where(valid, ch, 0) for ch in chars]
        c = cv[-1]
        sp, ep = fm.psum[c], fm.psum[c + 1] - 1
        alive = valid & (sp <= ep)
        for ch in cv[-2::-1]:
            # an emptied range stays empty: extend a stand-in row instead
            sp, ep = fm.backward_extend(ch, np.where(alive, sp, 0), np.where(alive, ep, 0))
            alive &= sp <= ep
        length = np.where(alive, ep - sp + 1, 0)
        start = np.where(alive, sp, 0)
    stored = pr[pick].astype(np.int64)
    same = (stored[:, 1] == length) & ((length == 0) | (stored[:, 0] == start))
    if not same.all():
        i = int(np.flatnonzero(~same)[0])
        raise ValueError(
            "%s: the decoded one-tree BWT disagrees with the stored ftab at row "
            "%d: stored (start %d, len %d), backward search (start %d, len %d)"
            % (path, int(pick[i]), stored[i, 0], stored[i, 1], start[i], length[i]))


def _concat_aranges(sizes):
    total = int(sizes.sum())
    idx = np.arange(total, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return idx - np.repeat(offsets, sizes)


def load_cfr_taxonomy(path):
    """Parse prefix.2.cfr into our Taxonomy."""
    with open(path, "rb") as f:
        r = _R(f.read())
    t = Taxonomy()
    node_cnt = r.u64()
    seq_cnt = r.u64()
    extra_cnt = r.u64()
    nodes = r.arr("<u8,<u1,<u1,(6,)<u1", node_cnt)
    t.node_cnt = int(node_cnt)
    t.parent = nodes["f0"].astype(np.int64)
    t.rank = nodes["f1"].astype(np.uint8)
    t.leaf = nodes["f2"].astype(bool)
    # MapID<uint64>
    map_n = r.u64()
    t.orig_ids = r.arr("<u8", map_n)
    t._orig_to_compact = {int(o): i for i, o in enumerate(t.orig_ids)}
    t.names = []
    for _ in range(node_cnt):
        ln = r.u64()
        t.names.append(bytes(r.bytes(ln)).decode())
    t.seq_id_to_tax = r.arr("<u8", seq_cnt).astype(np.int64)
    t.seq_cnt = int(seq_cnt)
    t.extra_seq_cnt = int(extra_cnt)
    t.seq_names = []
    t.seq_name_to_id = {}
    for i in range(seq_cnt + extra_cnt):
        ln = r.u64()
        s = bytes(r.bytes(ln)).decode()
        t.seq_names.append(s)
        t.seq_name_to_id.setdefault(s, i)
    t.root_ctax = t._find_root()
    return t


def load_cfr_seq_lengths(path):
    with open(path, "rb") as f:
        data = f.read()
    arr = np.frombuffer(data, dtype="<u8").reshape(-1, 2)
    return {int(a): int(b) for a, b in arr}


def load_cfr_meta(prefix):
    """The plaintext metadata of prefix.4.cfr as a dict ({} without it)."""
    meta = {}
    if os.path.exists(prefix + ".4.cfr"):
        with open(prefix + ".4.cfr") as f:
            for line in f:
                parts = line.split("\t", 1)
                if len(parts) == 2:
                    meta[parts[0].strip()] = parts[1].strip()
    return meta


def load_cfr_index(prefix):
    """Load a reference-built index (prefix.{1,2,3}.cfr + metadata).  The FM
    index carries no source_prefix: no wide-row cache is written beside a
    reference-built index.  Its time counts into the process totals as the
    span load.index (spans.py)."""
    with span("load.index"):
        meta = load_cfr_meta(prefix)
        fm = load_cfr_fm(prefix + ".1.cfr",
                         protein=meta.get("sequence_type") == "amino_acid")
        tax = load_cfr_taxonomy(prefix + ".2.cfr")
        seq_length = load_cfr_seq_lengths(prefix + ".3.cfr")
    return fm, tax, seq_length, meta
