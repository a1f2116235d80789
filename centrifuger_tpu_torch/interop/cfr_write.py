# Port copy of centrifuger_tpu.interop.cfr_write (host code, no accelerator).
"""Writer for the reference centrifuger `.cfr` index format.

Emits the exact little-endian struct dumps the reference binary loads
(SAVE_VAR/SAVE_ARR macros, reference compactds/Utils.hpp:67-71):
  prefix.1.cfr  FM-index      (FMIndex::Save, compactds/FMIndex.hpp:571-586)
  prefix.2.cfr  taxonomy      (Taxonomy::Save, Taxonomy.hpp:1114-1133)
  prefix.3.cfr  seq lengths   (size_t pairs, Builder.hpp:297-305)
  prefix.4.cfr  plaintext kv  (OutputBuilderMeta, Builder.hpp:267-278)

This is the reverse of interop/cfr.py: an index built by THIS framework can
be validated by the reference binary (the strongest cross-implementation
check).  Every sub-structure replicates the reference's construction:
  * DS_Rank9 interleaved directory   (compactds/DS_Rank.hpp:205-248)
  * balanced wavelet tree, preorder  (Sequence_WaveletTree.hpp:104-133)
  * run-block split streams          (Sequence_RunBlock.hpp:231-358)
  * plain Alphabet code tables       (Alphabet.hpp:51-69, 194-205)
Nucleotide (Sequence_RunBlock) indexes only; the protein one-tree layout is
not emitted yet.  The files equal the reference-built
tests/fixtures/{tiny,small,tiny_single}/refidx.1.cfr byte for byte,
the `_space` accounting fields and the rank9 directories included.
"""

import struct
import time

import numpy as np

# Object sizes of the reference's x86-64 build, which its `_space` fields
# count (the compactds idiom `_space += m.GetSpace() - sizeof(m)`, where a
# structure's GetSpace() adds sizeof(*this) to its own `_space`).  Solved
# from tiny's refidx.1.cfr and held by the five other `_space` values of the
# three reference-built fixtures (tests/test_torch_cfr_write.py).
_SIZEOF_BITVECTOR_PLAIN = 592
_SIZEOF_WAVELET_TREE = 1640
_U64 = (1 << 64) - 1


class _W:
    def __init__(self):
        self.parts = []

    def u64(self, v):
        self.parts.append(struct.pack("<Q", int(v)))

    def i32(self, v):
        self.parts.append(struct.pack("<i", int(v)))

    def u8(self, v):
        self.parts.append(struct.pack("<B", int(v)))

    def raw(self, b):
        self.parts.append(bytes(b))

    def arr(self, a, dtype):
        self.parts.append(np.ascontiguousarray(a, dtype=dtype).tobytes())

    def data(self):
        return b"".join(self.parts)


def _ref_log2ceil(x):
    """Utils::Log2Ceil (reference compactds/Utils.hpp:154-163): position of
    the highest set bit of (x-1) plus 1; Log2Ceil(0)=Log2Ceil(1)=0."""
    x = int(x)
    if x <= 1:
        return 0
    return (x - 1).bit_length()


def _infer_l(vals):
    """FixedSizeElemArray::InitFromArray(l=0, ...) width inference: the max
    bit length over values, minimum 1 (FixedSizeElemArray.hpp:52-65)."""
    vals = np.asarray(vals, dtype=np.uint64)
    if len(vals) == 0:
        return 1
    return max(1, int(vals.max()).bit_length())


def _bits_to_words(nbits):
    return (int(nbits) + 63) // 64


def _pack_bits(bits):
    """bool array -> little-endian uint64 word array (Utils::BitSet layout)."""
    nbits = len(bits)
    if nbits == 0:
        return np.zeros(0, dtype=np.uint64)
    by = np.packbits(np.asarray(bits, dtype=np.uint8), bitorder="little")
    words = np.zeros(_bits_to_words(nbits) * 8, dtype=np.uint8)
    words[:len(by)] = by
    return words.view(np.uint64)


def _rank9_dir(words, nbits):
    """DS_Rank9::Init (reference compactds/DS_Rank.hpp:205-248): 2 u64 per
    8-word block — cumulative ones before the block, and 9-bit-packed
    cumulative counts within the block."""
    word_cnt = _bits_to_words(nbits)
    block_cnt = (word_cnt + 7) // 8
    R = np.zeros(block_cnt * 2, dtype=np.uint64)
    if word_cnt == 0:
        return R, word_cnt
    w = np.zeros(block_cnt * 8, dtype=np.uint64)
    w[:word_cnt] = words[:word_cnt]
    pc = np.zeros(block_cnt * 8, dtype=np.uint64)
    v = w.copy()
    # vectorized popcount on uint64
    m1 = np.uint64(0x5555555555555555)
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    h = np.uint64(0x0101010101010101)
    v = v - ((v >> np.uint64(1)) & m1)
    v = (v & m2) + ((v >> np.uint64(2)) & m2)
    v = (v + (v >> np.uint64(4))) & m4
    pc = (v * h) >> np.uint64(56)
    # words past word_cnt contribute 0 ones, so the cumulative formula fills a
    # final block's fields past its last word with the block's total, as the
    # reference does when that block holds two or more words
    cum = np.concatenate([[0], np.cumsum(pc)])
    blocks = pc.reshape(block_cnt, 8)
    local = np.cumsum(blocks, axis=1)  # inclusive within block
    R[0::2] = cum[0:block_cnt * 8:8]
    sub = np.zeros(block_cnt, dtype=np.uint64)
    for j in range(1, 8):
        sub |= (local[:, j - 1].astype(np.uint64) << np.uint64((j - 1) * 9))
    if word_cnt % 8 == 1:
        # a final block of one word needs no sub-block count: the reference
        # leaves its word 0
        sub[-1] = 0
    R[1::2] = sub
    return R, word_cnt


def _bitvector_space(nbits):
    """Bitvector_Plain::_space: the bit words and the rank9 directory (two
    words for every 8-word block); a select of speed NO adds nothing."""
    words = _bits_to_words(nbits)
    return 8 * words + 16 * ((words + 7) // 8)


def _write_alphabet_plain(w, alphabet):
    """Alphabet::Save with PLAIN coding (Alphabet.hpp:51-69, 194-205)."""
    n = len(alphabet)
    w.u64(n)                       # _space = sizeof(ALPHABET) * n
    w.i32(1)                       # _method = ALPHABET_CODE_PLAIN (Alphabet.hpp:11)
    w.u64(n)
    if n == 0:
        return
    w.raw(alphabet.encode())
    code = np.zeros(256, dtype=np.int32)
    codelen = np.zeros(256, dtype=np.int16)
    cl = _ref_log2ceil(n)
    for i, ch in enumerate(alphabet):
        code[ord(ch)] = i
        codelen[ord(ch)] = cl
    w.arr(code, "<i4")
    w.arr(codelen, "<i2")


def _write_bitvector_plain(w, bits, select_speed=0, select_type=3):
    """Bitvector_Plain::Save (Bitvector_Plain.hpp:182-196) with
    DS_SELECT_SPEED_NO (the setting used on every BWT bitvector,
    Sequence_RunBlock.hpp:270,339,347)."""
    n = len(bits)
    words = _pack_bits(bits)
    R, word_cnt = _rank9_dir(words, n)
    w.u64(_bitvector_space(n))     # Bitvector::_space
    w.u64(n)
    w.i32(0)                       # _rb
    w.i32(0)                       # _sb
    w.i32(select_speed)
    w.i32(select_type)
    if n > 0:
        w.arr(words, "<u8")
        # DS_Rank9::Save
        w.u64(len(R) * 8)          # _space
        w.u64(word_cnt)
        w.arr(R, "<u8")
        # DS_Select::Save (speed NO -> header only)
        w.u64(0)                   # _space
        w.u64(n)                   # _n
        w.i32(select_speed)


def _write_wavelet(w, codes, alphabet):
    """Sequence_WaveletTree::Save for a PLAIN-coded alphabet: balanced tree
    built in preorder exactly like BuildTree (Sequence_WaveletTree.hpp:
    104-133); per node (prefix u64, prefixLen i32, children i32[2],
    Bitvector_Plain with select speed NO).  Returns the tree's _space."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    if n == 0:
        # stream never initialized in the reference (Sequence_RunBlock.hpp:
        # 338-350 guards on size > 0): default-constructed Save
        w.u64(0)                   # Sequence::_space
        w.u64(0)                   # _n
        w.u64(0)                   # empty Alphabet: _space
        w.i32(0)                   # _method
        w.u64(0)                   # _n
        w.i32(0)                   # _tNodeCnt
        w.i32(3)                   # _selectSpeed (default)
        return 0
    sigma = len(alphabet)
    code_len = _ref_log2ceil(sigma)
    cap = 1 << code_len

    nodes = []  # (prefix, prefix_len, children, bits)

    def build(sub, depth, prefix):
        ti = len(nodes)
        nodes.append(None)
        bits = ((sub >> (code_len - depth - 1)) & 1).astype(bool) \
            if len(sub) else np.zeros(0, bool)
        remaining = code_len - depth
        if remaining == 1 or len(sub) == 0:
            nodes[ti] = (prefix, depth, (-1, -1), bits)
            return ti
        left = build(sub[~bits], depth + 1, prefix << 1)
        right = build(sub[bits], depth + 1, (prefix << 1) | 1)
        nodes[ti] = (prefix, depth, (left, right), bits)
        return ti

    build(codes, 0, 0)

    # Sequence::Save; _space sums each node's Bitvector_Plain::GetSpace()
    space = sum(_bitvector_space(len(bits)) + _SIZEOF_BITVECTOR_PLAIN
                for _, _, _, bits in nodes)
    w.u64(space)                   # Sequence::_space
    w.u64(n)
    _write_alphabet_plain(w, alphabet)
    w.i32(len(nodes))              # _tNodeCnt
    w.i32(0)                       # _selectSpeed = NO
    for prefix, plen, children, bits in nodes:
        w.u64(prefix)
        w.i32(plen)
        w.i32(children[0])
        w.i32(children[1])
        _write_bitvector_plain(w, bits, select_speed=0)
    return space


def _write_fixed_array(w, vals, l):
    """FixedSizeElemArray::Save (FixedSizeElemArray.hpp:388-394)."""
    vals = np.asarray(vals, dtype=np.uint64)
    n = len(vals)
    nbits = n * l
    bits = np.zeros(nbits, dtype=np.uint8)
    if n and l:
        shifts = np.arange(l, dtype=np.uint64)
        bits = ((vals[:, None] >> shifts[None, :]) & np.uint64(1)) \
            .astype(np.uint8).reshape(-1)
    words = _pack_bits(bits.astype(bool))
    w.u64(len(words))              # _size (capacity in words)
    w.i32(l)
    w.u64(n)
    w.arr(words, "<u8")


def _runblock_split(rb):
    """Sequence_RunBlock::Init split (Sequence_RunBlock.hpp:249-358) as the
    RunBlockSeq holds it: (indicator bits, literal stream, run stream)."""
    words = np.ascontiguousarray(rb.indicator.words).view(np.uint8)
    is_run = np.unpackbits(words, bitorder="little")[:rb.block_cnt].astype(bool)
    return is_run, rb.lit.decode_all(), rb.run.decode_all()


def save_cfr_fm(fm, path):
    """Write prefix.1.cfr from an FMIndexData (nucleotide run-block layout)."""
    w = _W()
    alphabet = fm.alphabet
    sigma = fm.sigma
    w.u64(fm.n)
    w.u64(fm.code_bits)
    w.u64(fm.first_isa)
    w.u8(ord(alphabet[fm.last_chr]))

    # Sequence_RunBlock::Save
    rb = fm.bwt
    b = int(rb.b)
    is_run, lit_stream, run_stream = _runblock_split(rb)
    trees = _W()
    # Sequence::_space: the indicator's bytes, and for each wavelet tree its
    # _space and its alphabet's bytes less the tree object (an empty tree,
    # never initialised, counts minus the object alone)
    space = _bitvector_space(len(is_run))
    for stream in (lit_stream, run_stream):
        space += _write_wavelet(trees, stream, alphabet) - _SIZEOF_WAVELET_TREE
        if len(stream):
            space += len(alphabet)
    w.u64(space & _U64)            # Sequence::_space (a size_t: wraps below 0)
    w.u64(fm.n)
    _write_alphabet_plain(w, alphabet)
    w.u64(b)                       # _b (b==1 sentinel already stored as n)
    w.u64(len(is_run))             # _blockCnt
    _write_bitvector_plain(w, is_run, select_speed=0)
    w.raw(trees.data())

    _write_alphabet_plain(w, alphabet)   # FMIndex::_alphabets
    _write_alphabet_plain(w, alphabet)   # _plainAlphabetCoder
    w.arr(np.asarray(fm.psum, dtype=np.uint64), "<u8")

    # _FMIndexAuxData::Save (FMIndex.hpp:100-134)
    w.u64(fm.n)
    w.i32(0)                       # sampleStrategy
    w.i32(fm.sample_rate)
    sample_size = (fm.n + fm.sample_rate - 1) // fm.sample_rate
    w.u64(sample_size)
    w.u64(fm.precompute_width)
    psize = 1 << (fm.code_bits * fm.precompute_width)
    w.u64(psize)
    w.u64(fm.adjusted_sa0)
    # sampledSA elem width: InitFromArray(0, ...) infers l = max bit length
    # over the (seqid) values, min 1 (FixedSizeElemArray.hpp:52-65)
    _write_fixed_array(w, fm.sampled_sa, _infer_l(fm.sampled_sa))
    pr = np.zeros((psize, 2), dtype=np.uint64)
    pr[:, 0] = np.asarray(fm.ftab_start, dtype=np.uint64)
    pr[:, 1] = np.asarray(fm.ftab_len, dtype=np.uint64)
    w.arr(pr.reshape(-1), "<u8")
    w.u64(0)                       # maxLcp
    if fm.selected_rows is not None and len(fm.selected_rows):
        w.u64(len(fm.selected_rows))
        w.i32(1024)                # selectedSAFilterSampleRate (ref default,
                                   # Load divides by it: FMIndex.hpp:165-175)
        sel = np.zeros((len(fm.selected_rows), 2), dtype=np.uint64)
        sel[:, 0] = np.asarray(fm.selected_rows, dtype=np.uint64)
        sel[:, 1] = np.asarray(fm.selected_vals, dtype=np.uint64)
        w.arr(sel.reshape(-1), "<u8")
    else:
        w.u64(0)
        w.i32(1024)
    w.u8(1 if fm.has_end_marker else 0)
    if fm.has_end_marker and fm.end_marker_sa is not None:
        _write_fixed_array(w, fm.end_marker_sa, _infer_l(fm.end_marker_sa))
    with open(path, "wb") as f:
        f.write(w.data())


def save_cfr_taxonomy(tax, path):
    """Write prefix.2.cfr (Taxonomy::Save, Taxonomy.hpp:1114-1133)."""
    w = _W()
    node_cnt = tax.node_cnt
    seq_cnt = tax.seq_cnt
    extra = getattr(tax, "extra_seq_cnt", len(tax.seq_names) - seq_cnt)
    w.u64(node_cnt)
    w.u64(seq_cnt)
    w.u64(extra)
    nodes = np.zeros(node_cnt, dtype="<u8,<u1,<u1,(6,)<u1")
    nodes["f0"] = np.asarray(tax.parent[:node_cnt], dtype=np.uint64)
    nodes["f1"] = np.asarray(tax.rank[:node_cnt], dtype=np.uint8)
    nodes["f2"] = np.asarray(tax.leaf[:node_cnt], dtype=np.uint8)
    w.raw(nodes.tobytes())
    w.u64(len(tax.orig_ids))
    w.arr(np.asarray(tax.orig_ids, dtype=np.uint64), "<u8")
    for i in range(node_cnt):
        s = tax.names[i].encode()
        w.u64(len(s))
        w.raw(s)
    w.arr(np.asarray(tax.seq_id_to_tax[:seq_cnt], dtype=np.uint64), "<u8")
    for i in range(seq_cnt + extra):
        s = tax.seq_names[i].encode()
        w.u64(len(s))
        w.raw(s)
    with open(path, "wb") as f:
        f.write(w.data())


def save_cfr_index(fm, tax, seq_length, prefix, protein=False,
                   version="centrifuger_tpu-v1.1.3-compat"):
    """Write the full prefix.{1,2,3,4}.cfr set loadable by the reference
    binary (Builder::Save, reference Builder.hpp:280-313)."""
    save_cfr_fm(fm, prefix + ".1.cfr")
    save_cfr_taxonomy(tax, prefix + ".2.cfr")
    items = sorted((int(k), int(v)) for k, v in seq_length.items())
    arr = np.asarray(items, dtype=np.uint64)
    with open(prefix + ".3.cfr", "wb") as f:
        f.write(arr.tobytes())
    with open(prefix + ".4.cfr", "w") as f:
        f.write("version\t%s\n" % version)
        f.write("SA_sample_rate\t%d\n" % fm.sample_rate)
        f.write("sequence_type\t%s\n" %
                ("amino_acid" if protein else "nucleotide"))
        f.write("build_date\t%s" % time.strftime("%c"))
