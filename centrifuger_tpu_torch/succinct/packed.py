# Port copy of centrifuger_tpu.succinct.packed (host code, no accelerator);
# its builders run in pieces of PIECE symbols.
"""Bit-packed symbol sequences with occurrence checkpoints — the TPU-native
replacement for the reference's wavelet trees.

The reference answers rank(c, i) by walking a binary wavelet tree with one
bitvector-rank per level (compactds/Sequence_WaveletTree.hpp:235-264, each level
backed by a Rank9 directory, compactds/DS_Rank.hpp:255-273).  On TPU, dependent
gathers are the enemy: we instead store the symbols bit-packed in uint32 words
plus a flat occurrence-count checkpoint every OCC_BLOCK symbols, so a batched
rank is one checkpoint gather + word gathers + vectorized popcount (SWAR).
Rank values are identical to the reference's (count of c in seq[0..i] inclusive).
"""

import numpy as np

from ..utils import div_ceil

OCC_BLOCK = 256  # symbols per occurrence checkpoint
PIECE = 1 << 20  # symbols a step of the builders below (their temporaries
                 # stay a few MB whatever the sequence's length)


def width_for_sigma(sigma):
    """Smallest bit width dividing 32 that can hold codes 0..sigma-1."""
    width = 1
    while (1 << width) < sigma or 32 % width != 0:
        width += 1
    return width


def pack_codes(codes, width):
    """Pack uint8 codes little-endian into uint32 words (symbol i at bits (i*width)%32
    of word (i*width)//32). Same element-order convention as FixedSizeElemArray
    (reference compactds/Utils.hpp:197-242 BitsRead/BitsWrite)."""
    per_word = 32 // width
    n = len(codes)
    words = np.zeros(div_ceil(max(n, 1), per_word), dtype=np.uint32)
    shifts = np.arange(per_word, dtype=np.uint32) * np.uint32(width)
    step = PIECE // per_word * per_word
    for s in range(0, n, step):
        piece = codes[s:s + step]
        m = div_ceil(len(piece), per_word)
        padded = np.zeros(m * per_word, dtype=np.uint32)
        padded[:len(piece)] = piece
        words[s // per_word:s // per_word + m] = np.bitwise_or.reduce(
            padded.reshape(m, per_word) << shifts[None, :], axis=1)
    return words


def _match_mask(words, c, width):
    """Per packed word, a uint32 with the LOW bit of every symbol slot that equals c."""
    w = words.astype(np.uint32)
    c = c.astype(np.uint32) if isinstance(c, np.ndarray) else np.uint32(c)
    if width == 2:
        pattern = c * np.uint32(0x55555555)
        x = ~(w ^ pattern)
        return x & (x >> np.uint32(1)) & np.uint32(0x55555555)
    if width == 4:
        pattern = c * np.uint32(0x11111111)
        x = ~(w ^ pattern)
        x = x & (x >> np.uint32(1))
        x = x & (x >> np.uint32(2))
        return x & np.uint32(0x11111111)
    if width == 8:
        pattern = c * np.uint32(0x01010101)
        x = w ^ pattern
        # exact per-byte zero detect: OR-fold each byte's bits into its bit 0
        z = x | (x >> np.uint32(4))
        z = z | (z >> np.uint32(2))
        z = z | (z >> np.uint32(1))
        return ~z & np.uint32(0x01010101)
    raise ValueError("unsupported width %d" % width)


def _slot_mask(width, take):
    """uint32 mask of the low-bit positions of the first `take` symbol slots."""
    low = {2: 0x55555555, 4: 0x11111111, 8: 0x01010101}[width]
    take = np.asarray(take, dtype=np.uint32)
    nbits = take * np.uint32(width)
    full = nbits >= 32
    m = (np.uint32(1) << nbits) - np.uint32(1)
    m = np.where(full, np.uint32(0xFFFFFFFF), m)
    return m & np.uint32(low)


class PackedSeq:
    """A length-n sequence over a small alphabet with O(1) batched rank."""

    __slots__ = ("n", "sigma", "width", "words", "occ", "per_word")

    def __init__(self, n, sigma, width, words, occ):
        self.n = int(n)
        self.sigma = int(sigma)
        self.width = int(width)
        self.words = words
        self.occ = occ
        self.per_word = 32 // self.width

    @classmethod
    def from_codes(cls, codes, sigma):
        codes = np.asarray(codes, dtype=np.uint8)
        n = len(codes)
        width = width_for_sigma(sigma)
        words = pack_codes(codes, width)
        nblk = div_ceil(max(n, 1), OCC_BLOCK) + 1
        occ = np.zeros((nblk, sigma), dtype=np.int64)
        step = PIECE // OCC_BLOCK * OCC_BLOCK
        for s in range(0, n, step):      # per-block counts, then their prefix sums
            piece = codes[s:s + step]
            nb = div_ceil(len(piece), OCC_BLOCK)
            cp = np.full(nb * OCC_BLOCK, 255, np.uint8)
            cp[:len(piece)] = piece
            cp = cp.reshape(nb, OCC_BLOCK)
            b0 = 1 + s // OCC_BLOCK
            for c in range(sigma):
                occ[b0:b0 + nb, c] = (cp == c).sum(axis=1, dtype=np.int64)
        np.cumsum(occ[1:], axis=0, out=occ[1:])
        return cls(n, sigma, width, words, occ)

    def access(self, idx):
        """codes at positions idx (any int array or scalar)."""
        idx = np.asarray(idx, dtype=np.int64)
        w = self.words[idx // self.per_word]
        sh = ((idx % self.per_word) * self.width).astype(np.uint32)
        return ((w >> sh) & np.uint32((1 << self.width) - 1)).astype(np.uint8)

    def decode_all(self):
        """All n codes, via broadcast word unpack (no per-position gather —
        ~10x faster than access(arange(n)) for whole-stream decodes)."""
        shifts = (np.arange(self.per_word, dtype=np.uint32) * self.width)
        mask = np.uint32((1 << self.width) - 1)
        out = np.empty(len(self.words) * self.per_word, np.uint8)
        step = PIECE // self.per_word
        for w in range(0, len(self.words), step):
            words = self.words[w:w + step]
            out[w * self.per_word:(w + len(words)) * self.per_word] = \
                ((words[:, None] >> shifts[None, :]) & mask).reshape(-1)
        return out[:self.n]

    def rank_inclusive(self, c, idx):
        """count of code c in seq[0..idx] inclusive, vectorized over idx (and c)."""
        scalar = np.ndim(idx) == 0
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
        c = np.broadcast_to(np.asarray(c, dtype=np.uint32), idx.shape)
        pos1 = idx + 1                      # count over [0, pos1)
        blk = pos1 // OCC_BLOCK
        base = self.occ[blk, c.astype(np.int64)]
        rem = pos1 - blk * OCC_BLOCK        # symbols to count past the checkpoint
        wstart = blk * (OCC_BLOCK // self.per_word)
        cnt = np.zeros(idx.shape, dtype=np.int64)
        nw = OCC_BLOCK // self.per_word
        wlimit = len(self.words) - 1
        for k in range(nw):
            take = np.clip(rem - k * self.per_word, 0, self.per_word)
            if not (take > 0).any():
                break
            w = self.words[np.minimum(wstart + k, wlimit)]
            m = _match_mask(w, c, self.width) & _slot_mask(self.width, take)
            cnt += np.bitwise_count(m).astype(np.int64)
        out = base + cnt
        return out[0] if scalar else out

    def decode(self):
        """Full decode to a uint8 code array (for tests)."""
        return self.access(np.arange(self.n))

    def nbytes(self):
        return self.words.nbytes + self.occ.nbytes
