# Port copy of centrifuger_tpu.succinct.codes (host code, no accelerator).
"""Prefix codes: canonical Huffman and Elias gamma/delta.

Library counterparts of the reference's HuffmanCode.hpp and EliasCode.hpp
(compactds/HuffmanCode.hpp:1-240, compactds/EliasCode.hpp:1-74).  Encoding
produces bit-packed uint64 word streams; decoding is table-driven and
vectorized where the code structure allows (canonical Huffman decodes by
length-bucket binary search, not per-bit tree walks).
"""

import heapq

import numpy as np


class HuffmanCode:
    """Canonical Huffman code over symbols 0..sigma-1 with given frequencies."""

    def __init__(self, freqs):
        freqs = np.asarray(freqs, dtype=np.int64)
        self.sigma = len(freqs)
        present = np.flatnonzero(freqs > 0)
        if len(present) == 0:
            raise ValueError("empty distribution")
        if len(present) == 1:
            lengths = np.zeros(self.sigma, np.int64)
            lengths[present[0]] = 1
        else:
            # standard two-queue Huffman on (freq, tiebreak, node)
            heap = [(int(freqs[s]), int(s), ("leaf", int(s))) for s in present]
            heapq.heapify(heap)
            cnt = self.sigma
            while len(heap) > 1:
                fa, _, a = heapq.heappop(heap)
                fb, _, b = heapq.heappop(heap)
                heapq.heappush(heap, (fa + fb, cnt, ("node", a, b)))
                cnt += 1
            lengths = np.zeros(self.sigma, np.int64)

            def walk(node, depth):
                if node[0] == "leaf":
                    lengths[node[1]] = max(depth, 1)
                else:
                    walk(node[1], depth + 1)
                    walk(node[2], depth + 1)
            walk(heap[0][2], 0)
        self.lengths = lengths
        # canonical code assignment: sort by (length, symbol)
        order = np.lexsort((np.arange(self.sigma), lengths))
        order = order[lengths[order] > 0]
        codes = np.zeros(self.sigma, np.int64)
        code = 0
        prev_len = 0
        for s in order:
            code <<= int(lengths[s] - prev_len)
            codes[s] = code
            code += 1
            prev_len = int(lengths[s])
        self.codes = codes
        self.max_len = int(lengths.max())
        # decode tables per length: first code value and first symbol index
        self._dec_order = order
        self._dec_first = {}
        pos = 0
        for L in range(1, self.max_len + 1):
            syms = order[lengths[order] == L]
            if len(syms):
                self._dec_first[L] = (int(codes[syms[0]]), pos)
            pos += len(syms)

    def encode(self, symbols):
        """-> (uint64 words, total_bits)."""
        symbols = np.asarray(symbols, dtype=np.int64)
        lens = self.lengths[symbols]
        starts = np.zeros(len(symbols) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        # store MSB-first codes bit-reversed so a sequential LSB-first read
        # sees the code in natural (MSB-first) order
        c = self.codes[symbols].astype(np.uint64)
        out = np.zeros(len(symbols), dtype=np.uint64)
        for b in range(self.max_len):
            bit = (c >> np.uint64(b)) & np.uint64(1)
            sh = (lens - 1 - b)
            valid = sh >= 0
            out |= np.where(valid, bit << np.where(valid, sh, 0).astype(np.uint64),
                            np.uint64(0))
        from .bits import _pack_at
        words = _pack_at(out, starts[:-1], lens)
        return words, int(starts[-1])

    def decode(self, words, total_bits, count):
        """Sequential decode of `count` symbols (host-side; per-symbol loop over
        length buckets, bounded by max code length)."""
        out = np.zeros(count, dtype=np.int64)
        pos = 0
        from .bits import read_bits
        for i in range(count):
            # read max_len bits, find the shortest matching length bucket
            chunk = int(read_bits(words, np.array([pos], np.uint64), min(64, self.max_len))[0])
            for L in range(1, self.max_len + 1):
                if L not in self._dec_first:
                    continue
                # bits arrive LSB-first in natural order; code is the first L
                # bits re-reversed to MSB-first
                v = 0
                for b in range(L):
                    v = (v << 1) | ((chunk >> b) & 1)
                first_code, first_pos = self._dec_first[L]
                lens = self.lengths[self._dec_order]
                nL = int((lens == L).sum())
                if first_code <= v < first_code + nL:
                    out[i] = self._dec_order[first_pos + (v - first_code)]
                    pos += L
                    break
            else:
                raise ValueError("bad code at bit %d" % pos)
        return out

    def space_bits(self, freqs):
        """Total encoded size of a stream with these symbol frequencies."""
        return int((self.lengths * np.asarray(freqs, dtype=np.int64)).sum())


def elias_gamma_encode(values):
    """Elias gamma for values in [1, 2^32) -> (uint64 words, total_bits, starts).
    Unary length prefix then binary body (reference compactds/EliasCode.hpp).
    Bound: enc << (nbits-1) must fit one uint64 word and the decoder's unary
    scan caps at 33 leading bits, so values must stay below 2^32."""
    values = np.asarray(values, dtype=np.uint64)
    assert (values >= 1).all()
    assert (values < (1 << 32)).all(), "elias gamma supports values < 2^32"
    nbits = np.array([int(v).bit_length() for v in values], dtype=np.int64)
    lens = 2 * nbits - 1
    starts = np.zeros(len(values) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    # layout per value: (nbits-1) zeros, then the nbits of v LSB-packed in
    # MSB-first order starting with the leading 1
    # store as: zeros, then reversed-bits of v
    enc = np.zeros(len(values), dtype=np.uint64)
    for b in range(64):
        bit = (values >> np.uint64(b)) & np.uint64(1)
        sh = nbits - 1 - b
        valid = sh >= 0
        enc |= np.where(valid, bit << np.where(valid, sh, 0).astype(np.uint64),
                        np.uint64(0))
    from .bits import _pack_at
    words = _pack_at(enc << (nbits - 1).astype(np.uint64), starts[:-1], lens)
    return words, int(starts[-1]), starts


def elias_gamma_decode(words, starts):
    """Decode with known element bit offsets (vectorized)."""
    from .bits import read_bits
    starts = np.asarray(starts[:-1], dtype=np.uint64)
    chunks = read_bits(words, starts, 64)
    # count leading zeros (unary part)
    nz = np.zeros(len(starts), dtype=np.int64)
    found = np.zeros(len(starts), dtype=bool)
    for b in range(33):
        bit = (chunks >> np.uint64(b)) & np.uint64(1)
        hit = (~found) & (bit == 1)
        nz = np.where(hit, b, nz)
        found |= hit
    nbits = nz + 1
    out = np.zeros(len(starts), dtype=np.uint64)
    for b in range(64):  # unary prefix + body can span up to 2*32-1 bits
        sel = (chunks >> np.uint64(b)) & np.uint64(1)
        pos_in = b - nz  # bit index from MSB side: first is the leading 1
        valid = (pos_in >= 0) & (b < nz + nbits)
        sh = np.where(valid, nbits - 1 - pos_in, 0)
        out |= np.where(valid & (sh >= 0), sel << sh.astype(np.uint64), np.uint64(0))
    return out


def elias_delta_encode(values):
    """Elias delta: gamma-coded bit length then body bits."""
    values = np.asarray(values, dtype=np.uint64)
    assert (values >= 1).all()
    nbits = np.array([int(v).bit_length() for v in values], dtype=np.int64)
    lb = np.array([int(n).bit_length() for n in nbits], dtype=np.int64)
    lens = (2 * lb - 1) + (nbits - 1)
    starts = np.zeros(len(values) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    words_list = np.zeros(int(starts[-1]) // 64 + 2, dtype=np.uint64)
    # host loop encode (library breadth; not on any hot path)
    for i, v in enumerate(values):
        pos = int(starts[i])
        n = int(nbits[i])
        l = int(lb[i])
        # gamma(n): l-1 zeros then n's bits MSB-first
        pos += l - 1
        for b in range(l - 1, -1, -1):
            if (n >> b) & 1:
                words_list[pos >> 6] |= np.uint64(1) << np.uint64(pos & 63)
            pos += 1
        for b in range(n - 2, -1, -1):
            if (int(v) >> b) & 1:
                words_list[pos >> 6] |= np.uint64(1) << np.uint64(pos & 63)
            pos += 1
    return words_list, int(starts[-1]), starts


def elias_delta_decode(words, starts):
    out = []
    for i in range(len(starts) - 1):
        pos = int(starts[i])
        z = 0
        while not (int(words[pos >> 6]) >> (pos & 63)) & 1:
            z += 1
            pos += 1
        n = 0
        for _ in range(z + 1):
            n = (n << 1) | ((int(words[pos >> 6]) >> (pos & 63)) & 1)
            pos += 1
        v = 1
        for _ in range(n - 1):
            v = (v << 1) | ((int(words[pos >> 6]) >> (pos & 63)) & 1)
            pos += 1
        out.append(v)
    return np.array(out, dtype=np.uint64)
