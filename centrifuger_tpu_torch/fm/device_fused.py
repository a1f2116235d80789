"""Fused-row tables of the run-block serving layout (built on the host, numpy).

Port of build_fused_stream, build_fused_indicator and build_mega_table of
centrifuger_tpu.fm.device_fused.  Each
256-symbol block of a 2-bit packed stream is one uint32 row

    [occ_A, occ_C, occ_G, occ_T, prev_last_word, w0..w15]   (21 words, 84 B)

so rank(c, pos) and the symbol at pos come from one row; `prev_last_word`
serves the symbol at the pos % 256 == 255 edge, where the rank row is the next
block's.  The indicator bitvector's rows are  [cum, prev_last_word, w0..w7]
(10 words, zero-padded to 21).  build_mega_table stacks indicator, literal and
run rows into one [R, 21] table: a run-block rank is the indicator row, then
the literal row and the run row.

The functions take plain arrays (words, checkpoints, length), so they serve an
FMIndexData of either package.
"""

import numpy as np

OCC_BLOCK = 256   # symbols per stream row
IND_BLOCK = 256   # bits per indicator row
MEGA_WORDS = 21
STREAM_PREV = 4   # prev_last_word column of a stream row
STREAM_OFF = 5    # first data word column of a stream row
IND_PREV = 1
IND_OFF = 2


def build_fused_stream(words, occ, n, sigma):
    """2-bit packed stream (uint32 words, occ [nblk, sigma] counts before each
    256-symbol block, n symbols) -> uint32 [n // 256 + 1, 21] rows."""
    if sigma > 4:
        raise ValueError("fused stream rows hold 2-bit symbols (sigma <= 4)")
    nrows = max(n // OCC_BLOCK + 1, 1)
    rows = np.zeros((nrows, MEGA_WORDS), dtype=np.uint32)
    rows[:, :sigma] = np.asarray(occ)[:nrows, :sigma].astype(np.uint32)
    wpad = np.zeros(nrows * 16, dtype=np.uint32)
    wpad[:min(len(words), nrows * 16)] = words[:nrows * 16]
    w2 = wpad.reshape(nrows, 16)
    rows[:, STREAM_OFF:STREAM_OFF + 16] = w2
    rows[1:, STREAM_PREV] = w2[:-1, 15]
    return rows


def build_fused_indicator(words, cum, n):
    """Bitvector (uint32 words, cum = ones before each 8-word group, n bits)
    -> uint32 [n // 256 + 1, 10] rows."""
    nrows = max(n // IND_BLOCK + 1, 1)
    rows = np.zeros((nrows, 10), dtype=np.uint32)
    cum = np.asarray(cum)
    rows[:, 0] = cum[np.minimum(np.arange(nrows), len(cum) - 1)].astype(np.uint32)
    wpad = np.zeros(nrows * 8, dtype=np.uint32)
    wpad[:min(len(words), nrows * 8)] = words[:nrows * 8]
    w2 = wpad.reshape(nrows, 8)
    rows[:, IND_OFF:IND_OFF + 8] = w2
    rows[1:, IND_PREV] = w2[:-1, 7]
    return rows


def build_mega_table(fields):
    """The run-block parts of fm_arrays(fm) -> (uint32 [R, 21] table, ind_off,
    lit_off, run_off): indicator rows, then literal rows, then run rows."""
    ind = build_fused_indicator(fields["ind_words"], fields["ind_cum"], fields["ind_n"])
    sigma = int(fields["sigma"])
    lit = build_fused_stream(fields["lit_words"], fields["lit_occ"], fields["lit_n"], sigma)
    run = build_fused_stream(fields["run_words"], fields["run_occ"], fields["run_n"], sigma)
    ind_p = np.zeros((ind.shape[0], MEGA_WORDS), dtype=np.uint32)
    ind_p[:, :10] = ind
    table = np.concatenate([ind_p, lit, run], axis=0)
    return table, 0, ind.shape[0], ind.shape[0] + lit.shape[0]
