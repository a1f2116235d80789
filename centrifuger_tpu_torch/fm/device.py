"""Device-resident FM-index (PyTorch) and the K1/K2/K5 kernels' plain twins.

Port of centrifuger_tpu.fm.device (DeviceFM) for the int32 nucleotide case
with the plain serving layout.  `TorchFM` holds the index tables as buffers:

  rows        int32 [n // 1920 + 1, 128]  the 512-byte wide rank rows, an
              int32 view of uint32 words:
              [occ_A, occ_C, occ_G, occ_T, occ_hi, prev_word, w0..w119, pad2]
  ftab        int32 [2 * 4^pw]  flat interleaved (ftab_start, ftab_len)
  psum        int32 [5]         F-column partial sums
  sampled_sa  int32             row-sampled SA (sequence ids)
  sel_rows    int32             sorted genome-boundary rows, sel_vals beside
  rowmap      int32 [n]         optional precomputed LF-walk result per row

The kernels (kernels/csrc/*.cu) take these buffers as they are and read the
words as uint32.  The plain versions below are batched tensor code: CPU torch
has no popcount and its uint32 lacks shifts and comparisons, so they widen the
words to int64 and count bits with SWAR.  A wrapper runs the plain version
only for CPU tensors; a CUDA tensor always launches the kernel.
"""

import numpy as np
import torch
from torch import nn

from .. import kernels

WIDE_BLOCK = 1920   # symbols per wide row
WIDE_WORDS = 128
WIDE_DATA = 120
WIDE_OFF = 6        # first data word column
WIDE_PREV = 5       # previous row's last data word
WIDE_HI = 4         # packed occ bits 32..39 (int64 indexes only)

INT32_LIMIT = (1 << 31) - 8   # DeviceFM switches to int64 lanes at this n
_M32 = 0xFFFFFFFF


def resolve_device(device):
    """torch.device for an entry point; asking for CUDA without a card raises
    (the port never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions" % str(device))
    return device


def _popcount32(v):
    """Bit count of int64 tensors holding uint32 values (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def _popcount32_np(v):
    v = v.astype(np.uint64)
    v = v - ((v >> np.uint64(1)) & np.uint64(0x55555555))
    v = (v & np.uint64(0x33333333)) + ((v >> np.uint64(2)) & np.uint64(0x33333333))
    v = (v + (v >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
    return ((v * np.uint64(0x01010101)) & np.uint64(_M32)) >> np.uint64(24)


def build_wide_rows(bwt_codes):
    """uint8 BWT codes (0..3) -> uint32 [n // 1920 + 1, 128] wide rank rows,
    the layout of centrifuger_tpu.fm.device_fused.build_fused_stream_wide."""
    n = len(bwt_codes)
    nrows = n // WIDE_BLOCK + 1
    need = nrows * WIDE_DATA
    padded = np.zeros(need * 16, np.uint8)
    padded[:n] = bwt_codes
    slots = padded.reshape(need, 16)
    wpad = np.zeros(need, np.uint32)
    for i in range(16):
        wpad |= slots[:, i].astype(np.uint32) << np.uint32(2 * i)
    rows = np.zeros((nrows, WIDE_WORDS), np.uint32)
    w2 = wpad.reshape(nrows, WIDE_DATA)
    rows[:, WIDE_OFF:WIDE_OFF + WIDE_DATA] = w2
    rows[1:, WIDE_PREV] = w2[:-1, WIDE_DATA - 1]
    # occ at each row boundary: counts over words [0, r*120), which never
    # reach the zero padding for r <= n // 1920 (1920 is a multiple of 16)
    boundary = np.arange(nrows, dtype=np.int64) * WIDE_DATA
    hi = np.zeros(nrows, np.uint32)
    for c in range(4):
        x = ~(wpad ^ np.uint32(c * 0x55555555))
        m = x & (x >> np.uint32(1)) & np.uint32(0x55555555)
        cum = np.concatenate([np.zeros(1, np.uint64),
                              np.cumsum(_popcount32_np(m), dtype=np.uint64)])
        occ = cum[boundary]
        rows[:, c] = (occ & np.uint64(_M32)).astype(np.uint32)
        hi |= (occ >> np.uint64(32)).astype(np.uint32) << np.uint32(8 * c)
    rows[:, WIDE_HI] = hi
    return rows


def fm_arrays(fm):
    """The numpy fields TorchFM needs from an FMIndexData (either package's:
    the on-disk format is shared)."""
    return dict(
        n=fm.n, sigma=fm.sigma, code_bits=fm.code_bits,
        precompute_width=fm.precompute_width, first_isa=fm.first_isa,
        last_chr=fm.last_chr, sample_rate=fm.sample_rate,
        adjusted_sa0=fm.adjusted_sa0, has_end_marker=fm.has_end_marker,
        psum=fm.psum, ftab_start=fm.ftab_start, ftab_len=fm.ftab_len,
        sampled_sa=fm.sampled_sa, selected_rows=fm.selected_rows,
        selected_vals=fm.selected_vals, rowmap=getattr(fm, "rowmap", None),
        bwt=fm.bwt.decode())


class TorchFM(nn.Module):
    """Device mirror of FMIndexData (int32 nucleotide, plain wide rows)."""

    def __init__(self, fields, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        n = int(fields["n"])
        if int(fields["sigma"]) != 4 or fields["has_end_marker"]:
            raise NotImplementedError(
                "protein / end-marker indexes are not ported yet "
                "(ROADMAP queue 1 item 6: generic run-block rank K7, eager-ftab "
                "chain K6)")
        if n >= INT32_LIMIT:
            raise NotImplementedError(
                "indexes with n >= 2^31 - 8 need int64 lanes, not ported yet "
                "(ROADMAP queue 1 item 8, kernel K9)")
        self.n = n
        self.code_bits = int(fields["code_bits"])
        self.pw = int(fields["precompute_width"])
        if self.code_bits * self.pw + 9 > 31:
            raise NotImplementedError(
                "code_bits*pw + 9 > 31 needs the eager-ftab chain (K6), not "
                "ported yet")
        self.first_isa = int(fields["first_isa"])
        self.last_chr = int(fields["last_chr"])
        self.sample_rate = int(fields["sample_rate"])
        self.adjusted_sa0 = int(fields["adjusted_sa0"])
        self.ftab_size = len(fields["ftab_len"])

        def buf(name, arr):
            self.register_buffer(
                name, None if arr is None else
                torch.from_numpy(np.ascontiguousarray(arr)).to(device))

        buf("rows", build_wide_rows(fields["bwt"]).view(np.int32))
        buf("ftab", np.stack([fields["ftab_start"], fields["ftab_len"]],
                             axis=1).astype(np.int32).reshape(-1))
        buf("psum", np.asarray(fields["psum"]).astype(np.int32))
        buf("sampled_sa", np.asarray(fields["sampled_sa"]).astype(np.int32))
        sel = fields["selected_rows"]
        has_sel = sel is not None and len(sel) > 0
        buf("sel_rows", np.asarray(sel).astype(np.int32) if has_sel else None)
        buf("sel_vals", np.asarray(fields["selected_vals"]).astype(np.int32)
            if has_sel else None)
        rowmap = fields["rowmap"]
        buf("rowmap", None if rowmap is None else
            np.asarray(rowmap).astype(np.int32))
        # bytes of index tables the plain versions read, when set to an int:
        # the least traffic a kernel doing the same work must move
        self.traffic = None

    def account(self, nbytes):
        """Add nbytes (an int or a 0-d tensor) when accounting is on."""
        if self.traffic is not None:
            self.traffic += int(nbytes)

    def account_ranks(self, pos):
        """Count the table words ranks at `pos` read: the occ word and the
        data words up to pos within its wide row."""
        if self.traffic is not None and len(pos):
            upto = torch.remainder(pos + 1, WIDE_BLOCK)
            self.account((4 + 4 * torch.div(upto + 15, 16, rounding_mode="floor"))
                         .sum())

    @classmethod
    def from_index(cls, fm, device="cuda"):
        return cls(fm_arrays(fm), device)

    @property
    def device(self):
        return self.rows.device

    # ------------------------------------------------ wide-row primitives
    # Plain (batched tensor) versions of the __device__ functions in
    # kernels/csrc/fm_device.cuh; positions are int64 tensors.

    def _row_words(self, pos):
        """uint32 words (as int64) of the wide row holding pos's rank."""
        return self.rows[torch.div(pos + 1, WIDE_BLOCK,
                                   rounding_mode="floor")].long() & _M32

    @staticmethod
    def _prefix_count(row, c, pos1):
        """Count symbol c in the first pos1 % 1920 slots of each row."""
        w = row[:, WIDE_OFF:WIDE_OFF + WIDE_DATA]
        x = ~(w ^ (c * 0x55555555)[:, None]) & _M32
        m = x & (x >> 1) & 0x55555555
        upto = torch.remainder(pos1, WIDE_BLOCK)
        j = torch.arange(WIDE_DATA, device=row.device)
        nb = (upto[:, None] - 16 * j[None, :]).clamp(0, 16) * 2
        mask = (torch.ones_like(nb) << nb) - 1
        return _popcount32(m & mask).sum(dim=1)

    @staticmethod
    def _sym(row, pos):
        """Stored symbol at pos (the prev-word column covers
        pos1 % 1920 == 0, where pos lies in the previous row)."""
        in_row = pos - torch.div(pos + 1, WIDE_BLOCK,
                                 rounding_mode="floor") * WIDE_BLOCK
        widx = (in_row >> 4).clamp(min=0)
        w = torch.where(in_row < 0, row[:, WIDE_PREV],
                        row.gather(1, (WIDE_OFF + widx)[:, None])[:, 0])
        return (w >> ((pos & 15) * 2)) & 3

    def rank_sym(self, c, pos):
        """(BWT rank_inclusive(c, pos), stored symbol at pos); pos >= -1,
        pos = -1 gives rank 0 (DeviceFM._plain_rank_sym)."""
        row = self._row_words(pos)
        occ = row.gather(1, c[:, None])[:, 0]
        rank = torch.where(pos < 0, torch.zeros_like(pos),
                           occ + self._prefix_count(row, c, pos + 1))
        return rank, self._sym(row, pos)

    def backward_extend(self, c, sp, ep):
        """FMIndex::BackwardExtend (DeviceFM.backward_extend, plain branch)."""
        off = self.psum.long()[c]
        r_sp, _ = self.rank_sym(c, sp - 1)
        r_ep, sym_ep = self.rank_sym(c, ep)
        is_last = c == self.last_chr
        nsp = off + r_sp + (is_last & (sp <= self.first_isa)).long()
        nep_rank = off + r_ep + (is_last & (ep < self.first_isa)).long() - 1
        nep = torch.where(sp == ep, nsp - (sym_ep != c).long(), nep_rank)
        return nsp, nep

    def lf(self, p):
        """LF-mapping of rows p >= 0 from one wide row (DeviceFM._plain_lf)."""
        row = self._row_words(p)
        sym = self._sym(row, p)
        rank = row.gather(1, sym[:, None])[:, 0] + \
            self._prefix_count(row, sym, p + 1)
        corr = ((sym == self.last_chr) & (p < self.first_isa)).long()
        return self.psum.long()[sym] + rank + corr - 1

    def _sel_lookup(self, rows):
        """(row is a selected row, its position in sel_rows)."""
        if self.sel_rows is None:
            return torch.zeros_like(rows, dtype=torch.bool), rows
        sel = self.sel_rows.long()
        pos = torch.searchsorted(sel, rows).clamp(max=len(sel) - 1)
        return sel[pos] == rows, pos

    def stored_here(self, rows):
        """Rows whose SA value is stored (DeviceFM._sample_stored_here)."""
        return (rows == self.first_isa) | \
            (torch.remainder(rows, self.sample_rate) == 0) | \
            self._sel_lookup(rows)[0]

    def sampled_value(self, rows):
        """Stored value of stored rows (DeviceFM.get_sampled_sa), else 0."""
        first = rows == self.first_isa
        samp = ~first & (torch.remainder(rows, self.sample_rate) == 0)
        slot = torch.div(rows, self.sample_rate, rounding_mode="floor")
        val = torch.where(samp, self.sampled_sa.long()[
            slot.clamp(0, len(self.sampled_sa) - 1)], torch.zeros_like(rows))
        val = torch.where(first, torch.full_like(rows, self.adjusted_sa0), val)
        is_sel, pos = self._sel_lookup(rows)
        if self.sel_rows is not None:
            val = torch.where(~first & ~samp & is_sel,
                              self.sel_vals.long()[pos], val)
        return val

    def ftab_entry(self, kmer):
        """(ftab_start, ftab_len) of packed pw-mers."""
        return self.ftab.long()[2 * kmer], self.ftab.long()[2 * kmer + 1]


# ------------------------------------------------------------ read tables

def _read_tables(codes, pw, bits):
    """codes [B, L] int64 (255 invalid) -> (kmer [B, L+1], tailvalid
    [B, L+1]): index p is the prefix of length p, kmer = the pw-mer ending at
    p - 1 (0 for p < pw), tailvalid = the valid run ending at p - 1, capped
    at pw (DeviceFM._precompute_read_tables)."""
    B, L = codes.shape
    valid = codes != 255
    vpad = torch.cat([torch.zeros(B, pw, dtype=torch.bool,
                                  device=codes.device), valid], dim=1)
    tail = torch.zeros(B, L + 1, dtype=torch.long, device=codes.device)
    for j in range(1, pw + 1):
        vj = vpad[:, pw - j:pw - j + L + 1]
        tail = torch.where(vj & (tail == j - 1), torch.full_like(tail, j), tail)
    kmer = torch.zeros(B, L + 1, dtype=torch.long, device=codes.device)
    if L >= pw:
        cc = torch.where(valid, codes, torch.zeros_like(codes))
        core = torch.zeros(B, L - pw + 1, dtype=torch.long, device=codes.device)
        for j in range(pw):
            core += cc[:, j:L - pw + j + 1] << (bits * j)
        kmer[:, pw:] = core
    return kmer, tail


# ------------------------------------------------------ K1: chain search

def chain_search_lanes_plain(fm, codes, lengths, mhl, H):
    """Semi-maximal exact-match chains per strand lane: the START/EXTEND
    state machine of DeviceFM._chain_search_lazyftab_impl, in lockstep.

    codes [B, L] (255 invalid), lengths [B] -> (hits int32 [B, H, 4] of
    (sp, ep, l, off), nhits int32 [B])."""
    dev = codes.device
    codes = codes.long()
    B, L = codes.shape
    pw = fm.pw
    kmer, tail = _read_tables(codes, pw, fm.code_bits)
    prev_char = torch.cat([torch.full((B, 1), 255, dtype=torch.long,
                                      device=dev), codes], dim=1)
    lane = torch.arange(B, device=dev)
    lengths = lengths.long()
    rem = lengths.clone()
    l = torch.zeros(B, dtype=torch.long, device=dev)
    sp = torch.zeros_like(l)
    ep = torch.zeros_like(l)
    phase = torch.zeros_like(l)
    nh = torch.zeros_like(l)
    hits = torch.zeros(B, H, 4, dtype=torch.long, device=dev)
    while True:
        active = rem >= mhl
        if not bool(active.any()):
            break
        start = active & (phase == 0)
        extend = active & (phase == 1)
        idx = torch.where(phase == 0, rem, rem - l).clamp(0, L)
        km = kmer[lane, idx]
        tv = tail[lane, idx]
        c = prev_char[lane, idx]
        fsp, flen = fm.ftab_entry(torch.where(start, km, 0))
        ftab_ok = (tv >= pw) & (flen > 0) & (idx >= pw)
        fep = fsp + flen - 1
        start_done = ftab_ok & (rem <= pw)
        lfail = torch.where(idx < pw, 0, torch.where(tv < pw, tv, pw - 1))
        start_l = torch.where(ftab_ok, pw, lfail)

        c_invalid = c == 255
        fm.account(8 * (start & (tv >= pw)).sum())
        ext = extend & ~c_invalid
        fm.account_ranks(torch.cat([sp[ext] - 1, ep[ext]]))
        nsp, nep = fm.backward_extend(
            torch.where(extend & ~c_invalid, c, 0),
            torch.where(extend, sp, 0), torch.where(extend, ep, 0))
        ext_fail = extend & (c_invalid | (nsp > nep))
        ext_ok = extend & ~ext_fail
        new_l = l + 1
        ext_done = ext_ok & (new_l >= rem)

        fin_start = start & (~ftab_ok | start_done)
        fin = fin_start | ext_fail | ext_done
        fin_l = torch.where(fin_start, start_l, torch.where(ext_done, new_l, l))
        fin_sp = torch.where(fin_start, torch.where(start_done, fsp, 1), sp)
        fin_ep = torch.where(fin_start, torch.where(start_done, fep, 0), ep)
        fin_sp = torch.where(ext_done, nsp, fin_sp)
        fin_ep = torch.where(ext_done, nep, fin_ep)

        rec = fin & (fin_l >= mhl) & (fin_sp <= fin_ep) & (nh < H)
        ri = lane[rec]
        hits[ri, nh[rec]] = torch.stack(
            [fin_sp, fin_ep, fin_l, lengths - rem], dim=1)[rec]
        nh = nh + rec.long()

        go_extend = start & ftab_ok & ~start_done
        sp = torch.where(go_extend, fsp, torch.where(ext_ok, nsp, sp))
        ep = torch.where(go_extend, fep, torch.where(ext_ok, nep, ep))
        l = torch.where(go_extend, pw, torch.where(ext_ok, new_l, l))
        phase = torch.where(fin, 0, torch.where(go_extend, 1, phase))
        rem = torch.where(fin, rem - (fin_l + 1), rem)
        l = torch.where(fin, 0, l)
    return hits.int(), nh.int()


# ------------------------------------------------------------ K2: resolve

def resolve_rows_plain(fm, rows, valid):
    """SA row -> stored value (DeviceFM._resolve_rows_impl): one rowmap
    gather, or the LF walk to a stored row.  rows [M], valid [M] bool ->
    int32 [M] (0 on invalid lanes)."""
    rows = rows.long()
    if fm.rowmap is not None:
        fm.account(4 * valid.sum())
        val = fm.rowmap.long()[rows.clamp(0, fm.n - 1)]
    else:
        cur = torch.where(valid, rows, torch.zeros_like(rows))
        pend = valid.clone()
        while True:
            pend &= ~fm.stored_here(cur)
            if not bool(pend.any()):
                break
            idx = pend.nonzero()[:, 0]
            fm.account_ranks(cur[idx])
            cur[idx] = fm.lf(cur[idx])
        fm.account(4 * valid.sum())
        val = fm.sampled_value(cur)
    return torch.where(valid, val, torch.zeros_like(val)).int()


def resolve_rows(fm, rows, valid):
    """K2 wrapper: rows int32 [M], valid bool [M] -> int32 [M]."""
    _check(fm, "resolve_rows", rows=(rows, torch.int32), valid=(valid, torch.bool))
    if rows.shape != valid.shape or rows.dim() != 1:
        raise ValueError("rows and valid must be 1-D of one length")
    if rows.device.type == "cpu":
        return resolve_rows_plain(fm, rows, valid)
    out = torch.empty_like(rows)
    if len(rows):
        kernels.launch("resolve_rows", fm, rows, valid, len(rows), out)
    return out


# ------------------------------------------------------- K5: prefix search

def prefix_search_plain(fm, codes, ms):
    """Longest-suffix backward search of codes[:, :ms] per lane
    (DeviceFM._prefix_search_impl).  codes [B, L] (255 invalid), ms [B] ->
    int32 (l, sp, ep) [B] each."""
    dev = codes.device
    codes = codes.long()
    B, L = codes.shape
    pw = fm.pw
    kmer, tail = _read_tables(codes, pw, fm.code_bits)
    lane = torch.arange(B, device=dev)
    ms = ms.long()
    msc = ms.clamp(0, L)
    too_short = ms < pw
    tv = tail[lane, msc]
    short_tail = ~too_short & (tv < pw)
    fsp, fl = fm.ftab_entry(kmer[lane, msc])
    ftab_empty = ~too_short & ~short_tail & (fl == 0)
    fm.account(8 * (~too_short & ~short_tail).sum())
    l = torch.where(too_short, 0, torch.where(
        short_tail, tv, torch.where(ftab_empty, pw - 1, pw)))
    running = ~too_short & ~short_tail & ~ftab_empty
    sp = torch.where(running, fsp, 1)
    ep = torch.where(running, fsp + fl - 1, 0)
    while True:
        act = running & (l < ms)
        if not bool(act.any()):
            break
        c = codes[lane, (ms - 1 - l).clamp(0, L - 1)]
        c_invalid = c == 255
        ext = act & ~c_invalid
        fm.account_ranks(torch.cat([sp[ext] - 1, ep[ext]]))
        nsp, nep = fm.backward_extend(torch.where(act & ~c_invalid, c, 0),
                                      torch.where(act, sp, 0),
                                      torch.where(act, ep, 0))
        ok = act & ~c_invalid & (nsp <= nep)
        sp = torch.where(ok, nsp, sp)
        ep = torch.where(ok, nep, ep)
        l = torch.where(ok, l + 1, l)
        running = running & ok
    return l.int(), sp.int(), ep.int()


def prefix_search(fm, codes, ms):
    """K5 wrapper: codes uint8 [B, L] (255 invalid), ms int32 [B] ->
    int32 (l, sp, ep) [B] each."""
    _check(fm, "prefix_search", codes=(codes, torch.uint8), ms=(ms, torch.int32))
    if codes.dim() != 2 or ms.shape != (codes.shape[0],):
        raise ValueError("codes must be [B, L] and ms [B]")
    if codes.device.type == "cpu":
        return prefix_search_plain(fm, codes, ms)
    B, L = codes.shape
    out = torch.empty(3, B, dtype=torch.int32, device=codes.device)
    if B:
        kernels.launch("prefix_search", fm, codes, ms, B, L, out)
    return out[0], out[1], out[2]


def _check(fm, name, **tensors):
    """Wrapper argument checks: dtype, contiguity, and one device shared with
    the index buffers."""
    for arg, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError("%s: %s must be %s, got %s" % (name, arg, dtype, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (name, arg))
        if t.device != fm.device:
            raise ValueError("%s: %s is on %s but the index is on %s"
                             % (name, arg, t.device, fm.device))
