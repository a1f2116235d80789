"""Device-resident FM-index (PyTorch) and the plain twins of the FM kernels.

Port of centrifuger_tpu.fm.device (DeviceFM).  `TorchFM` holds the index
tables as buffers and ranks through one of three layouts, chosen at load time
the way DeviceFM.__init__ does (results never depend on the choice):

  plain     sigma 4.  rows int32 [n // 1920 + 1, 128]: the 512-byte wide rank
            rows, an int32 view of uint32 words
            [occ_A, occ_C, occ_G, occ_T, occ_hi, prev_word, w0..w119, pad2]
  runblock  sigma 4.  mega int32 [R, 21]: indicator rows, then literal rows,
            then run rows of the run-block BWT (fm/device_fused.py); a rank is
            the indicator row, then one literal and one run row
  generic   any sigma (protein).  The run-block BWT as it is stored: the
            indicator bitvector (TorchBitvector) and the literal and run
            streams (TorchPacked, 2, 4 or 8 bits a symbol)

and beside them, for every layout,

  ftab        idtype [2 * 2^(code_bits * pw)]  flat interleaved (start, len)
  psum        idtype [sigma + 1]  F-column partial sums
  sampled_sa  idtype            row-sampled SA (sequence ids)
  sel_rows    idtype            sorted genome-boundary rows, sel_vals beside
  end_marker_sa idtype          sequence ids of the end-marker rows (protein)
  rowmap      int32 [n]         optional precomputed LF-walk result per row

The index type `idtype` (kernel K9) is int32 below n = 2^31 - 8 and int64
from there on, or what `force_idtype` asks for; every position, rank and
count table, the stream occ and the bitvector cum take it, and so do the
positions the wrappers take and return.  The wide rows stay uint32: an int64
index reads its 40-bit occ as the lo word plus the row's WIDE_HI byte.  With
int64 a run-block serving layout ranks through the generic layout (the
mega-table's row math is 32-bit), and a rowmap is refused from n = 2^31.

The kernels (kernels/csrc/*.cu) take these buffers as they are and read the
words as uint32.  The plain versions below are batched tensor code: CPU torch
has no popcount and its uint32 lacks shifts and comparisons, so they widen the
words to int64 and count bits with SWAR.  A wrapper runs the plain version
only for CPU tensors; a CUDA tensor always launches the kernel.
"""

import contextlib
import copy
import hashlib
import os
import sys
import zipfile

import numpy as np
import torch
from torch import nn

from .. import kernels
from .device_fused import (build_mega_table, IND_OFF, IND_PREV, STREAM_OFF,
                           STREAM_PREV)

WIDE_BLOCK = 1920   # symbols per wide row
WIDE_WORDS = 128
WIDE_DATA = 120
WIDE_OFF = 6        # first data word column
WIDE_PREV = 5       # previous row's last data word
WIDE_HI = 4         # packed occ bits 32..39 (int64 indexes only)

OCC_BLOCK = 256     # symbols per occ checkpoint of a packed stream
RANK_WORDS = 8      # words per rank checkpoint of a bitvector
SERVE_LAYOUTS = ("plain", "runblock")      # the load-time choice (sigma 4)
LAYOUTS = SERVE_LAYOUTS + ("generic",)     # the rank layouts of the kernels

INT32_LIMIT = (1 << 31) - 8   # DeviceFM switches to int64 lanes at this n
IDTYPES = {"int32": torch.int32, "int64": torch.int64}
_M32 = 0xFFFFFFFF
_LOW = {2: 0x55555555, 4: 0x11111111, 8: 0x01010101}


def resolve_device(device):
    """torch.device for an entry point; asking for CUDA without a card raises
    (the port never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions" % str(device))
    return device


def index_dtype(n, force_idtype=None):
    """The index type of an index of n rows (DeviceFM.__init__'s switch):
    int32 below INT32_LIMIT, else int64; force_idtype "int32" / "int64"
    overrides it where the positions fit."""
    if force_idtype is None:
        return torch.int32 if n < INT32_LIMIT else torch.int64
    if force_idtype not in IDTYPES:
        raise ValueError("force_idtype must be one of %s" % (tuple(IDTYPES),))
    if force_idtype == "int32" and n >= INT32_LIMIT:
        raise ValueError("n = %d needs int64 positions" % n)
    return IDTYPES[force_idtype]


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


def _swar_match(w, c, width):
    """uint32 words (as int64) -> the low bit of every symbol slot equal to c."""
    if width == 2:
        x = ~(w ^ (c * 0x55555555)) & _M32
        return x & (x >> 1) & 0x55555555
    if width == 4:
        x = ~(w ^ (c * 0x11111111)) & _M32
        x = x & (x >> 1)
        x = x & (x >> 2)
        return x & 0x11111111
    if width == 8:
        x = w ^ (c * 0x01010101)
        z = x | (x >> 4)
        z = z | (z >> 2)
        z = z | (z >> 1)
        return ~z & 0x01010101
    raise ValueError("unsupported symbol width %d" % width)


def _low_bits(nbits):
    """int64 mask of the low nbits (0..32) bits."""
    return (torch.ones_like(nbits) << nbits) - 1


def _ceil_div(a, b):
    return torch.div(a + (b - 1), b, rounding_mode="floor")


def _buf(module, name, arr, device):
    module.register_buffer(
        name, None if arr is None else
        torch.from_numpy(np.ascontiguousarray(arr)).to(device))


def _no_account(nbytes):
    pass


def _on(mask, fn, *args):
    """fn(*args) on the lanes of mask, 0 elsewhere.  The other lanes read no
    table, so the traffic account holds only what a lane's own branch reads,
    as one thread of the kernels does."""
    out = torch.zeros_like(args[0])
    idx = mask.nonzero()[:, 0]
    if len(idx):
        out[idx] = fn(*(a[idx] for a in args))
    return out


class TorchPacked(nn.Module):
    """Device mirror of a PackedSeq (DevicePacked): words int32
    [nblk, 256 / per_word] (uint32 bits), occ [nblk, sigma] counts before
    each 256-symbol block, in the index type."""

    def __init__(self, words, occ, width, n, device, account=_no_account,
                 idtype=np.int32):
        super().__init__()
        self.n = int(n)
        self.width = int(width)
        self.per_word = 32 // self.width
        self.wpb = OCC_BLOCK // self.per_word
        nblk = occ.shape[0]
        padded = np.zeros(nblk * self.wpb, dtype=np.uint32)
        padded[:len(words)] = words
        _buf(self, "words", padded.reshape(nblk, self.wpb).view(np.int32), device)
        _buf(self, "occ", np.asarray(occ).astype(idtype), device)
        self.account = account

    def rank_inclusive(self, c, idx):
        """Count of c in [0..idx]; idx in range."""
        pos1 = idx + 1
        blk = torch.div(pos1, OCC_BLOCK, rounding_mode="floor")
        rem = pos1 - blk * OCC_BLOCK
        isz = self.occ.element_size()
        self.account(lambda: (isz + 4 * _ceil_div(rem, self.per_word)).sum())
        rows = self.words[blk].long() & _M32
        k = torch.arange(self.wpb, device=idx.device)[None, :]
        take = (rem[:, None] - k * self.per_word).clamp(0, self.per_word)
        m = _swar_match(rows, c[:, None], self.width) & \
            _low_bits(take * self.width) & _LOW[self.width]
        return self.occ[blk, c].long() + _popcount32(m).sum(dim=1)

    def access(self, idx):
        self.account(lambda: 4 * idx.numel())
        widx = torch.div(idx, self.per_word, rounding_mode="floor")
        w = self.words.reshape(-1)[widx].long() & _M32
        return (w >> (torch.remainder(idx, self.per_word) * self.width)) & \
            ((1 << self.width) - 1)


class TorchBitvector(nn.Module):
    """Device mirror of a Bitvector (DeviceBitvector): words int32 [ngrp, 8]
    with one zero group appended, cum the ones before each group in the index
    type."""

    def __init__(self, words, cum, n, device, account=_no_account, idtype=np.int32):
        super().__init__()
        self.n = int(n)
        nwords = len(words)
        # + 1 zero group: a rank at pos1 == n reads a whole group safely
        ngrp = (nwords + RANK_WORDS - 1) // RANK_WORDS + 1
        padded = np.zeros(ngrp * RANK_WORDS, dtype=np.uint32)
        padded[:nwords] = words
        _buf(self, "words", padded.reshape(ngrp, RANK_WORDS).view(np.int32), device)
        _buf(self, "cum", np.asarray(cum).astype(idtype), device)
        self.account = account

    def rank1_inclusive(self, idx):
        pos1 = idx + 1
        wi = pos1 >> 5
        grp = torch.div(wi, RANK_WORDS, rounding_mode="floor")
        isz = self.cum.element_size()
        self.account(lambda: (isz + 4 * _ceil_div(pos1 - grp * (32 * RANK_WORDS), 32)).sum())
        rows = self.words[grp].long() & _M32
        j = grp[:, None] * RANK_WORDS + torch.arange(RANK_WORDS, device=idx.device)[None, :]
        cnt = torch.where(j < wi[:, None], _popcount32(rows), 0).sum(dim=1)
        tw = rows.gather(1, (wi - grp * RANK_WORDS).clamp(0, RANK_WORDS - 1)[:, None])[:, 0]
        return self.cum[grp].long() + cnt + _popcount32(tw & _low_bits(pos1 & 31))

    def access(self, idx):
        self.account(lambda: 4 * idx.numel())
        return ((self.words.reshape(-1)[idx >> 5].long() & _M32) >> (idx & 31)) & 1


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


SERVE_CACHE_SUFFIX = ".serve_plain_w.npz"


def serve_cache_digest(fields):
    """The staleness guard of the wide-row disk cache: the row layout's
    version tag, n, first_isa and every len // 64-th sampled-SA entry
    (centrifuger_tpu.fm.device._serve_cache_digest, so that either package's
    file is a hit for the other)."""
    h = hashlib.sha1()
    h.update(b"wide1920-v2")        # serving-row layout version
    h.update(np.int64(fields["n"]).tobytes())
    h.update(np.int64(fields["first_isa"]).tobytes())
    sa = fields["sampled_sa"]
    h.update(np.ascontiguousarray(sa[:: max(1, len(sa) // 64)]).tobytes())
    return h.hexdigest()


def serve_plain_rows(fields):
    """The plain layout's wide rows (uint32 [n // 1920 + 1, 128]), read from
    <prefix>.serve_plain_w.npz when the index was loaded from a prefix
    (`source_prefix`) and the file's digest matches; else built from the
    decoded BWT and, with a prefix, written there.  A stale digest, a file of
    another shape or an unreadable file rebuilds.  The file is written under a
    temporary name and then renamed, so a concurrent reader never sees half of
    it; a failed write leaves the rows as built."""
    prefix = fields.get("source_prefix")
    path = prefix + SERVE_CACHE_SUFFIX if prefix else None
    digest = serve_cache_digest(fields) if path else None
    shape = (int(fields["n"]) // WIDE_BLOCK + 1, WIDE_WORDS)
    if path and os.path.exists(path):
        try:
            with np.load(path) as z:
                if str(z["digest"]) == digest:
                    rows = z["rows"]
                    if rows.shape == shape and rows.dtype.itemsize == 4:
                        # the JAX package stores uint32, an int32 view reads the same bytes
                        return rows.view(np.uint32)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            pass
    rows = build_wide_rows(fields["bwt_codes"]())
    if path:
        tmp = "%s.%d.tmp" % (path, os.getpid())
        try:
            with open(tmp, "wb") as f:
                np.savez(f, rows=rows, digest=digest)
            os.replace(tmp, path)
        except OSError as e:
            sys.stderr.write("[serve cache] not written (%s)\n" % e)
            with contextlib.suppress(OSError):
                os.remove(tmp)
    return rows


def offset_wide_rows(rows, offset):
    """A copy of uint32 wide rows [R, 128] with `offset` added to every occ
    column, the 40-bit sum split into the lo word and the row's WIDE_HI byte.
    An int64 index over such rows ranks `offset` higher at every pos >= 0:
    the tests and chip_smoke.py check the hi byte that way without an index
    of 2^32 symbols."""
    rows = np.array(rows, dtype=np.uint32)
    hi = rows[:, WIDE_HI].astype(np.uint64)
    new_hi = np.zeros(len(rows), np.uint64)
    for c in range(4):
        occ = rows[:, c].astype(np.uint64) + \
            (((hi >> np.uint64(8 * c)) & np.uint64(0xFF)) << np.uint64(32)) + np.uint64(offset)
        if (occ >> np.uint64(40)).any():
            raise ValueError("the offset occ does not fit 40 bits")
        rows[:, c] = (occ & np.uint64(_M32)).astype(np.uint32)
        new_hi |= (occ >> np.uint64(32)) << np.uint64(8 * c)
    rows[:, WIDE_HI] = new_hi.astype(np.uint32)
    return rows


def offset_rows_view(fm, offset):
    """The int64 plain-layout index `fm` with its wide rows offset
    (offset_wide_rows); the other buffers are shared.  Only its rank_sym has
    a meaning."""
    if fm.layout != "plain" or fm.idtype != torch.int64:
        raise ValueError("offset rows need an int64 index on the plain layout")
    out = copy.copy(fm)
    out._buffers = dict(fm._buffers)
    rows = offset_wide_rows(fm.rows.cpu().numpy().view(np.uint32), offset)
    out.rows = torch.from_numpy(rows.view(np.int32)).to(fm.device)
    return out


def fm_arrays(fm):
    """What TorchFM needs from an FMIndexData (either package's: the on-disk
    format is shared): scalars, numpy arrays, and `bwt_codes`, a callable that
    decodes the run-block BWT (only the plain layout calls it)."""
    bwt = fm.bwt
    return dict(
        n=fm.n, sigma=fm.sigma, code_bits=fm.code_bits,
        precompute_width=fm.precompute_width, first_isa=fm.first_isa,
        last_chr=fm.last_chr, sample_rate=fm.sample_rate,
        adjusted_sa0=fm.adjusted_sa0, has_end_marker=fm.has_end_marker,
        psum=fm.psum, ftab_start=fm.ftab_start, ftab_len=fm.ftab_len,
        sampled_sa=fm.sampled_sa, selected_rows=fm.selected_rows,
        selected_vals=fm.selected_vals, end_marker_sa=fm.end_marker_sa,
        rowmap=getattr(fm, "rowmap", None), bwt_codes=bwt.decode,
        source_prefix=getattr(fm, "source_prefix", None),
        bwt_b=bwt.b, bwt_n=bwt.n,
        ind_words=bwt.indicator.words, ind_cum=bwt.indicator.cum,
        ind_n=bwt.indicator.n,
        lit_words=bwt.lit.words, lit_occ=bwt.lit.occ, lit_width=bwt.lit.width,
        lit_n=bwt.lit.n,
        run_words=bwt.run.words, run_occ=bwt.run.occ, run_width=bwt.run.width,
        run_n=bwt.run.n)


class TorchFM(nn.Module):
    """Device mirror of FMIndexData with the kernels' plain twins."""

    def __init__(self, fields, device="cuda", serve_layout="plain",
                 force_idtype=None, _generic=False):
        """`force_idtype` ("int32" / "int64") overrides the index type that n
        picks, as DeviceFM's does.  `_generic` puts a sigma-4 index on the
        generic layout too, which no entry point does: the tests hold the
        2-bit streams to DeviceFM's run-block mirrors that way."""
        super().__init__()
        device = resolve_device(device)
        if serve_layout not in SERVE_LAYOUTS:
            raise ValueError("serve_layout must be one of %s" % (SERVE_LAYOUTS,))
        n = int(fields["n"])
        self.idtype = index_dtype(n, force_idtype)
        idx64 = self.idtype == torch.int64
        npd = np.int64 if idx64 else np.int32
        rowmap = fields["rowmap"]
        if rowmap is not None and n >= 1 << 31:
            raise ValueError(
                "a rowmap over n >= 2^31 rows would wrap its int32 row ids: "
                "load the index with --no-rowmap (or rebuild it with --no-row-map)")
        self.n = n
        self.sigma = int(fields["sigma"])
        # the fused-row layouts hold 2-bit symbols; everything else ranks
        # through the run-block mirrors (DeviceFM.fast).  The mega-table's
        # row math is 32-bit: an int64 index serves "runblock" as generic.
        generic = self.sigma != 4 or _generic or (idx64 and serve_layout == "runblock")
        self.layout = "generic" if generic else serve_layout
        self.code_bits = int(fields["code_bits"])
        self.pw = int(fields["precompute_width"])
        self.first_isa = int(fields["first_isa"])
        self.last_chr = int(fields["last_chr"])
        self.sample_rate = int(fields["sample_rate"])
        self.adjusted_sa0 = int(fields["adjusted_sa0"])
        self.ftab_size = len(fields["ftab_len"])
        self.b = int(fields["bwt_b"])
        self.b_lt_n = self.b < int(fields["bwt_n"])
        self.lit_n = int(fields["lit_n"])
        self.run_n = int(fields["run_n"])
        # bytes of index tables the plain versions read, when set to an int:
        # the least traffic a kernel doing the same work must move
        self.traffic = None

        def buf(name, arr):
            _buf(self, name, arr, device)

        rows = mega = None
        self.ind = self.lit = self.run = None
        self.m_lit = self.m_run = 0
        if self.layout == "plain":
            rows = serve_plain_rows(fields).view(np.int32)
        elif self.layout == "runblock":
            table, _, self.m_lit, self.m_run = build_mega_table(fields)
            mega = table.view(np.int32)
        else:
            if int(fields["lit_width"]) != int(fields["run_width"]):
                raise ValueError(
                    "the literal and the run stream differ in symbol width "
                    "(%d and %d bits): the kernels read both with one width"
                    % (fields["lit_width"], fields["run_width"]))
            self.ind = TorchBitvector(fields["ind_words"], fields["ind_cum"],
                                      fields["ind_n"], device, self.account, npd)
            self.lit = TorchPacked(fields["lit_words"], fields["lit_occ"],
                                   fields["lit_width"], self.lit_n, device,
                                   self.account, npd)
            self.run = TorchPacked(fields["run_words"], fields["run_occ"],
                                   fields["run_width"], self.run_n, device,
                                   self.account, npd)
        buf("rows", rows)
        buf("mega", mega)
        buf("ftab", np.stack([fields["ftab_start"], fields["ftab_len"]],
                             axis=1).astype(npd).reshape(-1))
        buf("psum", np.asarray(fields["psum"]).astype(npd))
        buf("sampled_sa", np.asarray(fields["sampled_sa"]).astype(npd))
        sel = fields["selected_rows"]
        has_sel = sel is not None and len(sel) > 0
        buf("sel_rows", np.asarray(sel).astype(npd) if has_sel else None)
        buf("sel_vals", np.asarray(fields["selected_vals"]).astype(npd)
            if has_sel else None)
        end = fields["end_marker_sa"] if fields["has_end_marker"] else None
        buf("end_marker_sa", None if end is None else np.asarray(end).astype(npd))
        buf("rowmap", None if rowmap is None else
            np.asarray(rowmap).astype(np.int32))

    def kernel_view(self):
        """The index as the kernels see it (kernels.LaunchView: the FMView of
        its buffers' addresses and scalars), built at its first launch and
        kept until an attribute of this object is set or its buffers move."""
        view = self.__dict__.get("_kernel_view")
        if view is None:
            view = self.__dict__["_kernel_view"] = kernels.LaunchView(self)
        return view

    def __setattr__(self, name, value):
        # a buffer swapped (rowmap = None, offset rows, ...) would leave the
        # view reading the old tensor's memory
        self.__dict__.pop("_kernel_view", None)
        super().__setattr__(name, value)

    def _apply(self, fn, *args, **kwargs):
        self.__dict__.pop("_kernel_view", None)
        return super()._apply(fn, *args, **kwargs)

    def account(self, nbytes):
        """Add nbytes() (an int or a 0-d tensor) when accounting is on."""
        if self.traffic is not None:
            self.traffic += int(nbytes())

    @classmethod
    def from_index(cls, fm, device="cuda", serve_layout="plain", force_idtype=None):
        return cls(fm_arrays(fm), device, serve_layout, force_idtype)

    @property
    def isz(self):
        """Bytes of one position or count of the index type."""
        return 8 if self.idtype == torch.int64 else 4

    @property
    def device(self):
        return self._buffers["psum"].device

    def over_devices(self, fn, rows_per_unit, *tensors):
        """fn(self, *tensors): the whole batch on this index's one device (a
        sharded index spread over several cards splits it by units of
        rows_per_unit rows: parallel/sharded.py)."""
        return fn(self, *tensors)

    @property
    def wide_ftab(self):
        """The ftab key and the per-position fields no longer pack into 31
        bits: DeviceFM._chain_search_impl then takes the eager-ftab chain."""
        return self.code_bits * self.pw + 9 > 31

    # ------------------------------------------------ wide-row primitives
    # Plain (batched tensor) versions of the __device__ functions in
    # kernels/csrc/fm_device.cuh; positions are int64 tensors.

    def _row_words(self, pos):
        """uint32 words (as int64) of the wide row holding pos's rank."""
        occ_bytes = 8 if self.idtype == torch.int64 else 4   # + the hi word
        self.account(lambda: (occ_bytes + 4 * _ceil_div(
            torch.remainder(pos + 1, WIDE_BLOCK), 16)).sum())
        return self._plain_rows_fetch(torch.div(pos + 1, WIDE_BLOCK,
                                                rounding_mode="floor")).long() & _M32

    # The three big tables' reads (DeviceFM's hooks of the same names, which
    # the sharded index routes to the owner shard: parallel/sharded.py)

    def _plain_rows_fetch(self, r):
        """Wide rows r [M] -> int32 [M, 128]."""
        return self.rows[r]

    def _rowmap_fetch(self, rows):
        """rowmap[rows], rows [M] in [0, n)."""
        self.account(lambda: 4 * len(rows))
        return self.rowmap[rows]

    def _sampled_sa_fetch(self, slot):
        """sampled_sa[slot], slot [M] in range."""
        return self.sampled_sa[slot]

    @staticmethod
    def _prefix_count(row, c, pos1):
        """Count symbol c in the first pos1 % 1920 slots of each row."""
        w = row[:, WIDE_OFF:WIDE_OFF + WIDE_DATA]
        m = _swar_match(w, c[:, None], 2)
        upto = torch.remainder(pos1, WIDE_BLOCK)
        j = torch.arange(WIDE_DATA, device=row.device)
        nb = (upto[:, None] - 16 * j[None, :]).clamp(0, 16) * 2
        return _popcount32(m & _low_bits(nb)).sum(dim=1)

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

    def _wide_occ(self, row, c):
        """occ checkpoint of c from a wide row (DeviceFM._wide_occ): the lo
        word, and on an int64 index bits 32..39 from the WIDE_HI byte."""
        occ = row.gather(1, c[:, None])[:, 0]
        if self.idtype == torch.int64:
            occ = occ + (((row[:, WIDE_HI] >> (8 * c)) & 0xFF) << 32)
        return occ

    def _plain_rank_sym(self, c, pos):
        row = self._row_words(pos)
        rank = torch.where(pos < 0, torch.zeros_like(pos),
                           self._wide_occ(row, c) + self._prefix_count(row, c, pos + 1))
        return rank, self._sym(row, pos)

    def _plain_lf(self, p):
        """LF from one wide row (DeviceFM._plain_lf)."""
        row = self._row_words(p)
        sym = self._sym(row, p)
        rank = self._wide_occ(row, sym) + self._prefix_count(row, sym, p + 1)
        corr = ((sym == self.last_chr) & (p < self.first_isa)).long()
        return self.psum.long()[sym] + rank + corr - 1

    # --------------------------------------------- mega-table primitives
    # kernels/csrc/rank_mega.cuh

    def _stream_rank_sym(self, off, c, spos):
        """(rank_inclusive(c, spos), symbol at spos) from the stream row of the
        mega-table that holds spos's rank; spos >= -1, -1 gives rank 0."""
        pos1 = spos + 1
        upto = pos1 & 255
        self.account(lambda: (4 + 4 * _ceil_div(upto, 16)).sum())
        row = self.mega[off + (pos1 >> 8)].long() & _M32
        w = row[:, STREAM_OFF:STREAM_OFF + 16]
        j = torch.arange(16, device=spos.device)[None, :]
        nb = (upto[:, None] - 16 * j).clamp(0, 16) * 2
        cnt = _popcount32(_swar_match(w, c[:, None], 2) & _low_bits(nb)).sum(dim=1)
        rank = torch.where(spos < 0, 0, row.gather(1, c[:, None])[:, 0] + cnt)
        in_row = spos - ((pos1 >> 8) << 8)
        sw = torch.where(in_row < 0, row[:, STREAM_PREV],
                         w.gather(1, (in_row >> 4).clamp(min=0)[:, None])[:, 0])
        return rank, (sw >> ((spos & 15) * 2)) & 3

    def _runblock_rank_sym(self, c, pos):
        """DeviceFM._runblock_rank_sym: the indicator row, then the literal row
        and the run row."""
        b = self.b
        posc = pos.clamp(min=0)
        bi = torch.div(posc, b, rounding_mode="floor")
        ipos1 = bi + 1
        within = ipos1 & 255
        self.account(lambda: (4 + 4 * _ceil_div(within, 32)).sum())
        irow = self.mega[ipos1 >> 8].long() & _M32
        iw8 = irow[:, IND_OFF:IND_OFF + 8]
        j = torch.arange(8, device=pos.device)[None, :]
        take = (within[:, None] - 32 * j).clamp(0, 32)
        r1 = irow[:, 0] + _popcount32(iw8 & _low_bits(take)).sum(dim=1)
        iin_row = bi - ((ipos1 >> 8) << 8)
        iw = torch.where(iin_row < 0, irow[:, IND_PREV],
                         iw8.gather(1, (iin_row >> 5).clamp(min=0)[:, None])[:, 0])
        typ = (iw >> (bi & 31)) & 1
        ranki = torch.where(typ == 1, r1, bi + 1 - r1) if self.b_lt_n \
            else torch.ones_like(bi)
        other = bi + 1 - ranki
        is_lit = typ == 0
        inb = torch.remainder(posc, b)
        lit_pos = torch.where(is_lit, (ranki - 1) * b + inb, other * b - 1)
        run_pos = torch.where(is_lit, other - 1, ranki - 1)
        lit_rank, lit_sym = self._stream_rank_sym(self.m_lit, c, lit_pos)
        run_rank, run_sym = self._stream_rank_sym(self.m_run, c, run_pos)
        run_part = torch.where(run_sym == c, (run_rank - 1) * b + inb + 1, run_rank * b)
        ret = torch.where(is_lit, lit_rank + run_rank * b, run_part + lit_rank)
        return torch.where(pos < 0, 0, ret), torch.where(is_lit, lit_sym, run_sym)

    # ---------------------------------------------- run-block primitives
    # kernels/csrc/rank_runblock.cuh

    def _lit_rank(self, c, pos):
        if self.lit_n == 0:
            return torch.zeros_like(pos)
        return _on(pos >= 0, self.lit.rank_inclusive, c,
                   pos.clamp(max=self.lit_n - 1))

    def _run_rank(self, c, pos):
        if self.run_n == 0:
            return torch.zeros_like(pos)
        return _on(pos >= 0, self.run.rank_inclusive, c,
                   pos.clamp(max=self.run_n - 1))

    def bwt_rank(self, c, idx):
        """Sequence_RunBlock::Rank (DeviceFM.bwt_rank), clips included;
        idx in [0, n - 1].  DeviceFM evaluates both block types for every
        lane and selects; here a lane reads only its own type's terms."""
        b = self.b
        bi = torch.div(idx, b, rounding_mode="floor")
        typ = self.ind.access(bi)
        if self.b_lt_n:
            r1 = self.ind.rank1_inclusive(bi)
            ranki = torch.where(typ == 1, r1, bi + 1 - r1)
        else:
            ranki = torch.ones_like(idx)
        other = bi + 1 - ranki
        inb = torch.remainder(idx, b)
        lit = typ == 0
        crossed = other != 0
        ret_lit = _on(lit, self._lit_rank, c, (ranki - 1) * b + inb) + \
            _on(lit & crossed, self._run_rank, c, other - 1) * b
        ret_run = _on(~lit & crossed, self._lit_rank, c, other * b - 1)
        if self.run_n:
            rb_rank = _on(~lit, self._run_rank, c, ranki - 1)
            in_run = _on(~lit, self.run.access,
                         (ranki - 1).clamp(0, self.run_n - 1)) == c
            ret_run = ret_run + torch.where(
                in_run, (rb_rank - 1) * b + inb + 1, rb_rank * b)
        return torch.where(lit, ret_lit, ret_run)

    def bwt_access(self, idx):
        """Sequence_RunBlock::Access (DeviceFM.bwt_access)."""
        b = self.b
        bi = torch.div(idx, b, rounding_mode="floor")
        lit = self.ind.access(bi) == 0
        r1 = self.ind.rank1_inclusive(bi)
        lit_idx = idx - b * r1
        run_idx = torch.div(idx - b * (bi + 1 - r1), b, rounding_mode="floor")
        lit_v = _on(lit, self.lit.access, lit_idx.clamp(0, max(self.lit_n - 1, 0))) \
            if self.lit_n else torch.zeros_like(idx)
        run_v = _on(~lit, self.run.access, run_idx.clamp(0, max(self.run_n - 1, 0))) \
            if self.run_n else torch.zeros_like(idx)
        return torch.where(lit, lit_v, run_v)

    def rank(self, c, p, inclusive):
        """FMIndex::Rank with the displaced-last-char correction
        (DeviceFM.rank); generic layout."""
        if inclusive:
            r = self.bwt_rank(c, p)
            corr = (c == self.last_chr) & (p < self.first_isa)
        else:
            r = _on(p > 0, self.bwt_rank, c, p - 1)
            corr = (c == self.last_chr) & (p <= self.first_isa)
        return r + corr.long()

    # ------------------------------------------- the layouts' common face

    def rank_sym(self, c, pos):
        """(BWT rank_inclusive(c, pos), stored symbol at pos); pos >= -1,
        pos = -1 gives rank 0 (DeviceFM._fused_rank_sym; on the generic layout
        bwt_rank and bwt_access)."""
        if self.layout == "plain":
            return self._plain_rank_sym(c, pos)
        if self.layout == "runblock":
            return self._runblock_rank_sym(c, pos)
        return _on(pos >= 0, self.bwt_rank, c, pos), self.bwt_access(pos.clamp(min=0))

    def backward_extend(self, c, sp, ep):
        """FMIndex::BackwardExtend (DeviceFM.backward_extend)."""
        off = self.psum.long()[c]
        if self.layout == "generic":
            nsp = off + self.rank(c, sp, inclusive=False)
            same = sp == ep
            r_ep = _on(~same, lambda cc, e: self.rank(cc, e, inclusive=True), c, ep)
            acc = _on(same, self.bwt_access, ep)
            return nsp, torch.where(same, nsp - (acc != c).long(), off + r_ep - 1)
        r_sp, _ = self.rank_sym(c, sp - 1)
        r_ep, sym_ep = self.rank_sym(c, ep)
        is_last = c == self.last_chr
        nsp = off + r_sp + (is_last & (sp <= self.first_isa)).long()
        nep_rank = off + r_ep + (is_last & (ep < self.first_isa)).long() - 1
        nep = torch.where(sp == ep, nsp - (sym_ep != c).long(), nep_rank)
        return nsp, nep

    def lf(self, p):
        """LF-mapping of rows p >= 0 (DeviceFM.lf)."""
        if self.layout == "plain":
            return self._plain_lf(p)
        if self.layout == "runblock":
            # the symbol first (the rank of a dummy c is discarded)
            _, sym = self.rank_sym(torch.zeros_like(p), p)
            r, _ = self.rank_sym(sym, p)
            corr = ((sym == self.last_chr) & (p < self.first_isa)).long()
            return self.psum.long()[sym] + r + corr - 1
        c = self.bwt_access(p)
        return self.psum.long()[c] + self.rank(c, p, inclusive=True) - 1

    def _sel_lookup(self, rows):
        """(row is a selected row, its position in sel_rows)."""
        sel = self.sel_rows.long()
        pos = torch.searchsorted(sel, rows).clamp(max=len(sel) - 1)
        return sel[pos] == rows, pos

    def stored_here(self, rows):
        """Rows whose SA value is stored (DeviceFM._sample_stored_here)."""
        found = (rows == self.first_isa) | \
            (torch.remainder(rows, self.sample_rate) == 0)
        if self.sel_rows is not None:
            found = found | self._sel_lookup(rows)[0]
        elif self.end_marker_sa is not None:
            found = found | (rows < len(self.end_marker_sa))
        return found

    def sampled_value(self, rows):
        """Stored value of stored rows (DeviceFM.get_sampled_sa), else 0."""
        first = rows == self.first_isa
        samp = ~first & (torch.remainder(rows, self.sample_rate) == 0)
        slot = torch.div(rows, self.sample_rate, rounding_mode="floor")
        val = _on(samp, lambda s: self._sampled_sa_fetch(s).long(), slot)
        val = torch.where(first, torch.full_like(rows, self.adjusted_sa0), val)
        if self.sel_rows is not None:
            is_sel, pos = self._sel_lookup(rows)
            val = torch.where(~first & ~samp & is_sel,
                              self.sel_vals[pos].long(), val)
        elif self.end_marker_sa is not None:
            m = len(self.end_marker_sa)
            val = torch.where(~first & ~samp & (rows < m),
                              self.end_marker_sa[rows.clamp(0, m - 1)].long(), val)
        return val

    def ftab_entry(self, kmer):
        """(ftab_start, ftab_len) of packed pw-mers, the key clipped to the
        table."""
        kmer = kmer.clamp(0, self.ftab_size - 1)
        return self.ftab[2 * kmer].long(), self.ftab[2 * kmer + 1].long()


# ------------------------------------------- rank, extend, LF: the wrappers

# Every tensor of these three is in the index type (idtype): symbols too, so
# that rank_probe.cu reads one type.

def _probe(fm, mode, a, b, c):
    M = len(a)
    out = torch.empty(2, M, dtype=fm.idtype, device=a.device)
    if M:
        kernels.launch("rank_probe", fm, mode, a, b, c, M, out[0], out[1])
    return out


def rank_sym(fm, c, pos):
    """Wrapper of the layouts' rank (DeviceFM._fused_rank_sym / bwt_rank +
    bwt_access): c, pos [M], pos >= -1 -> (rank, symbol)."""
    _check(fm, "rank_sym", c=(c, fm.idtype), pos=(pos, fm.idtype))
    if c.device.type == "cpu":
        r, s = fm.rank_sym(c.long(), pos.long())
        return r.to(fm.idtype), s.to(fm.idtype)
    out = _probe(fm, 0, c, pos, pos)
    return out[0], out[1]


def backward_extend(fm, c, sp, ep, group=False):
    """Wrapper of BackwardExtend (DeviceFM.backward_extend): [M] each,
    0 <= sp <= ep < n -> (nsp, nep).  `group` runs it as the kernels of a
    lane do (Lanes<Layout>, a warp a query) instead of the layout's
    one-thread code."""
    _check(fm, "backward_extend", c=(c, fm.idtype), sp=(sp, fm.idtype),
           ep=(ep, fm.idtype))
    if c.device.type == "cpu":
        nsp, nep = fm.backward_extend(c.long(), sp.long(), ep.long())
        return nsp.to(fm.idtype), nep.to(fm.idtype)
    out = _probe(fm, 3 if group else 1, c, sp, ep)
    return out[0], out[1]


def lf(fm, p, group=False):
    """Wrapper of the LF-mapping (DeviceFM.lf): p [M] in [0, n) -> [M];
    `group` as for backward_extend."""
    _check(fm, "lf", p=(p, fm.idtype))
    if p.device.type == "cpu":
        return fm.lf(p.long()).to(fm.idtype)
    return _probe(fm, 4 if group else 2, p, p, p)[0]


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


def _extend_lanes(fm, which, c, sp, ep):
    """BackwardExtend on the lanes `which` only; (1, 0), an empty range,
    elsewhere."""
    nsp, nep = torch.ones_like(sp), torch.zeros_like(ep)
    idx = which.nonzero()[:, 0]
    if len(idx):
        nsp[idx], nep[idx] = fm.backward_extend(c[idx], sp[idx], ep[idx])
    return nsp, nep


# ------------------------------------------------------ K1: chain search

def chain_search_lanes_plain(fm, codes, lengths, mhl, H):
    """Semi-maximal exact-match chains per lane: the START/EXTEND state
    machine of DeviceFM._chain_search_lazyftab_impl and
    _chain_search_ftab_impl, in lockstep.  The two JAX programs differ in how
    they ship the START outcomes to the loop (one packed int32 word while
    code_bits*pw + 9 <= 31, separate precomputed tables beyond); the values
    are the same, and this version keeps the k-mer in an int64, so it has no
    pack limit.

    codes [B, L] (255 invalid), lengths [B] -> (hits [B, H, 4] of (sp, ep,
    l, off) in the index type, nhits int32 [B])."""
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
        fm.account(lambda: 2 * fm.isz * (start & (tv >= pw)).sum())
        nsp, nep = _extend_lanes(fm, extend & ~c_invalid, c, sp, ep)
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
    return hits.to(fm.idtype), nh.int()


def chain_search_lanes(fm, codes, lengths, mhl, H):
    """K1 wrapper for ready-made code lanes (the protein path's six frames a
    read, the non-fused engine's strand lanes): codes uint8 [B, L] (255
    invalid), lengths int32 [B] -> (hits [B, H, 4] of (sp, ep, l, off) in
    the index type, nhits int32 [B])."""
    _check(fm, "chain_search_lanes", codes=(codes, torch.uint8),
           lengths=(lengths, torch.int32))
    if codes.dim() != 2 or lengths.shape != (codes.shape[0],):
        raise ValueError("chain_search_lanes: want codes [B, L] and lengths [B]")
    if codes.device.type == "cpu":
        return chain_search_lanes_plain(fm, codes, lengths, mhl, H)
    B, L = codes.shape
    hits = torch.empty(B, H, 4, dtype=fm.idtype, device=codes.device)
    nhits = torch.empty(B, dtype=torch.int32, device=codes.device)
    if B:
        kernels.launch("chain_search_lanes", fm, codes, lengths, B, L, mhl, H,
                       hits, nhits, variant=chain_variant(fm, lanes=True))
    return hits, nhits


def chain_variant(fm, lanes):
    """The chain kernel's instantiation beside the layout, as the launch
    counts name it: the code source and the ftab key."""
    return ("lanes",) * lanes + ("wideftab",) * fm.wide_ftab


# ------------------------------------------------------------ K2: resolve

def resolve_rows_plain(fm, rows, valid):
    """SA row -> stored value (DeviceFM._resolve_rows_impl): one rowmap
    gather, or the LF walk to a stored row.  rows [M], valid [M] bool ->
    [M] in the index type (0 on invalid lanes)."""
    rows = rows.long()
    if fm.rowmap is not None:
        val = _on(valid, lambda r: fm._rowmap_fetch(r).long(), rows.clamp(0, fm.n - 1))
    else:
        cur = torch.where(valid, rows, torch.zeros_like(rows))
        pend = valid.clone()
        while True:
            pend &= ~fm.stored_here(cur)
            if not bool(pend.any()):
                break
            idx = pend.nonzero()[:, 0]
            cur[idx] = fm.lf(cur[idx])
        fm.account(lambda: fm.isz * valid.sum())
        val = fm.sampled_value(cur)
    return torch.where(valid, val, torch.zeros_like(val)).to(fm.idtype)


def resolve_rows(fm, rows, valid):
    """K2 wrapper: rows [M] in the index type, valid bool [M] -> [M] in the
    index type."""
    _check(fm, "resolve_rows", rows=(rows, fm.idtype), valid=(valid, torch.bool))
    if rows.shape != valid.shape or rows.dim() != 1:
        raise ValueError("rows and valid must be 1-D of one length")
    if rows.is_cpu:
        return resolve_rows_plain(fm, rows, valid)
    out = torch.empty_like(rows)
    if len(rows):
        kernels.launch("resolve_rows", fm, rows, valid, len(rows), out)
    return out


# ------------------------------------------------------- K5: prefix search

def prefix_search_plain(fm, codes, ms):
    """Longest-suffix backward search of codes[:, :ms] per lane
    (DeviceFM._prefix_search_impl).  codes [B, L] (255 invalid), ms [B] ->
    (l, sp, ep) [B] each, in the index type."""
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
    fm.account(lambda: 2 * fm.isz * (~too_short & ~short_tail).sum())
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
        nsp, nep = _extend_lanes(fm, act & (c != 255), c, sp, ep)
        ok = act & (nsp <= nep)
        sp = torch.where(ok, nsp, sp)
        ep = torch.where(ok, nep, ep)
        l = torch.where(ok, l + 1, l)
        running = running & ok
    return l.to(fm.idtype), sp.to(fm.idtype), ep.to(fm.idtype)


def prefix_search(fm, codes, ms):
    """K5 wrapper: codes uint8 [B, L] (255 invalid), ms int32 [B] ->
    (l, sp, ep) [B] each, in the index type."""
    _check(fm, "prefix_search", codes=(codes, torch.uint8), ms=(ms, torch.int32))
    if codes.dim() != 2 or ms.shape != (codes.shape[0],):
        raise ValueError("codes must be [B, L] and ms [B]")
    if codes.device.type == "cpu":
        return prefix_search_plain(fm, codes, ms)
    B, L = codes.shape
    out = torch.empty(3, B, dtype=fm.idtype, device=codes.device)
    if B:
        kernels.launch("prefix_search", fm, codes, ms, B, L, out)
    return out[0], out[1], out[2]


def _check(fm, name, **tensors):
    """Wrapper argument checks: dtype, contiguity, and one device shared with
    the index buffers."""
    device = fm.device
    for arg, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError("%s: %s must be %s, got %s" % (name, arg, dtype, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (name, arg))
        if t.device != device:
            raise ValueError("%s: %s is on %s but the index is on %s"
                             % (name, arg, t.device, device))
