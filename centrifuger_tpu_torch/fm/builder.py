# Port copy of centrifuger_tpu.fm.builder (host code, no accelerator).
"""Offline FM-index construction from compacted genome codes.

Mirrors the semantics of FMBuilder::Build + Builder::TransformSampledSAToSeqId
(reference compactds/FMBuilder.hpp:444-811, Builder.hpp:27-71): suffix array →
sentinel-free BWT with firstISA, row-sampled SA, ftab (precomputedRange),
selected genome-boundary rows, protein end markers — then every stored SA value
is replaced by the sequence id of the genome containing it (with the
ftab-width fuzzy boundary shift).
"""

import os

import numpy as np

from .index import FMIndexData
from .runblock import RunBlockSeq
from ..succinct.packed import PIECE
from .suffix_array import suffix_array, bwt_from_sa
from ..utils import log2ceil, div_ceil


class FMBuildParams:
    def __init__(self, sample_rate=16, precompute_width=10, rbbwt_b=0,
                 has_end_marker=False, row_map=False):
        self.sample_rate = sample_rate
        self.precompute_width = precompute_width
        self.rbbwt_b = rbbwt_b
        self.has_end_marker = has_end_marker
        self.row_map = row_map


def _psum_search(psums, v):
    """PartialSum::Search semantics: max i with Sum(i) <= v, clamped to n
    (reference compactds/PartialSum.hpp:105-111). psums = [0, l0, l0+l1, ..., total]."""
    v = np.asarray(v, dtype=np.int64)
    i = np.searchsorted(psums, v, side="right") - 1
    return np.minimum(i, len(psums) - 2)


def build_fm(codes, genome_lens, genome_seqids, alphabet, params,
             precomputed_sa=None):
    """codes: uint8 concatenated compacted genomes; genome_lens/genome_seqids:
    per-genome lengths and (compact) sequence ids in concatenation order."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    sigma = len(alphabet)
    pw = params.precompute_width
    code_bits = log2ceil(sigma)

    sa = precomputed_sa if precomputed_sa is not None else suffix_array(codes, sigma)
    bwt_codes, first_isa = bwt_from_sa(codes, sa)

    idx = FMIndexData()
    idx.n = n
    idx.alphabet = alphabet
    idx.sigma = sigma
    idx.code_bits = code_bits
    idx.first_isa = first_isa
    idx.last_chr = int(codes[n - 1])
    idx.precompute_width = pw
    idx.sample_rate = params.sample_rate
    idx.has_end_marker = params.has_end_marker

    # F column partial sums over BWT counts (FMIndex::Init, reference FMIndex.hpp:339-349)
    counts = np.bincount(bwt_codes, minlength=sigma)
    idx.psum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    # ftab: range of SA rows whose suffix starts with each pw-mer
    # (Postprocess_Thread ftab fill, reference compactds/FMBuilder.hpp:256-283;
    #  suffixes shorter than pw are excluded).
    isa = np.empty(n, dtype=np.int64)
    isa[sa] = np.arange(n, dtype=np.int64)
    size = 1 << (code_bits * pw)
    if n >= pw:
        m = n - pw + 1
        kmer = np.zeros(m, dtype=np.int64)
        for j in range(pw):
            kmer += codes[j:j + m].astype(np.int64) << (code_bits * j)
        rows = isa[:m]
        ftab_len = np.bincount(kmer, minlength=size).astype(np.int64)
        order = np.argsort(kmer, kind="stable")
        sk = kmer[order]
        sr = rows[order]
        group_start = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))
        mins = np.minimum.reduceat(sr, group_start)
        ftab_start = np.zeros(size, dtype=np.int64)
        ftab_start[sk[group_start]] = mins
    else:
        ftab_len = np.zeros(size, dtype=np.int64)
        ftab_start = np.zeros(size, dtype=np.int64)
    idx.ftab_start = ftab_start
    idx.ftab_len = ftab_len

    # sampled SA: every sample_rate-th BWT row stores SA[row]
    sampled = sa[::params.sample_rate].copy()

    # genome boundary partial sums
    genome_lens = np.asarray(genome_lens, dtype=np.int64)
    genome_seqids = np.asarray(genome_seqids, dtype=np.int64)
    psums = np.concatenate([[0], np.cumsum(genome_lens)])

    end_marker_sa = None
    selected_rows = None
    selected_vals = None

    if not params.has_end_marker:
        # selected genome-boundary rows: text position psum - pw - 1 for each
        # boundary (Builder::Build, reference Builder.hpp:224-234)
        sel_pos = []
        for i in range(len(genome_lens) - 1):
            p = psums[i + 1]
            if p < pw + 1:
                continue
            sel_pos.append(p - pw - 1)
        sel_pos = np.array(sorted(set(sel_pos)), dtype=np.int64)
        if len(sel_pos):
            rows = isa[sel_pos]
            # value = seqid of genome containing pos + pw + 1 (TransformSampledSAToSeqId,
            # reference Builder.hpp:47-51)
            vals = genome_seqids[_psum_search(psums, sel_pos + pw + 1)]
            order = np.argsort(rows)
            selected_rows = rows[order]
            selected_vals = vals[order]

        # sampled SA -> seqids with fuzzy boundary shift (Builder.hpp:35-44)
        shifted = np.where(sampled + pw + 1 < n, sampled + pw + 1, sampled)
        idx.sampled_sa = genome_seqids[_psum_search(psums, shifted)]
        idx.adjusted_sa0 = int(genome_seqids[0])
    else:
        # protein: exact boundaries via end markers (Builder.hpp:54-69)
        idx.sampled_sa = genome_seqids[_psum_search(psums, sampled)]
        end_cnt = int((codes == 0).sum())
        em = sa[:end_cnt]
        k = _psum_search(psums, em + 1)
        k = np.minimum(k, len(genome_seqids) - 1)
        end_marker_sa = genome_seqids[k]
        # reference quirk: adjustedSA0 is only assigned in the non-endmarker
        # branch (Builder.hpp:45), so protein indexes keep the default 0
        idx.adjusted_sa0 = 0

    idx.selected_rows = selected_rows
    idx.selected_vals = selected_vals
    idx.end_marker_sa = end_marker_sa

    # run-block compress the BWT
    idx.bwt = RunBlockSeq.from_codes(bwt_codes, sigma, b=params.rbbwt_b)
    if params.row_map:
        idx.rowmap = compute_rowmap(idx, sa)
    return idx


ROWMAP_PIECE = 1 << 20   # rows a searchsorted step of compute_rowmap


def compute_rowmap(idx, sa, out=None):
    """Serving accelerator: rowmap[row] = the exact value the
    BackwardToSampledSA LF-walk (reference FMIndex.hpp:513-524) would return
    for `row`, precomputed for every BWT row.  The walk visits rows of text
    positions SA[row], SA[row]-1, ... and stops at the first stored row, so
    rowmap[row] = value of the stored row with the largest text position
    <= SA[row].  Turns the device resolve loop into one gather; costs 4
    bytes/char, so it is built only for small/medium databases.  Works in
    pieces of ROWMAP_PIECE rows; `out` (int32, may be `sa` itself) takes the
    result."""
    n = idx.n
    rate = idx.sample_rate
    # the stored rows besides the row samples, in rising precedence (a later
    # value of a row wins, as DeviceFM.get_sampled_sa / FMIndex resolve
    # them): end-marker rows, then the selected rows; a row sample and then
    # firstISA win over both
    xr, xv = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    if idx.has_end_marker and idx.end_marker_sa is not None:
        xr.append(np.arange(len(idx.end_marker_sa), dtype=np.int64))
        xv.append(np.asarray(idx.end_marker_sa, np.int64))
    if idx.selected_rows is not None and len(idx.selected_rows):
        xr.append(np.asarray(idx.selected_rows, np.int64))
        xv.append(np.asarray(idx.selected_vals, np.int64))
    xr, xv = np.concatenate(xr)[::-1], np.concatenate(xv)[::-1]
    xr, last = np.unique(xr, return_index=True)
    xv = xv[last]
    keep = (xr % rate != 0) & (xr != idx.first_isa)
    xr, xv = xr[keep], xv[keep]
    # text position and value of every stored row (firstISA's position is 0)
    pos = np.concatenate([sa[::rate], sa[xr], np.zeros(1, sa.dtype)])
    val = np.concatenate([np.asarray(idx.sampled_sa, np.int64), xv,
                          np.array([idx.adjusted_sa0], np.int64)])
    if idx.first_isa % rate == 0:      # firstISA is a row sample: one entry
        val[idx.first_isa // rate] = idx.adjusted_sa0
        pos, val = pos[:-1], val[:-1]
    order = np.argsort(pos)
    s_pos = pos[order]
    s_val = val[order].astype(np.int32)
    del pos, val, order
    if out is None:
        out = np.empty(n, np.int32)
    for a in range(0, n, ROWMAP_PIECE):
        k = np.searchsorted(s_pos, sa[a:a + ROWMAP_PIECE], side="right") - 1
        out[a:a + ROWMAP_PIECE] = s_val[k]
    return out


def _bincount(codes, sigma):
    """np.bincount of uint8 codes, a piece at a time (np.bincount casts its
    input to intp, 8 bytes a symbol)."""
    counts = np.zeros(sigma, np.int64)
    for a in range(0, len(codes), PIECE):
        counts += np.bincount(codes[a:a + PIECE], minlength=sigma)[:sigma]
    return counts


class _StreamAccum:
    """Incremental BWT/aux accumulation over SA chunks delivered in global
    row order — the whole-index aggregate state the reference's
    Postprocess_Thread fills per chunk (compactds/FMBuilder.hpp:212-318),
    without ever materializing the full SA or ISA."""

    def __init__(self, codes, sigma, params, sel_pos):
        self.codes = codes
        self.n = len(codes)
        self.sigma = sigma
        self.params = params
        self.pw = params.precompute_width
        self.bits = log2ceil(sigma)
        self.bwt = np.empty(self.n, np.uint8)
        self.sampled = np.zeros(div_ceil(self.n, params.sample_rate), np.int64)
        size = 1 << (self.bits * self.pw)
        self.ftab_len = np.zeros(size, np.int64)
        self.ftab_start = np.zeros(size, np.int64)
        self.ftab_seen = np.zeros(size, bool)
        self.first_isa = -1
        self.sel_pos = np.asarray(sorted(sel_pos), np.int64)
        self.sel_rows = []
        self.sel_vals_pos = []
        self.end_cnt = int((codes == 0).sum()) if params.has_end_marker else 0
        self.end_marker_sa = np.zeros(self.end_cnt, np.int64)

    def add(self, row0, sa):
        codes, n, pw = self.codes, self.n, self.pw
        rate = self.params.sample_rate
        rows = row0 + np.arange(len(sa), dtype=np.int64)
        self.bwt[rows] = np.where(sa == 0, codes[n - 1], codes[sa - 1])
        z = np.flatnonzero(sa == 0)
        if len(z):
            self.first_isa = int(rows[z[0]])
        m = rows % rate == 0
        self.sampled[rows[m] // rate] = sa[m]
        # ftab: suffixes of length >= pw, k-mer of the first pw chars
        ok = sa <= n - pw
        sab = sa[ok]
        if len(sab):
            km = np.zeros(len(sab), np.int64)
            for j in range(pw):
                km += codes[sab + j].astype(np.int64) << (self.bits * j)
            self.ftab_len += np.bincount(km, minlength=len(self.ftab_len))
            uk, first = np.unique(km, return_index=True)
            new = ~self.ftab_seen[uk]
            self.ftab_start[uk[new]] = rows[ok][first[new]]
            self.ftab_seen[uk[new]] = True
        # selected genome-boundary rows
        if len(self.sel_pos):
            p = np.searchsorted(self.sel_pos, sa)
            hit = (p < len(self.sel_pos)) & \
                (self.sel_pos[np.minimum(p, len(self.sel_pos) - 1)] == sa)
            if hit.any():
                self.sel_rows.append(rows[hit])
                self.sel_vals_pos.append(sa[hit])
        # protein end markers occupy the first end_cnt rows
        if self.end_cnt:
            em = rows < self.end_cnt
            if em.any():
                self.end_marker_sa[rows[em]] = sa[em]

    def state(self):
        return dict(bwt=self.bwt, sampled=self.sampled,
                    ftab_len=self.ftab_len, ftab_start=self.ftab_start,
                    ftab_seen=self.ftab_seen, first_isa=self.first_isa,
                    sel_rows=(np.concatenate(self.sel_rows)
                              if self.sel_rows else np.zeros(0, np.int64)),
                    sel_vals_pos=(np.concatenate(self.sel_vals_pos)
                                  if self.sel_vals_pos else np.zeros(0, np.int64)),
                    end_marker_sa=self.end_marker_sa)

    def load_state(self, st):
        self.bwt = st["bwt"]
        self.sampled = st["sampled"]
        self.ftab_len = st["ftab_len"]
        self.ftab_start = st["ftab_start"]
        self.ftab_seen = st["ftab_seen"]
        self.first_isa = int(st["first_isa"])
        sel_rows, sel_vals_pos = st["sel_rows"], st["sel_vals_pos"]
        self.sel_rows = [sel_rows] if len(sel_rows) else []
        self.sel_vals_pos = [sel_vals_pos] if len(sel_vals_pos) else []
        self.end_marker_sa = st["end_marker_sa"]


# --build-mem model (build_memory): the build's peak RSS above its start is
# the largest of its phases, each the sum of the arrays alive in it.  The
# per-row and per-char terms were measured on the CPU (RSS sampled every
# 1-5 ms, numpy's allocations traced) and rounded up.
MEM_BASE = 96 << 20            # interpreter, native library and allocator slack
ADD_PIECE = 1 << 19            # rows a _StreamAccum.add call takes at most
ADD_BYTES_PER_ROW = 64         # add()'s temporaries a row (48 measured: gathers,
                               # k-mers, their sort)
BATCH_BYTES_PER_ROW = 8        # a batch of chunks: its int64 positions (8.00
                               # measured; native/sa_chunked.cpp sorts in place)
DC_SORT_FACTOR = 6             # the DC sort's peak over its rank array (5 measured)
TAIL_BYTES_PER_CHAR = 4        # the run-block build: block masks, literal stream,
                               # its packing (3.7 measured), and the .cfr writer
ROWMAP_BYTES_PER_SAMPLE = 36   # compute_rowmap: position, value and order of
                               # every stored row
BMAX_FLOOR = 1 << 16           # --build-mem lowers bmax no further than this


def build_memory(n, sigma, params, dcv, bmax, threads, rowmap, kprefix):
    """Bytes of each phase of build_fm_streaming (and of build_index's
    parse before it) above the RSS at the build's start, for --build-mem:
    parse (the codes twice while they are joined), dc (the sample sort),
    plan (the 4^k k-mer table), chunks (the chunk pass: the accumulated
    BWT / samples / ftab, the DC ranks, the int32 SA capture for the rowmap,
    threads * bmax rows of a batch and one add() piece), tail (the rowmap
    and the run-block BWT built from them; the .cfr writer that may follow
    holds less)."""
    v = 2
    while v * v < dcv:
        v += 1
    dc = (n // (v * v) + 1) * (2 * v - 1) * 8
    text = n
    samples = div_ceil(n, params.sample_rate)
    acc = n + 8 * samples + 25 * (1 << (log2ceil(sigma) * params.precompute_width))
    capture = 4 * n if rowmap else 0
    batch = min(threads * bmax, n)       # a batch never holds more than the text
    rows = min(bmax, ADD_PIECE, n)
    return {
        "parse": MEM_BASE + 2 * text,
        "dc": MEM_BASE + text + acc + DC_SORT_FACTOR * dc,
        "plan": MEM_BASE + text + acc + dc + 8 * (1 << (log2ceil(sigma) * kprefix)),
        "chunks": MEM_BASE + text + acc + dc + capture +
        BATCH_BYTES_PER_ROW * batch + ADD_BYTES_PER_ROW * rows,
        "tail": MEM_BASE + text + acc + capture + TAIL_BYTES_PER_CHAR * n +
        (ROWMAP_BYTES_PER_SAMPLE * samples if rowmap else 0),
    }


def fit_build_mem(build_mem, n, sigma, params, dcv, bmax, threads, rowmap, kprefix):
    """(bmax, rowmap, fixed, peak) under the budget: bmax is lowered first
    (to BMAX_FLOOR at least), the rowmap capture dropped next; raises
    MemoryError when neither fits."""
    def peaks(b, keep):
        return build_memory(n, sigma, params, dcv, b, threads, keep, kprefix)
    for keep in ([True, False] if rowmap else [False]):
        m = peaks(min(bmax, BMAX_FLOOR), keep)
        need = max(m.values())
        if need > build_mem:
            continue
        # the chunk pass without its batch and add() rows
        fixed = peaks(0, keep)["chunks"]
        b = bmax
        if peaks(b, keep)["chunks"] > build_mem:
            room = build_mem - fixed
            b = (room - ADD_BYTES_PER_ROW * ADD_PIECE) // (BATCH_BYTES_PER_ROW * threads)
            if b < ADD_PIECE:
                b = room // (BATCH_BYTES_PER_ROW * threads + ADD_BYTES_PER_ROW)
        return b, keep, fixed, max(peaks(b, keep).values())
    # dc_bytes ~ (2r-1)/r^2 per char, so a LARGER --dcv shrinks the
    # difference-cover sample footprint
    raise MemoryError(
        "--build-mem %d too small: fixed state needs ~%d bytes; "
        "increase the budget or increase --dcv" % (build_mem, need))


def _plan_mismatch(z, n, digest, plan):
    """Why a state checkpoint cannot resume under this run's input and chunk
    plan (None when it can)."""
    if int(z["n"]) != n or ("digest" in z.files and str(z["digest"]) != digest):
        return "checkpoint state does not match input"
    if "plan_digest" not in z.files:
        # a state file without a plan (the JAX package's, or an older
        # build's) cannot show that its rows end where this plan's
        # next_chunk starts
        return "checkpoint state records no chunk plan"
    for key in ("k", "bmax", "dcv", "n_chunks", "plan_digest"):
        if str(z[key]) != str(plan[key]):
            return "checkpoint state was written under another chunk plan (%s %s, now %s)" \
                % (key, z[key], plan[key])
    return None


def build_fm_streaming(codes, genome_lens, genome_seqids, alphabet, params,
                       dcv=4096, bmax=1 << 24, threads=1, build_mem=0,
                       checkpoint_prefix=None, log=None):
    """Memory-bounded FM construction over the chunked external SA
    (fm/sa_external.py). Honors --bmax/--dcv/--build-mem/-t with
    ~10%-granularity checkpoint/resume; output identical to build_fm.
    --build-mem bounds the build's peak RSS growth (build_memory)."""
    from .sa_external import ChunkedSA, default_kprefix

    log = log or (lambda m: None)
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    sigma = len(alphabet)
    pw = params.precompute_width

    # rowmap accelerator: the chunk pass visits SA rows in order, so the full
    # SA can be captured on the fly (int32, turned into the rowmap in place)
    want_rowmap = bool(getattr(params, "row_map", False)) and n < (1 << 31)
    if build_mem:
        kprefix = default_kprefix(n, sigma)
        bmax, keep, fixed, peak = fit_build_mem(
            build_mem, n, sigma, params, dcv, bmax, threads, want_rowmap, kprefix)
        log("build-mem %d: using bmax=%d (fixed state ~%d, peak ~%d)"
            % (build_mem, bmax, fixed, peak))
        if want_rowmap and not keep:
            log("note: --row-map skipped: the full SA capture (~%d bytes) does "
                "not fit --build-mem" % (4 * n))
            want_rowmap = False

    genome_lens = np.asarray(genome_lens, dtype=np.int64)
    genome_seqids = np.asarray(genome_seqids, dtype=np.int64)
    psums = np.concatenate([[0], np.cumsum(genome_lens)])

    sel_pos = []
    if not params.has_end_marker:
        for i in range(len(genome_lens) - 1):
            p = psums[i + 1]
            if p >= pw + 1:
                sel_pos.append(p - pw - 1)
    sel_pos = sorted(set(sel_pos))

    acc = _StreamAccum(codes, sigma, params, sel_pos)
    cs = ChunkedSA(codes, sigma, dcv=dcv, bmax=bmax, threads=threads,
                   checkpoint_prefix=checkpoint_prefix, log=log)
    start_chunk = 0
    st_path = (checkpoint_prefix + "_checkpoint_state.npz") \
        if checkpoint_prefix else None
    plan = cs.plan_record() if st_path else None
    if st_path and os.path.exists(st_path):
        with np.load(st_path, allow_pickle=False) as z:
            # the state resumes only under the same input (digest) and the
            # same chunk plan: its rows end where this plan's next_chunk starts
            why = _plan_mismatch(z, n, cs.digest, plan)
            if why is None:
                acc.load_state(z)
                start_chunk = int(z["next_chunk"])
                log("resuming build at chunk %d" % start_chunk)
            else:
                log("%s; starting fresh" % why)
    if want_rowmap and start_chunk > 0:
        log("note: --row-map skipped on checkpoint resume (earlier SA chunks "
            "were not captured)")
        want_rowmap = False
    sa_full = np.empty(n, np.int32) if want_rowmap else None

    done = 0
    last_ckpt = start_chunk
    for ci, row0, part in cs.iter_chunks(start_chunk):
        for a in range(0, len(part), ADD_PIECE):
            acc.add(row0 + a, part[a:a + ADD_PIECE])
        if sa_full is not None:
            sa_full[row0:row0 + len(part)] = part
        done = ci + 1
        if st_path and cs.n_chunks >= 10 and \
                (done - last_ckpt) >= max(cs.n_chunks // 10, 1):
            st = acc.state()
            np.savez(st_path + ".tmp.npz", n=n, next_chunk=done,
                     digest=cs.digest, **plan, **st)
            os.replace(st_path + ".tmp.npz", st_path)
            last_ckpt = done
            log("checkpoint at chunk %d/%d" % (done, cs.n_chunks))
    part = None          # a view of the chunk pass's batch buffer: let it go
    cs.close()
    if st_path:
        for p in (st_path, checkpoint_prefix + "_checkpoint.json",
                  checkpoint_prefix + "_checkpoint_dc.npy"):
            if os.path.exists(p):
                os.remove(p)

    # ---- identical tail to build_fm ----
    idx = FMIndexData()
    idx.n = n
    idx.alphabet = alphabet
    idx.sigma = sigma
    idx.code_bits = log2ceil(sigma)
    idx.first_isa = acc.first_isa
    idx.last_chr = int(codes[n - 1])
    idx.precompute_width = pw
    idx.sample_rate = params.sample_rate
    idx.has_end_marker = params.has_end_marker

    counts = _bincount(acc.bwt, sigma)
    idx.psum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    idx.ftab_start = acc.ftab_start
    idx.ftab_len = acc.ftab_len

    sampled = acc.sampled
    end_marker_sa = None
    selected_rows = None
    selected_vals = None
    if not params.has_end_marker:
        if len(acc.sel_rows):
            srows = np.concatenate(acc.sel_rows)
            spos = np.concatenate(acc.sel_vals_pos)
            vals = genome_seqids[_psum_search(psums, spos + pw + 1)]
            order = np.argsort(srows)
            selected_rows = srows[order]
            selected_vals = vals[order]
        shifted = np.where(sampled + pw + 1 < n, sampled + pw + 1, sampled)
        idx.sampled_sa = genome_seqids[_psum_search(psums, shifted)]
        idx.adjusted_sa0 = int(genome_seqids[0])
    else:
        idx.sampled_sa = genome_seqids[_psum_search(psums, sampled)]
        k = _psum_search(psums, acc.end_marker_sa + 1)
        k = np.minimum(k, len(genome_seqids) - 1)
        end_marker_sa = genome_seqids[k]
        idx.adjusted_sa0 = 0

    idx.selected_rows = selected_rows
    idx.selected_vals = selected_vals
    idx.end_marker_sa = end_marker_sa
    if sa_full is not None:
        idx.rowmap = compute_rowmap(idx, sa_full, out=sa_full)
    idx.bwt = RunBlockSeq.from_codes(acc.bwt, sigma, b=params.rbbwt_b)
    return idx
