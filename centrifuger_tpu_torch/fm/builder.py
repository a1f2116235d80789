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


def compute_rowmap(idx, sa):
    """Serving accelerator: rowmap[row] = the exact value the
    BackwardToSampledSA LF-walk (reference FMIndex.hpp:513-524) would return
    for `row`, precomputed for every BWT row.  The walk visits rows of text
    positions SA[row], SA[row]-1, ... and stops at the first stored row, so
    rowmap[row] = value of the stored row with the largest text position
    <= SA[row].  Turns the device resolve loop into one gather; costs 4
    bytes/char, so it is built only for small/medium databases."""
    n = idx.n
    rows = np.arange(n, dtype=np.int64)
    stored = np.zeros(n, dtype=bool)
    val = np.zeros(n, dtype=np.int64)
    # precedence must mirror DeviceFM.get_sampled_sa / FMIndex semantics:
    # firstISA first, then row-sampled, then selected/end-marker rows
    if idx.has_end_marker and idx.end_marker_sa is not None:
        m = len(idx.end_marker_sa)
        stored[:m] = True
        val[:m] = idx.end_marker_sa
    if idx.selected_rows is not None and len(idx.selected_rows):
        stored[idx.selected_rows] = True
        val[idx.selected_rows] = idx.selected_vals
    samp = rows % idx.sample_rate == 0
    stored[samp] = True
    val[samp] = idx.sampled_sa[rows[samp] // idx.sample_rate]
    stored[idx.first_isa] = True
    val[idx.first_isa] = idx.adjusted_sa0
    s_rows = np.flatnonzero(stored)
    s_pos = sa[s_rows]
    order = np.argsort(s_pos)
    s_pos = s_pos[order]
    s_val = val[s_rows][order]
    k = np.searchsorted(s_pos, sa, side="right") - 1
    return s_val[k].astype(np.int32)


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
        self.bwt = st["bwt"].copy()
        self.sampled = st["sampled"].copy()
        self.ftab_len = st["ftab_len"].copy()
        self.ftab_start = st["ftab_start"].copy()
        self.ftab_seen = st["ftab_seen"].copy()
        self.first_isa = int(st["first_isa"])
        self.sel_rows = [st["sel_rows"]] if len(st["sel_rows"]) else []
        self.sel_vals_pos = [st["sel_vals_pos"]] if len(st["sel_vals_pos"]) else []
        self.end_marker_sa = st["end_marker_sa"].copy()


def build_fm_streaming(codes, genome_lens, genome_seqids, alphabet, params,
                       dcv=4096, bmax=1 << 24, threads=1, build_mem=0,
                       checkpoint_prefix=None, log=None):
    """Memory-bounded FM construction over the chunked external SA
    (fm/sa_external.py). Honors --bmax/--dcv/--build-mem/-t with
    ~10%-granularity checkpoint/resume; output identical to build_fm."""
    from .sa_external import ChunkedSA

    log = log or (lambda m: None)
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    sigma = len(alphabet)
    pw = params.precompute_width

    if build_mem:
        # peak ~= codes + bwt + DC ranks + ftab tables + threads * chunk bufs
        r = 2
        while r * r < dcv:
            r += 1
        dc_bytes = (n // (r * r) + 1) * (2 * r - 1) * 8
        ftab_bytes = 3 * (1 << (log2ceil(sigma) * pw)) * 8
        fixed = 2 * n + dc_bytes + ftab_bytes + (256 << 20)
        usable = build_mem - fixed
        if usable < (1 << 22) * threads * 24:
            # dc_bytes ~ (2r-1)/r^2 per char, so a LARGER --dcv shrinks the
            # difference-cover sample footprint
            raise MemoryError(
                "--build-mem %d too small: fixed state needs ~%d bytes; "
                "increase the budget or increase --dcv" % (build_mem, fixed))
        bmax = min(bmax, usable // (threads * 24))
        log("build-mem %d: using bmax=%d (fixed state ~%d)"
            % (build_mem, bmax, fixed))

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
    # rowmap accelerator: the chunk pass visits SA rows in order, so the full
    # SA can be captured on the fly when the +12 bytes/char fits the budget
    want_rowmap = bool(getattr(params, "row_map", False)) and n < (1 << 31)
    if want_rowmap and build_mem and (build_mem - 2 * n - (256 << 20)) < 12 * n:
        log("note: --row-map skipped: the full SA capture (~%d bytes) does "
            "not fit --build-mem" % (12 * n))
        want_rowmap = False
    start_chunk = 0
    st_path = (checkpoint_prefix + "_checkpoint_state.npz") \
        if checkpoint_prefix else None
    if st_path and os.path.exists(st_path):
        z = np.load(st_path, allow_pickle=False)
        # digest guard: same-length-but-different input must NOT resume from
        # stale accumulated BWT state (mirrors the SA-IS checkpoint guard)
        if int(z["n"]) == n and ("digest" not in z.files
                                 or str(z["digest"]) == cs.digest):
            acc.load_state(z)
            start_chunk = int(z["next_chunk"])
            log("resuming build at chunk %d" % start_chunk)
        else:
            log("checkpoint state does not match input; starting fresh")
    if want_rowmap and start_chunk > 0:
        log("note: --row-map skipped on checkpoint resume (earlier SA chunks "
            "were not captured)")
        want_rowmap = False
    sa_full = np.empty(n, np.int64) if want_rowmap else None

    done = 0
    last_ckpt = start_chunk
    for ci, row0, part in cs.iter_chunks(start_chunk):
        acc.add(row0, part)
        if sa_full is not None:
            sa_full[row0:row0 + len(part)] = part
        done = ci + 1
        if st_path and cs.n_chunks >= 10 and \
                (done - last_ckpt) >= max(cs.n_chunks // 10, 1):
            st = acc.state()
            np.savez(st_path + ".tmp.npz", n=n, next_chunk=done,
                     digest=cs.digest, **st)
            os.replace(st_path + ".tmp.npz", st_path)
            last_ckpt = done
            log("checkpoint at chunk %d/%d" % (done, cs.n_chunks))
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

    counts = np.bincount(acc.bwt, minlength=sigma)
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
    idx.bwt = RunBlockSeq.from_codes(acc.bwt, sigma, b=params.rbbwt_b)
    if sa_full is not None:
        idx.rowmap = compute_rowmap(idx, sa_full)
    return idx
