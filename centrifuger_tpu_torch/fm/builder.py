# Port copy of centrifuger_tpu.fm.builder (host code, no accelerator).
"""Offline FM-index construction from compacted genome codes (the whole-text
SA-IS path; the memory-bounded streaming builder is not ported yet).

Mirrors the semantics of FMBuilder::Build + Builder::TransformSampledSAToSeqId
(reference compactds/FMBuilder.hpp:444-811, Builder.hpp:27-71): suffix array →
sentinel-free BWT with firstISA, row-sampled SA, ftab (precomputedRange),
selected genome-boundary rows, protein end markers — then every stored SA value
is replaced by the sequence id of the genome containing it (with the
ftab-width fuzzy boundary shift).
"""

import numpy as np

from .index import FMIndexData
from .runblock import RunBlockSeq
from .suffix_array import suffix_array, bwt_from_sa
from ..utils import log2ceil


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
