"""The fused classification program on the card (nucleotide and protein).

Port of centrifuger_tpu.classify.device_engine.fused_classify: per batch of
Q read units (nr mates each) the device runs

  chain_search    K1 + K4: decode the 2-bit reads into fwd / rc strand lanes
                  and find each lane's semi-maximal exact-match chains
                  (protein: chain_search_lanes takes six amino-acid code
                  lanes a read, which translate_lanes, K13, builds on the
                  card from the mates' bytes)
  finalize_units  K3 (+ K2 inline): strand choice (protein: frame choice
                  first), row expansion, SA resolve, merge chains, record
                  scores, best seqids, flags

and packs the result rows plus the first FB_CAP flagged units' chains into
one flat int32 `host_blob`, the layout centrifuger_tpu ships to its host
finish stage.  On a sharded index (parallel/sharded.py, kernel K10) each
device that holds shards runs both kernels on its share of the units.  The
chains are in the index type: on an int64 index each
(sp, ep, l, off) of the blob is two int32 words, lo then hi, where the JAX
program casts them to int32 (device_engine.py:463-465) and wraps sp and ep
from n = 2^31 on.  Each kernel has a plain PyTorch twin here with the same
signature; the wrappers take the twin only for CPU tensors.

Semantics are value-identical to the JAX program and therefore to the host
engine (classify/engine_np.py): the tests hold every output array to it.
"""

import torch

from .. import kernels
from .translate import TABLE_BYTES, TABLE_FWD, TABLE_REV
from ..fm.device import (chain_search_lanes, chain_search_lanes_plain, chain_variant,
                         resolve_rows_plain, _check)

FLAG_ADJUST = 1        # both strands hit somewhere -> boundary-adjustment path
FLAG_ROW_OVERFLOW = 2  # unit's expanded SA rows exceed the row budget
FB_CAP = 64            # flagged units whose chains ship with the main result
U_CAP = 8              # per-unit SA-row budget W (finalize_units.cu: W)
ADJ = 15               # _scoreHitLenAdjust for nucleotide hits
ADJ_PROTEIN = 5        # ... and for amino-acid hits
I32_MAX = 2**31 - 1


# ------------------------------------------------------ K4: read decode

def _rc_lanes(code, lengths):
    """code [U, L] (255 invalid) -> (code, reverse-complement code)."""
    U, L = code.shape
    idxr = lengths.long()[:, None] - 1 - torch.arange(L, device=code.device)[None, :]
    g = code.gather(1, idxr.clamp(0, L - 1))
    rc = torch.where((idxr >= 0) & (g != 255), 3 - g, torch.full_like(g, 255))
    return code, rc


def decode_packed_dna(pack2, vmask, lengths):
    """2-bit-packed reads -> (codes_fwd, codes_rc) int64 [U, L], 255 invalid.
    pack2 [U, L/4] uint8 (4 codes per byte, little-endian), vmask [U, L/8]
    uint8 (validity bit per base, little-endian)."""
    U, L4 = pack2.shape
    L = 4 * L4
    j = torch.arange(L, device=pack2.device)[None, :]
    w = pack2.long().repeat_interleave(4, dim=1)
    code = (w >> ((j & 3) * 2)) & 3
    v = (vmask.long().repeat_interleave(8, dim=1) >> (j & 7)) & 1
    code = torch.where((v == 1) & (j < lengths.long()[:, None]), code,
                       torch.full_like(code, 255))
    return _rc_lanes(code, lengths)


# ------------------------------------------ K13: six-frame translation

# codes a chunk of translate_lanes_plain builds, each strand: its int32
# offsets stay some tens of MB whatever the mates' lengths
PLAIN_CHUNK = 1 << 22


def translate_lanes_plain(flat, starts, L, table):
    """Plain twin of translate_lanes: each byte's forward and reverse class
    looked up once, then each codon's three classes gathered by int32
    offsets, PLAIN_CHUNK codes a strand at a time."""
    dev = flat.device
    R = starts.shape[0] - 1
    b = torch.cat([flat.int(), flat.new_zeros(1).int()])    # a last byte for lanes' ends
    pad = flat.shape[0]
    fwd, rev = (table.index_select(0, b + at) for at in (TABLE_FWD, TABLE_REV))
    n = starts[1:] - starts[:-1]
    frame = torch.arange(3, dtype=torch.int32, device=dev)
    m = torch.div((n[:, None] - frame).clamp(min=0), 3, rounding_mode="floor").clamp(max=L)
    col = torch.arange(L, dtype=torch.int32, device=dev)
    first = frame[:, None] + 3 * col                        # [3, L]: codon col of frame f
    codes = torch.empty(R, 2, 3, L, dtype=torch.uint8, device=dev)
    step = max(1, PLAIN_CHUNK // (3 * L))
    for r0 in range(0, R, step):
        st, nn = starts[:-1][r0:r0 + step, None, None], n[r0:r0 + step, None, None]
        valid = col < m[r0:r0 + step, :, None]              # [r, 3, L]
        # forward: bytes f + 3 col + (0, 1, 2); the reverse complement reads
        # them from the mate's end, n - 1 - that
        for strand, (cls, p0, sign) in enumerate(((fwd, st + first, 1),
                                                  (rev, st + nn - 1 - first, -1))):
            key = torch.zeros(valid.shape, dtype=torch.int32, device=dev)
            for k, w in enumerate((25, 5, 1)):
                idx = torch.where(valid, p0 + sign * k, pad).reshape(-1)
                key += w * cls.index_select(0, idx).view(valid.shape)
            code = table.index_select(0, key.reshape(-1)).view(valid.shape)
            codes[r0:r0 + step, strand] = code.masked_fill_(~valid, 255)
    return codes.reshape(6 * R, L), m.repeat(1, 2).reshape(-1)


def translate_lanes(flat, starts, L, table):
    """K13 wrapper: flat uint8 [N] (R mates' bytes joined), starts int32
    [R + 1] (mate r is flat[starts[r]:starts[r + 1]]), table uint8
    [TABLE_BYTES] (translate.frame_table) -> (codes uint8 [6R, L], lengths
    int32 [6R]): per mate the forward frames 0..2, then frames 0..2 of its
    reverse complement, each its whole codons, cut at L, 255 past the end
    (translate.translate_frames' rules; the lanes fused_classify_protein
    takes)."""
    for name, t, dtype in (("flat", flat, torch.uint8), ("starts", starts, torch.int32),
                           ("table", table, torch.uint8)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise TypeError("translate_lanes: %s must be a contiguous 1-D %s tensor"
                            % (name, dtype))
        if t.device != flat.device:
            raise ValueError("translate_lanes: %s is on %s, flat on %s"
                             % (name, t.device, flat.device))
    if starts.shape[0] < 1 or table.shape[0] != TABLE_BYTES or L <= 0 or L % 4:
        raise ValueError("translate_lanes: want starts [R + 1], table [%d] and L a "
                         "positive multiple of 4" % TABLE_BYTES)
    if flat.device.type == "cpu":
        return translate_lanes_plain(flat, starts, L, table)
    R = starts.shape[0] - 1
    codes = torch.empty(6 * R, L, dtype=torch.uint8, device=flat.device)
    lengths = torch.empty(6 * R, dtype=torch.int32, device=flat.device)
    if R:
        kernels.launch_raw("translate_frames", flat.device, flat, starts, table, R, L,
                           codes, lengths)
    return codes, lengths


# ---------------------------------------------------- K1 + K4: chains

def chain_search_plain(fm, pack2, vmask, lengths, mhl, H):
    """Plain twin of chain_search: decode, interleave (lane 2u = fwd,
    2u + 1 = rc), then the K1 state machine per lane."""
    cf, cr = decode_packed_dna(pack2, vmask, lengths)
    U, L = cf.shape
    codes = torch.stack([cf, cr], dim=1).reshape(2 * U, L)
    return chain_search_lanes_plain(fm, codes, lengths.repeat_interleave(2),
                                    mhl, H)


def chain_search(fm, pack2, vmask, lengths, mhl, H):
    """K1 + K4 wrapper: pack2 uint8 [U, L/4], vmask uint8 [U, L/8], lengths
    int32 [U] -> (hits [2U, H, 4] of (sp, ep, l, off) in the index type,
    nhits int32 [2U])."""
    _check(fm, "chain_search", pack2=(pack2, torch.uint8),
           vmask=(vmask, torch.uint8), lengths=(lengths, torch.int32))
    U, L4 = pack2.shape
    if vmask.shape != (U, L4 // 2) or L4 % 2 or lengths.shape != (U,):
        raise ValueError("chain_search: want pack2 [U, L/4], vmask [U, L/8], "
                         "lengths [U] with L % 8 == 0")
    if pack2.device.type == "cpu":
        return chain_search_plain(fm, pack2, vmask, lengths, mhl, H)
    hits = torch.empty(2 * U, H, 4, dtype=fm.idtype, device=pack2.device)
    nhits = torch.empty(2 * U, dtype=torch.int32, device=pack2.device)
    if U:
        kernels.launch("chain_search", fm, pack2, vmask, lengths, U, 4 * L4,
                       mhl, H, hits, nhits, variant=chain_variant(fm, lanes=False))
    return hits, nhits


# ------------------------------------------------------ K3: finalize

def _shift_right(x, s, fill):
    """[Q, W] -> x shifted right by s columns, filled with `fill`."""
    return torch.cat([torch.full_like(x[:, :s], fill), x[:, :x.shape[1] - s]], 1)


def _seg_cumsum(vals, boundary):
    """Inclusive segmented cumsum along dim 1; boundary starts a segment."""
    v, f = vals, boundary
    s = 1
    while s < vals.shape[1]:
        v = torch.where(f, v, _shift_right(v, s, 0) + v)
        f = f | _shift_right(f, s, True)
        s *= 2
    return v


def _changed(a):
    """[Q, W] -> column differs from its left neighbour (column 0 = True)."""
    return torch.cat([torch.ones_like(a[:, :1], dtype=torch.bool),
                      a[:, 1:] != a[:, :-1]], 1)


def _sort_rows(keys):
    """Lexicographic sort along dim 1 by the key tensors (primary first)."""
    perm = torch.arange(keys[0].shape[1], device=keys[0].device).expand_as(keys[0])
    for k in reversed(keys):
        order = torch.sort(k.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    return [k.gather(1, perm) for k in keys]


def finalize_units_plain(fm, hits, nhits, nr, mhl, max_entries, k_out,
                         protein=False):
    """Plain twin of finalize_units: device_engine.fused_classify's finalize
    (:211-461) as batched tensor code.  -> packed int32 [Q, 5 + k_out]."""
    dev = hits.device
    hits = hits.long()
    nhits = nhits.long()
    H = hits.shape[1]
    lpu = (6 if protein else 2) * nr
    Q = hits.shape[0] // lpu
    W = U_CAP
    adj = ADJ_PROTEIN if protein else ADJ
    rowQ = torch.arange(Q, device=dev)
    hmask = torch.arange(H, device=dev)[None, :] < nhits[:, None]
    hl = hits[:, :, 2]
    lane_score = torch.where(hmask & (hl >= mhl), (hl - adj) ** 2, 0).sum(1)

    if protein:
        # frame choice per (read, strand): the largest nhits * score, strictly
        # (the best starts at 0; ties keep the earlier frame)
        qscore = nhits * lane_score

        def chosen(lane0):
            best = qscore[lane0].clamp(min=0)
            tag = torch.zeros_like(lane0)
            for fr in (1, 2):
                upd = qscore[lane0 + fr] > best
                tag = torch.where(upd, fr, tag)
                best = torch.where(upd, qscore[lane0 + fr], best)
            return lane0 + tag

        f1, r1 = chosen(lpu * rowQ), chosen(lpu * rowQ + 3)
        if nr == 2:
            f2, r2 = chosen(lpu * rowQ + 6), chosen(lpu * rowQ + 9)
        needs_adjust = torch.zeros(Q, dtype=torch.bool, device=dev)
    else:
        f1, r1 = lpu * rowQ, lpu * rowQ + 1
        if nr == 2:
            f2, r2 = f1 + 2, f1 + 3
            needs_adjust = ((nhits[f1] > 0) & (nhits[r1] > 0)) | \
                ((nhits[f2] > 0) & (nhits[r2] > 0))
        else:
            needs_adjust = (nhits[f1] > 0) & (nhits[r1] > 0)
    if nr == 2:
        sc_plus = lane_score[f1] + lane_score[r2]
        sc_minus = lane_score[r1] + lane_score[f2]
    else:
        sc_plus, sc_minus = lane_score[f1], lane_score[r1]
    tp, tm = sc_plus >= sc_minus, sc_minus >= sc_plus
    neg = torch.full_like(f1, -1)
    if nr == 2:
        slot_lane = torch.stack([torch.where(tp, f1, neg), torch.where(tp, r2, neg),
                                 torch.where(tm, r1, neg), torch.where(tm, f2, neg)], 1)
        k_pattern = torch.tensor([1, 1, 0, 0], device=dev)
    else:
        slot_lane = torch.stack([torch.where(tp, f1, neg),
                                 torch.where(tm, r1, neg)], 1)
        k_pattern = torch.tensor([1, 0], device=dev)
    NS = slot_lane.shape[1]
    S = NS * H

    # per-unit hit table [Q, S], slot-major
    lane_safe = slot_lane.clamp(min=0).reshape(-1)
    f_all = hits[lane_safe].reshape(Q, S, 4)
    f_sp, f_ep, f_l, f_off = (f_all[:, :, i] for i in range(4))
    f_n = nhits[lane_safe].reshape(Q, NS, 1).expand(Q, NS, H).reshape(Q, S)
    hit_pos = torch.arange(H, device=dev).repeat(NS)[None, :]
    present = (slot_lane[:, :, None] >= 0).expand(Q, NS, H).reshape(Q, S) & \
        (hit_pos < f_n)
    f_k = k_pattern[None, :, None].expand(Q, NS, H).reshape(Q, S)
    colS = torch.arange(S, device=dev).expand(Q, S)
    prev_idx = _shift_right(
        torch.cummax(torch.where(present, colS, -1), dim=1).values, 1, -1)
    has_prev = present & (prev_idx >= 0)
    prev_safe = prev_idx.clamp(min=0)

    # row expansion with striding (Classifier.hpp:606-652)
    me = max_entries
    rng = f_ep - f_sp + 1
    simple = rng <= me
    step = torch.div(rng + me - 1, me, rounding_mode="floor").clamp(min=1)
    cnt_fwd = torch.div(rng + step - 1, step, rounding_mode="floor")
    cnt_bwd = torch.minimum(torch.div(f_ep - f_sp, step, rounding_mode="floor") + 1,
                            (me - cnt_fwd).clamp(min=1))
    counts = torch.where(present, torch.where(simple, rng, cnt_fwd + cnt_bwd), 0)
    wcum = counts.cumsum(1)
    unit_total = wcum[:, -1]
    overflow = unit_total > W
    starts_in = wcum - counts
    colW = torch.arange(W, device=dev).expand(Q, W)
    row_valid = colW < unit_total.clamp(max=W)[:, None]
    hit_of_row = (wcum[:, None, :] <= colW[:, :, None]).sum(2).clamp(max=S - 1)

    def at_row(x):
        return x.gather(1, hit_of_row)
    pos = colW - at_row(starts_in)
    r_sp, r_ep, r_step, r_cf = at_row(f_sp), at_row(f_ep), at_row(step), at_row(cnt_fwd)
    rows = torch.where(at_row(simple), r_sp + pos,
                       torch.where(pos < r_cf, r_sp + pos * r_step,
                                   r_ep - (pos - r_cf) * r_step))
    rows = torch.where(row_valid, rows, 0)
    seqids = resolve_rows_plain(fm, rows.reshape(-1), row_valid.reshape(-1)) \
        .long().reshape(Q, W)

    # merge-chain ids over hits (Classifier.hpp:659-671)
    sid_uniq = seqids.gather(1, starts_in.clamp(0, W - 1))
    uniq_hit = present & (rng == 1)

    def at_prev(x):
        return x.gather(1, prev_safe)
    mix = (has_prev & (f_k != at_prev(f_k))).any(1)
    merge_prev = (has_prev & ~mix[:, None] & uniq_hit & at_prev(uniq_hit)
                  & (f_k == at_prev(f_k))
                  & (at_prev(f_off) + at_prev(f_l) + 1 == f_off)
                  & (sid_uniq == at_prev(sid_uniq)))
    chain_of_hit = (present & ~merge_prev).long().cumsum(1)

    # per-unit sort of the expanded rows by (k, sid, hit)
    key_a = torch.where(row_valid, at_row(f_k), I32_MAX)
    key_b = torch.where(row_valid, seqids, I32_MAX)
    key_c = torch.where(row_valid, hit_of_row, I32_MAX)
    key_a, key_b, key_c = _sort_rows([key_a, key_b, key_c])
    s_valid = key_a != I32_MAX
    s_hit = key_c.clamp(max=S - 1)
    s_l = f_l.gather(1, s_hit)
    s_chain = chain_of_hit.gather(1, s_hit)
    ch_a, ch_b, ch_c = _changed(key_a), _changed(key_b), _changed(key_c)
    pair_first = (ch_a | ch_b | ch_c) & s_valid
    cb = (ch_a | ch_b | _changed(s_chain)) & s_valid
    rb = (ch_a | ch_b) & s_valid

    # chain sums -> chain scores -> record score / hitlen
    w_l = torch.where(pair_first, s_l, 0)
    one = torch.ones_like(s_valid[:, :1])
    last_of_chain = torch.cat([cb[:, 1:] | ~s_valid[:, 1:], one], 1) & s_valid
    chain_lsum = _seg_cumsum(w_l, cb | ~s_valid)
    chain_score = torch.where(last_of_chain & (chain_lsum >= mhl),
                              (chain_lsum - adj) ** 2, 0)
    last_of_rec = torch.cat([rb[:, 1:] | ~s_valid[:, 1:], one], 1) & s_valid
    rec_score = torch.where(last_of_rec, _seg_cumsum(chain_score, rb | ~s_valid), -1)
    rec_hitlen = _seg_cumsum(w_l, rb | ~s_valid)

    # best / second / hitlen
    unit_best = rec_score.max(1).values
    qual = last_of_rec & (rec_score == unit_best[:, None])
    unit_nbest = qual.long().sum(1)
    first_best = qual & (qual.long().cumsum(1) == 1)
    hitlen_out = torch.where(first_best, rec_hitlen, 0).max(1).values
    unit_rest = torch.where(last_of_rec & (rec_score < unit_best[:, None]),
                            rec_score, 0).max(1).values
    score_out = unit_best.clamp(min=0)
    second_out = torch.where(unit_nbest >= 2, score_out, unit_rest.clamp(min=0))

    # best seqids: dedup by sid (first k wins), ordered by (k, sid)
    d_b, d_c = _sort_rows([torch.where(qual, key_b, I32_MAX),
                           torch.where(qual, key_a & 1, I32_MAX)])
    d_valid = d_b != I32_MAX
    dup = d_valid & ~_changed(d_b)
    keep = d_valid & ~dup
    e_b, e_c = _sort_rows([torch.where(keep, d_c, I32_MAX),
                           torch.where(keep, d_b, I32_MAX)])
    kw = min(k_out, W)
    sids_out = torch.zeros(Q, k_out, dtype=torch.long, device=dev)
    sids_out[:, :kw] = torch.where(e_b[:, :kw] != I32_MAX, e_c[:, :kw], 0)
    flags = needs_adjust.long() * FLAG_ADJUST | overflow.long() * FLAG_ROW_OVERFLOW
    return torch.cat([score_out[:, None], second_out[:, None], hitlen_out[:, None],
                      (unit_nbest - dup.long().sum(1))[:, None], flags[:, None],
                      sids_out], 1).int()


def finalize_units(fm, hits, nhits, nr, mhl, max_entries, k_out, protein=False):
    """K3 wrapper: hits [lpu Q, H, 4] in the index type, nhits int32 [lpu Q]
    with lpu = 2 nr strand lanes a unit (protein: 6 nr frame lanes) -> packed
    int32 [Q, 5 + k_out]."""
    _check(fm, "finalize_units", hits=(hits, fm.idtype), nhits=(nhits, torch.int32))
    B, H, four = hits.shape
    lpu = (6 if protein else 2) * nr
    if four != 4 or nhits.shape != (B,) or B % lpu:
        raise ValueError("finalize_units: want hits [%d Q, H, 4], nhits [%d Q]"
                         % (lpu, lpu))
    if hits.device.type == "cpu":
        return finalize_units_plain(fm, hits, nhits, nr, mhl, max_entries, k_out,
                                    protein)
    Q = B // lpu
    packed = torch.empty(Q, 5 + k_out, dtype=torch.int32, device=hits.device)
    if Q:
        kernels.launch("finalize_units", fm, hits, nhits, Q, nr, H, mhl,
                       max_entries, k_out, int(protein), packed,
                       variant=("protein",) * protein)
    return packed


# ------------------------------------------------------------ the program

def fused_classify(fm, pack2, vmask, lengths, nr, mhl, H, max_result,
                   hitk_factor, k_out, r_cap):
    """The nucleotide device program (device_engine.fused_classify).
    pack2/vmask/lengths: U = Q * nr packed reads.  Returns a dict of tensors:
    packed [Q, 5 + k_out] (score, second, hitlen, n_best, flags, sids...),
    hits [2U, H, 4] (index type), nhits [2U], fb_units, fb_hits, fb_nh and
    host_blob (int32)."""
    _check_row_budget(pack2.shape[0] // nr, r_cap)
    return _run_program(fm, chain_search, (pack2, vmask, lengths), nr, mhl, H,
                        max_result * hitk_factor, k_out, protein=False)


def fused_classify_protein(fm, codes, lengths, nr, mhl, H, max_result,
                           hitk_factor, k_out, r_cap):
    """The protein device program (device_engine.fused_classify with
    protein=True).  codes uint8 [6U, L] amino-acid code lanes (255 invalid),
    per read fwd frames 0..2 then rc frames 0..2, lengths int32 [6U], U =
    Q * nr.  Returns the tensors of fused_classify, with hits [6U, H, 4]."""
    _check_row_budget(codes.shape[0] // (6 * nr), r_cap)
    return _run_program(fm, chain_search_lanes, (codes, lengths), nr, mhl, H,
                        max_result * hitk_factor, k_out, protein=True)


def _check_row_budget(Q, r_cap):
    if r_cap // Q != U_CAP:
        raise ValueError("the per-unit row budget r_cap // Q must be %d" % U_CAP)


def _run_program(fm, chains, reads, nr, mhl, H, max_entries, k_out, protein):
    """chains(fm, *reads, mhl, H), finalize_units on its chains, and the
    outputs packed.  On a ShardedIndex whose shards span several devices each
    device runs the two kernels on its share of whole units (nr reads a unit,
    6 nr code lanes on the protein path) and the outputs are gathered on the
    first (fm.over_devices)."""
    def program(view, *rd):
        hits, nhits = chains(view, *rd, mhl, H)
        return finalize_units(view, hits, nhits, nr, mhl, max_entries, k_out,
                              protein), hits, nhits
    packed, hits, nhits = fm.over_devices(program, (6 if protein else 1) * nr, *reads)
    return pack_results(packed, hits, nhits, (6 if protein else 2) * nr)


def pack_results(packed, hits, nhits, lpu):
    """The program's outputs around packed [Q, 5 + k_out]: the first FB_CAP
    flagged units' chains (fb_units, fb_hits, fb_nh; lpu lanes a unit) and the
    one int32 host_blob of packed + fb_units + fb_hits + fb_nh.  The
    selection is data movement (nonzero / gather), not a kernel."""
    k_out = packed.shape[1] - 5
    Q = len(packed)
    fb_mask = (packed[:, 4] != 0) | (packed[:, 3] > k_out)
    nfb = min(Q, FB_CAP)
    fb_units = torch.full((nfb,), -1, dtype=torch.int32, device=hits.device)
    sel = fb_mask.nonzero()[:nfb, 0]
    fb_units[:len(sel)] = sel.int()
    fb_lanes = (lpu * fb_units.clamp(min=0).long()[:, None]
                + torch.arange(lpu, device=hits.device)[None, :]).reshape(-1)
    fb_hits = hits[fb_lanes]
    fb_nh = nhits[fb_lanes]
    # int64 chains as (lo, hi) int32 words: the blob keeps every bit
    host_blob = torch.cat([packed.reshape(-1), fb_units,
                           fb_hits.reshape(-1).view(torch.int32), fb_nh])
    return dict(packed=packed, hits=hits, nhits=nhits, fb_units=fb_units,
                fb_hits=fb_hits, fb_nh=fb_nh, host_blob=host_blob)
