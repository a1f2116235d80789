# Port copy of centrifuger_tpu.io.pairmerge (host code, no accelerator).
"""Paired-read overlap merging / adapter trimming.

Mirrors ReadPairMerger (reference ReadPairMerger.hpp): read-through detection
(rc-of-r2 leading into r1), simple overlap with similarity thresholds 0.85-0.95
(:26-30), unique-offset requirement, tandem-repeat ambiguity rejection (:57-79),
and quality-aware consensus merge (:132-233)."""

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _revcomp(s):
    return "".join(_COMP.get(c, "N") for c in reversed(s))


def _is_mate_overlap(fr, sr, min_overlap, check_tandem):
    """Returns (overlap_size, offset, best_match_cnt); overlap_size -1 on failure.
    (IsMateOverlap, ReadPairMerger.hpp:13-82)"""
    flen = len(fr)
    slen = len(sr)
    offset_cnt = 0
    overlap_size = -1
    offset = -1
    best_match_cnt = -1
    for j in range(0, flen - min_overlap):
        match_cnt = 0
        flag = True
        t = flen - j
        if t >= 100:
            thr = 0.85
        elif t >= 50:
            thr = 0.85 + (t - 50) / 50.0 * 0.1
        else:
            thr = 0.95
        need = int(t * thr)
        k = 0
        while j + k < flen and k < slen:
            if fr[j + k] == sr[k]:
                match_cnt += 1
            if match_cnt + (flen - (j + k) - 1) < need:
                flag = False
                break
            k += 1
        if flag:
            offset = j
            offset_cnt += 1
            overlap_size = k
            best_match_cnt = match_cnt
    if offset_cnt != 1:
        return -1, offset, best_match_cnt
    if check_tandem and overlap_size <= min_overlap * 2:
        for i in range(1, overlap_size // 2 + 1):
            tandem = True
            j = i
            while j + i - 1 < overlap_size:
                ok = all(sr[k - j] == sr[k] for k in range(j, j + i))
                if not ok:
                    tandem = False
                    break
                j += i
            if tandem:
                return -1, offset, best_match_cnt
    return overlap_size, offset, best_match_cnt


class ReadPairMerger:
    def merge(self, r1, q1, r2, q2):
        """Returns (merged_seq, merged_qual, code): 0 no merge, 1 overlap merge,
        2 read-through."""
        if r2 is None:
            return None, None, 0
        len1 = len(r1)
        len2 = len(r2)
        rcr2 = _revcomp(r2)
        rcq2 = q2[::-1] if q2 is not None else None

        min_overlap = min((len1 + len2) // 10, 31)

        # read-through: rc(r2) leads into r1
        ov, off, _ = _is_mate_overlap(rcr2, r1, min_overlap, check_tandem=False)
        if ov >= 0:
            rm = list(r1[:ov])
            qm = list(q1[:ov]) if q1 is not None else None
            if q1 is not None:
                for i in range(ov):
                    if rcq2[i + off] > q1[i] or rm[i] == "N":
                        rm[i] = rcr2[i + off]
                        qm[i] = rcq2[i + off]
            return "".join(rm), ("".join(qm) if qm is not None else None), 2

        # simple overlap
        ov, off, _ = _is_mate_overlap(r1, rcr2, min_overlap, check_tandem=True)
        if ov >= 0:
            total = off + len2
            rm = [""] * total
            qm = [""] * total if rcq2 is not None else None
            for i in range(len2):
                rm[off + i] = rcr2[i]
                if qm is not None:
                    qm[off + i] = rcq2[i]
            for i in range(min(len1, total)):
                take_r1 = (i < off or rm[i] == "N"
                           or (q1 is not None and qm is not None
                               and ord(q1[i]) >= ord(qm[i]) - 14))
                if take_r1:
                    rm[i] = r1[i]
                    if q1 is not None and qm is not None:
                        qm[i] = q1[i]
            return "".join(rm), ("".join(qm) if qm is not None else None), 1
        return None, None, 0
