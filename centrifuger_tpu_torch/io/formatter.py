# Port copy of centrifuger_tpu.io.formatter (host code, no accelerator).
"""--read-format parsing and segment extraction.

Mirrors ReadFormatter (reference ReadFormatter.hpp): specs like
`r1:0:-1,r2:0:-1,bc:0:15,um:16:-1`, segment strand `-` reverse(-complement),
and comment-field specs `bc:hd:<field-or-prefix>:<start>:<end>[:strand]`
(ReadFormatter.hpp:49-139, Extract :288-405).
"""

_CATEGORIES = {"r1": 0, "r2": 1, "bc": 2, "um": 3}
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _comp_char(c):
    return _COMP.get(c, "N")


class _Seg:
    __slots__ = ("start", "end", "strand", "in_comment", "field", "field_prefix")

    def __init__(self):
        self.start = 0
        self.end = -1
        self.strand = 1
        self.in_comment = False
        self.field = 0
        self.field_prefix = None


class ReadFormatter:
    def __init__(self, format_str=None):
        self.segs = {k: [] for k in _CATEGORIES}
        if format_str:
            self.init(format_str)

    def init(self, format_str):
        for spec in format_str.replace(";", ",").split(","):
            if not spec:
                continue
            self._parse_one(spec)

    def _parse_one(self, s):
        if len(s) < 3 or s[2] != ":":
            raise ValueError("Format description error in %s" % s)
        cat = s[:2]
        if cat not in _CATEGORIES:
            raise ValueError("Format description error in %s" % s)
        seg = _Seg()
        rest = s[3:]
        if rest.startswith("hd:"):
            seg.in_comment = True
            rest = rest[3:]
            fld, _, rest = rest.partition(":")
            if fld.isdigit():
                seg.field = int(fld)
                seg.field_prefix = None
            else:
                seg.field = -1
                seg.field_prefix = fld
        parts = rest.split(":")
        if len(parts) < 2 or len(parts) > 3:
            raise ValueError("Format description error in %s" % s)
        seg.start = int(parts[0])
        seg.end = int(parts[1])
        if len(parts) == 3:
            seg.strand = 1 if parts[2].startswith("+") else -1
        self.segs[cat].append(seg)

    def segment_count(self, cat):
        return len(self.segs[cat])

    def is_in_comment(self, cat):
        return bool(self.segs[cat]) and self.segs[cat][0].in_comment

    def need_extract(self, cat):
        segs = self.segs[cat]
        if not segs:
            return False
        if len(segs) == 1:
            s = segs[0]
            if s.start == 0 and s.end == -1 and s.strand == 1 and not s.in_comment:
                return False
        return True

    def extract(self, seq, cat, need_complement):
        """Returns extracted string (ReadFormatter::Extract)."""
        if seq is None:
            return ""
        if not self.need_extract(cat):
            return seq
        length = len(seq)
        out = []
        strand = 1
        for seg in self.segs[cat]:
            start, end = seg.start, seg.end
            lenk = length
            if self.is_in_comment(cat):
                fstart, fend = self._find_field(seq, seg, length)
                if start >= 0:
                    start += fstart
                if end >= 0:
                    end += fstart
                lenk = fend + 1
            if start < 0:
                start = lenk + start
            if end >= lenk:
                end = lenk - 1
            elif end < 0:
                end = lenk + end
            if end >= start:
                out.append(seq[start:end + 1])
            if seg.strand == -1:
                strand = -1
        buf = "".join(out)
        if strand == -1:
            buf = buf[::-1]
            if need_complement:
                buf = "".join(_comp_char(c) for c in buf)
        return buf

    def _find_field(self, seq, seg, length):
        if seg.field >= 0:
            # whitespace-separated field seg.field (1-based-ish: field f starts
            # after the f-th separator; ReadFormatter.hpp:335-354)
            f = 0
            fstart = 0
            fend = 0
            for j in range(length + 1):
                ch = seq[j] if j < length else "\0"
                if ch in (" ", "\t", "\0"):
                    f += 1
                    if f == seg.field:
                        fstart = j + 1
                    elif f == seg.field + 1:
                        fend = j - 1
                        break
            if f <= seg.field:  # field not found
                fstart = length
                fend = length - 1
            return fstart, fend
        p = seq.find(seg.field_prefix)
        if p >= 0:
            fstart = p
            q = p
            while q < length and seq[q] not in (" ", "\t"):
                q += 1
            return fstart, q - 1
        return length, length - 1

    def extract_seq_qual(self, seq, qual, cat):
        """(new_seq, new_qual); qual is reversed but not complemented on minus
        strand (InplaceExtractSeqAndQual, ReadFormatter.hpp:408-422)."""
        ns = self.extract(seq, cat, True)
        nq = self.extract(qual, cat, False) if qual is not None else None
        return ns, nq

    def extract_from_comment(self, comment, cat):
        return self.extract(comment if comment is not None else "", cat, True)
