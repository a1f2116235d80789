# Port copy of centrifuger_tpu.io.barcode (host code, no accelerator).
"""Barcode whitelist correction and translation.

BarcodeCorrector mirrors reference BarcodeCorrector.hpp: whitelist frequency
table seeded from the first 2M barcodes (:150-163), 1-Hamming correction
choosing the highest observed count, ties broken by lowest base quality
(:166-232).  BarcodeTranslator mirrors BarcodeTranslator.hpp: `to<sep>from`
table, combinatorial barcodes joined with '-' (:57-84).
"""

import gzip
import sys


def _open_text(path):
    f = open(path, "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        import io
        return io.TextIOWrapper(io.BufferedReader(gzip.GzipFile(fileobj=f)))
    import io
    return io.TextIOWrapper(f)


class BarcodeCorrector:
    def __init__(self, whitelist_path=None):
        self.freq = {}
        if whitelist_path:
            self.set_whitelist(whitelist_path)

    def set_whitelist(self, path):
        with _open_text(path) as f:
            for line in f:
                bc = line.rstrip("\n")
                if bc:
                    self.freq[bc] = 1

    @property
    def whitelist_size(self):
        return len(self.freq)

    def collect_background(self, barcode_file, formatter, case_cnt=2000000):
        cnt = 0
        for read in barcode_file:
            bc = read.seq
            if formatter is not None and formatter.segment_count("bc"):
                bc, _ = formatter.extract_seq_qual(read.seq, read.qual, "bc")
            if bc in self.freq:
                self.freq[bc] += 1
            cnt += 1
            if cnt >= case_cnt:
                break

    def correct(self, barcode, qual):
        """Returns (corrected_barcode, code): -1 uncorrectable, 0 exact, 1 corrected."""
        if barcode in self.freq:
            return barcode, 0
        records = []  # (pos, base_idx, count)
        test = "ACGT"
        blist = list(barcode)
        for i, orig in enumerate(blist):
            for j, ch in enumerate(test):
                if ch == orig:
                    continue
                blist[i] = ch
                cand = "".join(blist)
                blist[i] = orig
                cnt = self.freq.get(cand, -1)
                if cnt != -1:
                    records.append((i, j, cnt))
        if not records:
            return barcode, -1
        best_cnt = -1
        best_tag = -1
        best_low_qual = 255
        for t, (pos, bi, cnt) in enumerate(records):
            if cnt > best_cnt:
                best_cnt = cnt
                best_tag = t
                if qual is not None:
                    best_low_qual = ord(qual[pos])
            elif cnt == best_cnt:
                if qual is not None and ord(qual[pos]) < best_low_qual:
                    best_low_qual = ord(qual[pos])
                    best_tag = t
        pos, bi, _ = records[best_tag]
        blist[pos] = test[bi]
        return "".join(blist), 1


class BarcodeTranslator:
    def __init__(self, table_path=None):
        self.table = None
        self.from_len = -1
        if table_path:
            self.set_translate_table(table_path)

    def set_translate_table(self, path):
        self.table = {}
        with _open_text(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                i = 0
                while i < len(line) and line[i] not in ",\t ":
                    i += 1
                to = line[:i]
                frm = line[i + 1:]
                self.from_len = len(frm)
                self.table[frm] = to

    @property
    def is_set(self):
        return self.table is not None

    def translate(self, bc):
        if self.table is None:
            return bc
        parts = []
        for i in range(len(bc) // self.from_len):
            frm = bc[i * self.from_len:(i + 1) * self.from_len]
            if frm not in self.table:
                sys.stderr.write("Barcode %s does not exist in the translation table.\n" % frm)
                sys.exit(255)
            parts.append(self.table[frm])
        return "-".join(parts)
