# Port copy of centrifuger_tpu.io.writer (host code, no accelerator).
"""Classification TSV + classified/unclassified read dump writer.

Byte-identical output format to ResultWriter (reference ResultWriter.hpp):
header (:186-197), one row per match, unclassified rows (:199-242), optional
barcode/UMI/expanded columns, gzip read dumps (:244-276), sample-sheet
multi-output switching (:75-107), and the final classified-percentage log.
"""

import gzip
import sys

from .readers import SAMPLE_SHEET_SEPARATOR_READ_ID


class ResultWriter:
    def __init__(self, out=None):
        self.fp = out if out is not None else sys.stdout
        self.has_barcode = False
        self.has_umi = False
        self.output_expanded = False
        self.classified_cnt = 0
        self.total_cnt = 0
        self.rows_out = 0   # TSV rows written (multi-rank merge bookkeeping)
        self._un_fps = [None] * 4
        self._cl_fps = [None] * 4
        self.output_unclassified = False
        self.output_classified = False
        self._multi_files = None
        self._multi_idx = 0
        self._multi_seen = {}
        self._owns_fp = False

    def set_multi_output_file_list(self, filenames):
        self._multi_files = list(filenames)
        self.fp = open(self._multi_files[0], "w")
        self._owns_fp = True
        self._multi_idx = 0
        self._multi_seen[self._multi_files[0]] = 1

    def _next_multi_output_file(self):
        if self.fp is not None and self._owns_fp:
            self.fp.close()
            self.fp = None
        self._multi_idx += 1
        if self._multi_idx >= len(self._multi_files):
            return "e"
        name = self._multi_files[self._multi_idx]
        mode = "a" if name in self._multi_seen else "w"
        self.fp = open(name, mode)
        self._owns_fp = True
        if mode == "w":
            self._multi_seen[name] = 1
        return mode

    def set_output_reads(self, prefix, has_mate, has_barcode, has_umi, category):
        fps = self._un_fps if category == 0 else self._cl_fps
        if category == 0:
            self.output_unclassified = True
        else:
            self.output_classified = True
        if has_mate:
            fps[0] = gzip.open("%s_1.fq.gz" % prefix, "wt", compresslevel=1)
            fps[1] = gzip.open("%s_2.fq.gz" % prefix, "wt", compresslevel=1)
        else:
            fps[0] = gzip.open("%s.fq.gz" % prefix, "wt", compresslevel=1)
        if has_barcode:
            fps[2] = gzip.open("%s_bc.fa.gz" % prefix, "wt", compresslevel=1)
        if has_umi:
            fps[3] = gzip.open("%s_um.fa.gz" % prefix, "wt", compresslevel=1)

    def output_header(self):
        self.fp.write("readID\tseqID\ttaxID\tscore\t2ndBestScore\thitLength\tqueryLength\tnumMatches")
        if self.has_barcode:
            self.fp.write("\tbarcode")
        if self.has_umi:
            self.fp.write("\tUMI")
        if self.output_expanded:
            self.fp.write("\texpandedTaxIDs")
        self.fp.write("\n")

    def _extra_col(self, s):
        self.fp.write("\t" if s is None else "\t%s" % s)

    def output(self, read_id, seq1, qual1, seq2, qual2, barcode, umi, result):
        if self._multi_files is not None and read_id == SAMPLE_SHEET_SEPARATOR_READ_ID:
            if self._next_multi_output_file() == "w":
                self.output_header()
            return
        match_cnt = len(result.tax_ids)
        self.total_cnt += 1
        self.rows_out += match_cnt if match_cnt else 1
        if match_cnt > 0:
            self.classified_cnt += 1
            for i in range(match_cnt):
                self.fp.write("%s\t%s\t%d\t%d\t%d\t%d\t%d\t%d" % (
                    read_id, result.seq_names[i], result.tax_ids[i],
                    result.score, result.secondary_score, result.hit_length,
                    result.query_length, match_cnt))
                if self.has_barcode:
                    self._extra_col(barcode)
                if self.has_umi:
                    self._extra_col(umi)
                if self.output_expanded:
                    self._extra_col(result.expanded_strings[i])
                self.fp.write("\n")
        else:
            self.fp.write("%s\tunclassified\t0\t0\t0\t0\t%d\t1" % (
                read_id, result.query_length))
            if self.has_barcode:
                self._extra_col(barcode)
            if self.has_umi:
                self._extra_col(umi)
            if self.output_expanded:
                self._extra_col("")
            self.fp.write("\n")

        for i in range(2):
            if i == 0 and match_cnt == 0 and self.output_unclassified:
                fps = self._un_fps
            elif i == 1 and match_cnt > 0 and self.output_classified:
                fps = self._cl_fps
            else:
                continue
            if qual1 is None:
                fps[0].write(">%s\n%s\n" % (read_id, seq1))
            else:
                fps[0].write("@%s\n%s\n+\n%s\n" % (read_id, seq1, qual1))
            if seq2 is not None:
                if qual2 is None:
                    fps[1].write(">%s\n%s\n" % (read_id, seq2))
                else:
                    fps[1].write("@%s\n%s\n+\n%s\n" % (read_id, seq2, qual2))
            if self.has_barcode:
                fps[2].write(">%s\n%s\n" % (read_id, barcode))
            if self.has_umi:
                fps[3].write(">%s\n%s\n" % (read_id, umi))

    def finalize(self):
        import time
        pct = (self.classified_cnt / self.total_cnt * 100.0) if self.total_cnt else 0.0
        sys.stderr.write("[%s] Processed %d read fragments, and %d (%.2f%%) can be classified.\n" % (
            time.strftime("%a %b %d %H:%M:%S %Y"), self.total_cnt, self.classified_cnt, pct))
        for fps in (self._un_fps, self._cl_fps):
            for f in fps:
                if f is not None:
                    f.close()
        if self._owns_fp and self.fp is not None:
            self.fp.close()
            self.fp = None
