# Port copy of centrifuger_tpu.cli.inspect_cli (host code, no accelerator).
"""cfr-inspect: index inspection CLI (flag-compatible with centrifuger-inspect,
reference CentrifugerInspect.cpp:10-23). Output formats mirror the reference's
--summary / --conversion-table / --taxonomy-tree / --name-table / --size-table /
--index-size reports (CentrifugerInspect.cpp:92-150)."""

import argparse
import sys

from ..build import load_index_tax_only
from ..taxonomy import rank_string


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cfr-inspect-torch")
    ap.add_argument("-x", dest="index", required=True)
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--conversion-table", action="store_true")
    ap.add_argument("--taxonomy-tree", action="store_true")
    ap.add_argument("--name-table", action="store_true")
    ap.add_argument("--size-table", action="store_true")
    ap.add_argument("--index-size", action="store_true")
    args = ap.parse_args(argv)

    tax, seq_length = load_index_tax_only(args.index)
    out = sys.stdout

    if args.summary:
        for sid in sorted(seq_length):
            ctid = tax.seq_id_to_tax_id(sid)
            out.write("%s\t%d\t%d\t%s\n" % (
                tax.seq_id_to_name(sid), tax.orig_tax_id(ctid),
                seq_length[sid], tax.tax_name(ctid)))
    elif args.conversion_table:
        for sid in range(tax.seq_cnt + tax.extra_seq_cnt):
            out.write("%s\t%d\n" % (tax.seq_id_to_name(sid),
                                    tax.orig_tax_id(tax.seq_id_to_tax_id(sid))))
    elif args.taxonomy_tree:
        for i in range(tax.node_cnt):
            out.write("%d\t|\t%d\t|\t%s\t|\n" % (
                tax.orig_tax_id(i), tax.orig_tax_id(int(tax.parent[i])),
                rank_string(tax.tax_rank(i))))
    elif args.name_table:
        for i in range(tax.node_cnt):
            out.write("%d\t|\t%s\t|\tscientific name\t|\n" % (
                tax.orig_tax_id(i), tax.tax_name(i)))
    elif args.size_table:
        tl = tax.seq_length_to_tax_length(seq_length)
        for i in range(tax.node_cnt):
            if tl[i] == 0:
                continue
            out.write("%d\t%d\n" % (tax.orig_tax_id(i), tl[i]))
    elif args.index_size:
        from ..fm.index import FMIndexData
        fm = FMIndexData.load(args.index + ".fm.npz")
        sys.stderr.write("FM-index space usage (bytes):\n")
        sys.stderr.write("BWT: %d\n" % fm.bwt.nbytes())
        sys.stderr.write("sampledSA: %d\n" % fm.sampled_sa.nbytes)
        sys.stderr.write("precomputedRange: %d\n" %
                         (fm.ftab_start.nbytes + fm.ftab_len.nbytes))
    else:
        sys.stderr.write("Use one of --summary/--conversion-table/--taxonomy-tree/"
                         "--name-table/--size-table/--index-size\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
