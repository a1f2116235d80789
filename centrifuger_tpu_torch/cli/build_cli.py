# Port copy of centrifuger_tpu.cli.build_cli (host code, no accelerator).
"""cfr-build: index construction CLI (flag-compatible with centrifuger-build,
reference CentrifugerBuild.cpp:8-51)."""

import argparse
import sys

from ..build import build_index
from ..fm.builder import FMBuildParams
from ..utils import space_string_to_bytes


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="cfr-build-torch", description="Build a centrifuger_tpu index.")
    ap.add_argument("-r", action="append", default=[], dest="ref",
                    help="reference sequence file (repeatable)")
    ap.add_argument("-l", dest="file_list", help="list of reference files, one per row")
    ap.add_argument("-o", dest="output", default="centrifuger", help="output prefix")
    ap.add_argument("-t", dest="threads", type=int, default=1)
    ap.add_argument("--taxonomy-tree", required=True)
    ap.add_argument("--name-table", required=True)
    ap.add_argument("--conversion-table")
    ap.add_argument("--build-mem", default=None)
    ap.add_argument("--bmax", type=int, default=None,
                    help="max suffixes per build chunk (default 2^24; "
                         "setting it selects the memory-bounded builder)")
    ap.add_argument("--dcv", type=int, default=None,
                    help="difference-cover period (default 4096; rounded up "
                         "to a perfect square)")
    ap.add_argument("--offrate", type=int, default=4,
                    help="SA sampled every 2^<int> BWT chars")
    ap.add_argument("--ftabchars", type=int, default=10)
    ap.add_argument("--rbbwt-b", type=int, default=0)
    ap.add_argument("--subset-tax", type=int, default=0)
    ap.add_argument("--concat-tax-genome", action="store_true")
    ap.add_argument("--ignore-uncategorized-genome", action="store_true")
    ap.add_argument("--checkpoint", action="store_true")
    ap.add_argument("--protein", action="store_true")
    ap.add_argument("--no-row-map", action="store_true",
                    help="skip the per-row LF-walk serving accelerator "
                         "(4 bytes/char; auto-enabled up to $CFR_ROWMAP_MAX)")
    ap.add_argument("--emit-cfr", action="store_true",
                    help="additionally write <prefix>.{1,2,3,4}.cfr in the "
                         "reference centrifuger on-disk format (loadable by "
                         "the reference binary; nucleotide indexes only)")
    args = ap.parse_args(argv)

    genome_files = list(args.ref)
    conversion_at_file_level = False
    conversion_table = args.conversion_table
    if args.file_list:
        ncols = 0
        with open(args.file_list) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                genome_files.append(parts[0])
                if ncols == 0:
                    ncols = len(parts)
        if conversion_table is None:
            if ncols < 2:
                sys.stderr.write("Need two-column -l file or --conversion-table.\n")
                return 1
            conversion_table = args.file_list
            conversion_at_file_level = True
    elif conversion_table is None:
        sys.stderr.write("Need --conversion-table (or two-column -l).\n")
        return 1

    params = FMBuildParams(sample_rate=1 << args.offrate,
                           precompute_width=args.ftabchars,
                           rbbwt_b=args.rbbwt_b)
    build_mem = space_string_to_bytes(args.build_mem) if args.build_mem else 0
    fm, tax, seq_length = build_index(
        genome_files, args.taxonomy_tree, args.name_table,
        conversion_table, conversion_at_file_level, args.output,
        concat_same_taxid=args.concat_tax_genome,
        ignore_uncategorized=args.ignore_uncategorized_genome,
        subset_tax=args.subset_tax, params=params, protein=args.protein,
        checkpoint=args.checkpoint, build_mem=build_mem,
        bmax=args.bmax, dcv=args.dcv, threads=args.threads,
        row_map=False if args.no_row_map else None)
    if args.emit_cfr:
        if args.protein:
            sys.stderr.write("--emit-cfr: protein (one-tree) layout not "
                             "supported; skipping .cfr emission.\n")
            return 1
        from ..interop.cfr_write import save_cfr_index
        save_cfr_index(fm, tax, seq_length, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
