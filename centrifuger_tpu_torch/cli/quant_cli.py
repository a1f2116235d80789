# Port copy of centrifuger_tpu.cli.quant_cli (host code, no accelerator).
"""cfr-quant: abundance quantification CLI (flag-compatible with
centrifuger-quant, reference CentrifugerQuant.cpp:9-23)."""

import argparse
import sys

from ..quant.quantifier import Quantifier


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cfr-quant-torch")
    ap.add_argument("-x", dest="index")
    ap.add_argument("-c", dest="classification", required=True)
    ap.add_argument("--taxonomy-tree")
    ap.add_argument("--name-table")
    ap.add_argument("--size-table")
    ap.add_argument("--min-score", type=int, default=0)
    ap.add_argument("--min-length", type=int, default=0)
    ap.add_argument("--output-format", type=int, default=0)
    args = ap.parse_args(argv)

    if args.index is None and (args.taxonomy_tree is None or args.name_table is None):
        sys.stderr.write("Need -x or --taxonomy-tree/--name-table.\n")
        return 1

    q = Quantifier()
    if args.index:
        q.init_from_index(args.index)
    else:
        q.init_from_dumps(args.taxonomy_tree, args.name_table, args.size_table)
    q.load_read_assignments(args.classification, args.min_score, args.min_length)
    q.quantification()
    q.output(sys.stdout, args.output_format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
