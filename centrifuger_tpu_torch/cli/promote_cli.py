# Port copy of centrifuger_tpu.cli.promote_cli (host code, no accelerator).
"""cfr-promote: promote classification taxonomy ids to a given rank (or merge
multi-assignments to their LCA).

Python port of the reference's perl `centrifuger-promote` with identical
output (the seqID column of promoted rows keeps the original value; numMatches
rewritten to the deduped row count)."""

import argparse
import sys

from ..build import load_index_tax_only
from ..taxonomy import rank_string


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="cfr-promote-torch",
        usage="cfr-promote-torch <index> <classification.tsv> <level|lca>")
    ap.add_argument("index")
    ap.add_argument("classification")
    ap.add_argument("level")
    args = ap.parse_args(argv)

    tax, _ = load_index_tax_only(args.index)
    tax_parent = {}
    tax_level = {}
    for i in range(tax.node_cnt):
        tid = tax.orig_tax_id(i)
        tax_parent[tid] = tax.orig_tax_id(int(tax.parent[i]))
        tax_level[tid] = rank_string(tax.tax_rank(i))

    level = args.level

    def promote(tid):
        if tid <= 0 or tid not in tax_level:
            return 0
        if tax_level[tid] == level:
            return tid
        if tid <= 1:
            return 0
        return promote(tax_parent[tid])

    def lca(a, b):
        if a == 0:
            return b
        if b == 0:
            return a
        if a == b:
            return a
        path = set()
        while a >= 1:
            path.add(a)
            if a not in tax_parent:
                sys.stderr.write("Couldn't find parent of taxID %d - directly "
                                 "assigned to root.\n" % a)
                break
            if a == tax_parent[a]:
                break
            a = tax_parent[a]
        while b > 1:
            if b in path:
                return b
            if b not in tax_parent:
                sys.stderr.write("Couldn't find parent of taxID %d - directly "
                                 "assigned to root.\n" % b)
                break
            if b == tax_parent[b]:
                break
            b = tax_parent[b]
        return 1

    out = sys.stdout

    def output_group(lines):
        if not lines:
            return
        new_lines = []
        num_matches = 0
        seen = set()
        if level != "lca":
            for line in lines:
                cols = line.split("\t")
                tid = int(cols[2])
                new_tid = promote(tid)
                if new_tid <= 1:
                    new_tid = tid
                new_level = cols[1]
                if new_tid >= 1 and new_tid in tax_level:
                    new_level = tax_level[new_tid]
                if new_tid in seen:
                    continue
                seen.add(new_tid)
                num_matches += 1
                cols[2] = str(new_tid)
                cols[1] = new_level
                new_lines.append("\t".join(cols))
        else:
            num_matches = 1
            t = int(lines[0].split("\t")[2])
            for line in lines[1:]:
                t = lca(t, int(line.split("\t")[2]))
            cols = lines[0].split("\t")
            if t != int(cols[2]):
                cols[1] = tax_level.get(t, cols[1])
            cols[2] = str(t)
            new_lines.append("\t".join(cols))
        for line in new_lines:
            cols = line.split("\t")
            cols[-1] = str(num_matches)
            out.write("\t".join(cols) + "\n")

    with open(args.classification) as f:
        header = f.readline()
        out.write(header)
        prev_read = ""
        group = []
        for line in f:
            line = line.rstrip("\n")
            cols = line.split("\t")
            if cols[0] == prev_read:
                group.append(line)
            else:
                prev_read = cols[0]
                output_group(group)
                group = [line]
        output_group(group)
    return 0


if __name__ == "__main__":
    sys.exit(main())
