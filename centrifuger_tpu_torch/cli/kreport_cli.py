# Port copy of centrifuger_tpu.cli.kreport_cli (host code, no accelerator).
"""cfr-kreport: Kraken-style report from classification output.

Python port of the reference's perl `centrifuger-kreport` (behavior-identical
output: same printf formats, same LCA/no-lca accounting, children sorted by
descending clade count)."""

import argparse
import sys

from ..build import load_index_tax_only


def build_maps(tax):
    parent_map = {}
    rank_map = {}
    name_map = {}
    child_lists = {}
    for i in range(tax.node_cnt):
        tid = tax.orig_tax_id(i)
        pid = tax.orig_tax_id(int(tax.parent[i]))
        if tid == 1:
            pid = 0
        parent_map[tid] = pid
        from ..taxonomy import rank_string
        rank_map[tid] = rank_string(tax.tax_rank(i))
        name_map[tid] = tax.tax_name(i)
        child_lists.setdefault(pid, []).append(tid)
    return parent_map, rank_map, name_map, child_lists


def rank_code(rank):
    return {"species": "S", "genus": "G", "family": "F", "order": "O",
            "class": "C", "phylum": "P", "kingdom": "K",
            "superkingdom": "D", "domain": "D", "acellular root": "D"}.get(rank, "-")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cfr-kreport-torch")
    ap.add_argument("-x", dest="index", required=True)
    ap.add_argument("--no-lca", action="store_true")
    ap.add_argument("--show-zeros", action="store_true")
    ap.add_argument("--is-count-table", action="store_true")
    ap.add_argument("--min-score", type=int, default=None)
    ap.add_argument("--min-length", type=int, default=None)
    ap.add_argument("--report-score-data", action="store_true")
    ap.add_argument("files", nargs="*")
    args = ap.parse_args(argv)

    tax, _ = load_index_tax_only(args.index)
    parent_map, rank_map, name_map, child_lists = build_maps(tax)

    def in_tree(t):
        while t > 1:
            if t not in parent_map:
                sys.stderr.write("Couldn't find parent of taxID %d - directly "
                                 "assigned to root.\n" % t)
                return False
            if t == parent_map[t]:
                break
            t = parent_map[t]
        return True

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
            if a not in parent_map:
                sys.stderr.write("Couldn't find parent of taxID %d - directly "
                                 "assigned to root.\n" % a)
                break
            if a == parent_map[a]:
                break
            a = parent_map[a]
        while b > 1:
            if b in path:
                return b
            if b not in parent_map:
                sys.stderr.write("Couldn't find parent of taxID %d - directly "
                                 "assigned to root.\n" % b)
                break
            if b == parent_map[b]:
                break
            b = parent_map[b]
        return 1

    taxo_counts = {0: 0.0}
    taxo_scores = {0: 0}
    seq_count = 0.0

    import fileinput
    lines = fileinput.input(args.files) if args.files else sys.stdin

    if args.is_count_table:
        for line in lines:
            parts = line.split()
            if len(parts) < 2:
                continue
            tid, cnt = int(parts[0]), float(parts[1])
            taxo_counts[tid] = cnt
            seq_count += cnt
    else:
        it = iter(lines)
        header = next(it).rstrip("\n").split("\t")
        hm = {c: i for i, c in enumerate(header)}
        for line in it:
            cols = line.rstrip("\n").split("\t")
            tid = int(cols[hm["taxID"]])
            score = int(cols[hm["score"]])
            hitlen = int(cols[hm["hitLength"]])
            nmatch = int(cols[hm["numMatches"]])
            if args.min_length is not None and hitlen < args.min_length:
                continue
            if args.min_score is not None and score < args.min_score:
                continue
            if not in_tree(tid):
                tid = 1
            if args.no_lca:
                taxo_counts[tid] = taxo_counts.get(tid, 0) + 1.0 / nmatch
                seq_count += 1.0 / nmatch
            else:
                if nmatch > 1:
                    for _ in range(1, nmatch):
                        l2 = next(it)
                        tid = lca(tid, int(l2.rstrip("\n").split("\t")[hm["taxID"]]))
                taxo_counts[tid] = taxo_counts.get(tid, 0) + 1
                if args.report_score_data:
                    if tid not in taxo_scores or score > taxo_scores[tid]:
                        taxo_scores[tid] = score
                seq_count += 1

    classified = seq_count - taxo_counts.get(0, 0)
    clade_counts = dict(taxo_counts)
    clade_scores = dict(taxo_scores)

    def dfs_sum(node):
        for child in child_lists.get(node, []):
            dfs_sum(child)
            clade_counts[node] = clade_counts.get(node, 0) + clade_counts.get(child, 0)
            if args.report_score_data and child in clade_scores:
                if node not in clade_scores or clade_scores[child] > clade_scores[node]:
                    clade_scores[node] = clade_scores[child]

    sys.setrecursionlimit(1000000)
    dfs_sum(1)
    for t in name_map:
        clade_counts.setdefault(t, 0)

    if seq_count <= 0:
        sys.stderr.write("No sequence matches with given settings\n")
        sys.exit(1)

    out = sys.stdout
    extra = "\t0" if args.report_score_data else ""
    out.write("%6.2f\t%d\t%d\t%s\t%d\t%s%s%s\n" % (
        clade_counts.get(0, 0) * 100 / seq_count, clade_counts.get(0, 0),
        taxo_counts.get(0, 0), "U", 0, "unclassified", "", extra))

    def dfs_report(node, depth):
        if not clade_counts.get(node) and not args.show_zeros:
            return
        ex = ("\t%d" % clade_scores.get(node, 0)) if args.report_score_data else ""
        out.write("%6.2f\t%d\t%d\t%s\t%d\t%s%s%s\n" % (
            clade_counts.get(node, 0) * 100 / seq_count,
            clade_counts.get(node, 0), taxo_counts.get(node, 0),
            rank_code(rank_map.get(node, "")), node,
            "  " * depth, name_map.get(node, ""), ex))
        children = child_lists.get(node)
        if children:
            for child in sorted(children, key=lambda c: -clade_counts.get(c, 0)):
                dfs_report(child, depth + 1)

    dfs_report(1, 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
