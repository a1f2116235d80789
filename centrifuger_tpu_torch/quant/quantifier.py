# Port copy of centrifuger_tpu.quant.quantifier (host code, no accelerator).
"""Abundance quantification: EM over read assignments on the covered taxonomy
subtree.

Literal-value port of Quantifier (reference Quantifier.hpp): TSV parsing and
read grouping (:515-622), assignment coalescing (:490-513), covered-subtree
construction (:648-694), genome-length baselines (:697-705), EM with tree
up-propagation and parent-excess redistribution (:123-281), and the four output
formats (:746-818).  Floating-point operation order is preserved so outputs
diff clean against the reference binary.
"""

import gzip
import math
import sys

import numpy as np

from ..taxonomy import Taxonomy, rank_string
from ..taxonomy.taxonomy import CANONICAL_RANKS
from .tree import TreePlain, convert_taxonomy_to_tree

FORMAT_CENTRIFUGER = 0
FORMAT_METAPHLAN = 1
FORMAT_CAMI = 2
FORMAT_KREPORT = 3


class _ColumnarFallback(Exception):
    """Input the vectorized TSV parser cannot handle exactly (ragged rows,
    non-digit numeric fields, pathological read ids) — row loop instead."""


class _Assignment:
    __slots__ = ("targets", "weight", "count", "uniq_count")

    def __init__(self):
        self.targets = []
        self.weight = 0.0
        self.count = 0.0
        self.uniq_count = 0.0

    def key(self):
        return (len(self.targets), tuple(self.targets))


def _assignment_weight(score, hit_length, read_length):
    """CalculateAssignmentWeight (reference Quantifier.hpp:283-293)."""
    diff = int(read_length) - int(hit_length)
    slack = int(read_length * 0.01)
    if diff < slack:
        return 1.0
    diff -= slack
    if diff > 10:
        diff = 11
    return 1.0 / float(1 << (2 * diff))


class Quantifier:
    def __init__(self):
        self.tax = None
        self.seq_length = {}
        self.taxid_length = None
        self.assignments = []
        self.abund = None
        self.read_count = None
        self.uniq_read_count = None
        self.unclassified_cnt = 0
        self.has_expanded = False

    # ---------------------------------------------------------------- loading

    def init_from_index(self, prefix):
        from ..build import load_index_tax_only
        self.tax, self.seq_length = load_index_tax_only(prefix)
        self._alloc()
        self.taxid_length = self.tax.seq_length_to_tax_length(self.seq_length)

    def init_from_dumps(self, nodes_file, names_file, size_table=None):
        self.tax = Taxonomy.from_dumps(nodes_file, names_file, None,
                                       presence_from_nodes=True)
        self._alloc()
        self.taxid_length = np.zeros(self.tax.node_cnt + 1, dtype=np.int64)
        if size_table:
            with open(size_table) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 2:
                        continue
                    ct = self.tax.compact_tax_id(int(parts[0]))
                    if ct <= self.tax.node_cnt:
                        self.taxid_length[ct] = int(parts[1])
            self.tax.infer_all_tax_length(self.taxid_length, False)
        else:
            self.taxid_length[:self.tax.node_cnt] = 1000000

    def _alloc(self):
        n = self.tax.node_cnt + 1
        self.abund = np.zeros(n)
        self.read_count = np.zeros(n)
        self.uniq_read_count = np.zeros(n)

    def load_read_assignments(self, path, min_score=0, min_hit_length=0):
        """LoadReadAssignments (reference Quantifier.hpp:515-622).

        Native fast path: one C++ pass over the file bytes
        (native/tsvquant.cpp) does field split, the reference's
        filter/grouping semantics, CalculateAssignmentWeight
        (Quantifier.hpp:283-293) and per-target-tuple coalescing with
        input-order double accumulation — the float addition sequence is
        identical to the reference's sort-and-merge, so EM output stays
        byte-identical; a 10M-line TSV ingests in seconds.  stdin and input
        the native pass cannot read exactly (ragged rows, non-numeric
        fields) take the row-by-row Python loop; a missing toolchain
        raises."""
        if path != "-":
            try:
                return self._load_read_assignments_native(
                    path, min_score, min_hit_length)
            except _ColumnarFallback:
                pass
        return self._load_read_assignments_lines(path, min_score,
                                                 min_hit_length)

    def _load_read_assignments_native(self, path, min_score, min_hit_length):
        import ctypes
        from ..native import load
        lib = load("tsvquant")
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        if not getattr(lib, "_tsq_configured", False):
            lib.tsq_parse.argtypes = [u8p, ctypes.c_int64, i64p, i64p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64]
            lib.tsq_parse.restype = ctypes.c_void_p
            lib.tsq_sizes.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
            lib.tsq_export.argtypes = [ctypes.c_void_p, i64p, i64p, f64p,
                                       f64p, f64p]
            lib.tsq_destroy.argtypes = [ctypes.c_void_p]
            lib._tsq_configured = True
        if _is_gz(path):
            with gzip.open(path, "rb") as f:
                data = f.read()
        else:
            with open(path, "rb") as f:
                data = f.read()
        buf = np.frombuffer(bytearray(data), np.uint8)
        m = self.tax._orig_to_compact
        keys = np.fromiter(m.keys(), np.int64, len(m))
        vals = np.fromiter(m.values(), np.int64, len(m))
        order = np.argsort(keys, kind="stable")
        keys = np.ascontiguousarray(keys[order])
        vals = np.ascontiguousarray(vals[order])
        h = lib.tsq_parse(
            buf.ctypes.data_as(u8p), len(buf),
            keys.ctypes.data_as(i64p), vals.ctypes.data_as(i64p),
            len(keys), int(self.tax.node_cnt),
            int(min_score), int(min_hit_length))
        if not h:
            raise _ColumnarFallback
        try:
            n = ctypes.c_int64()
            tot = ctypes.c_int64()
            uncls = ctypes.c_int64()
            lib.tsq_sizes(h, ctypes.byref(n), ctypes.byref(tot),
                          ctypes.byref(uncls))
            n_, tot_ = n.value, tot.value
            tlen = np.zeros(n_, np.int64)
            tflat = np.zeros(max(tot_, 1), np.int64)
            w = np.zeros(n_, np.float64)
            c = np.zeros(n_, np.float64)
            u = np.zeros(n_, np.float64)
            if n_:
                lib.tsq_export(h, tlen.ctypes.data_as(i64p),
                               tflat.ctypes.data_as(i64p),
                               w.ctypes.data_as(f64p),
                               c.ctypes.data_as(f64p),
                               u.ctypes.data_as(f64p))
        finally:
            lib.tsq_destroy(h)
        self.unclassified_cnt = int(uncls.value)
        out = []
        off = 0
        for i in range(n_):
            a = _Assignment()
            ln = int(tlen[i])
            a.targets = [int(x) for x in tflat[off:off + ln]]
            off += ln
            a.weight = float(w[i])
            a.count = float(c[i])
            a.uniq_count = float(u[i])
            out.append(a)
        self.assignments = out

    def _load_read_assignments_lines(self, path, min_score=0,
                                     min_hit_length=0):
        """Row-by-row fallback (stdin / ragged input): streaming dict-based
        coalescing with the same float addition sequence."""
        self.assignments = []
        self.unclassified_cnt = 0
        if path == "-":
            f = sys.stdin
        elif _is_gz(path):
            f = gzip.open(path, "rt")
        else:
            f = open(path)
        compact = self.tax.compact_tax_id
        groups = {}      # tuple(targets) -> [weight, count, uniq_count]
        prev_read_id = None
        cur_targets = None
        cur_w = cur_u = 0.0

        def flush():
            key = tuple(cur_targets)
            g = groups.get(key)
            if g is None:
                groups[key] = [cur_w, 1.0, cur_u]
            else:
                g[0] += cur_w
                g[1] += 1.0
                g[2] += cur_u

        first = True
        for line in f:
            if first:
                first = False
                continue
            cols = line.split("\t", 7)
            if len(cols) < 7:
                continue
            taxid = int(cols[2])
            score = int(cols[3])
            hit_length = int(cols[5])
            if hit_length < min_hit_length or score < min_score or taxid == 0:
                self.unclassified_cnt += 1
                continue
            read_id = cols[0]
            if read_id != prev_read_id:
                if cur_targets:
                    flush()
                cur_targets = []
                cur_w = _assignment_weight(score, hit_length, int(cols[6]))
                cur_u = 1.0 if score > int(cols[4]) else 0.0
                prev_read_id = read_id
            cur_targets.append(compact(taxid))
        if cur_targets:
            flush()
        if f is not sys.stdin:
            f.close()
        for key in sorted(groups, key=lambda k: (len(k), k)):
            w, c, u = groups[key]
            a = _Assignment()
            a.targets = list(key)
            a.weight = w
            a.count = c
            a.uniq_count = u
            self.assignments.append(a)

    def add_read_assignment(self, result):
        """AddReadAssignment from an in-process ClassifierResult."""
        a = _Assignment()
        a.targets = [self.tax.compact_tax_id(t) for t in result.tax_ids]
        a.weight = _assignment_weight(result.score, result.hit_length,
                                      result.query_length)
        a.count = 1.0
        a.uniq_count = 1.0 if result.score > result.secondary_score else 0.0
        self.assignments.append(a)

    def coalesce_assignments(self):
        if not self.assignments:
            return 0
        self.assignments.sort(key=lambda a: a.key())
        out = [self.assignments[0]]
        for a in self.assignments[1:]:
            if a.key() == out[-1].key():
                out[-1].weight += a.weight
                out[-1].count += a.count
                out[-1].uniq_count += a.uniq_count
            else:
                out.append(a)
        self.assignments = out
        return len(out)

    # --------------------------------------------------------------------- EM

    def _generate_tree_abundance(self, tag, abund, tree):
        """GenerateTreeAbundance (reference Quantifier.hpp:123-133), iterative
        post-order with the reference's child order."""
        stack = [(tag, False)]
        while stack:
            node, processed = stack.pop()
            if processed:
                s = abund[node]
                for c in tree.get_children(node):
                    s += abund[c]
                abund[node] = s
            else:
                stack.append((node, True))
                for c in reversed(tree.get_children(node)):
                    stack.append((c, False))
        return abund[tag]

    def _redistribute(self, tag, abund, tree, taxid_len, edge_weight):
        """RedistributeAbundToChildren (reference Quantifier.hpp:136-182)."""
        stack = [tag]
        while stack:
            node = stack.pop()
            children = tree.get_children(node)
            if not children:
                continue
            children_sum = 0.0
            for c in children:
                children_sum += abund[c]
            excess = abund[node] - children_sum
            if excess < 0:
                excess = 0.0
            if children_sum == 0:
                continue
            expanded_sum = 0.0
            if edge_weight is not None:
                for c in children:
                    expanded_sum += edge_weight[c]
            csize = len(children)
            weighted = 0.0
            for c in children:
                ln = taxid_len[c] if taxid_len is not None else 1
                weighted += abund[c] / ln * (
                    (excess - expanded_sum) / csize +
                    (0.0 if expanded_sum == 0 else edge_weight[c] / expanded_sum))
            if weighted == 0:
                weighted = 1.0
            for c in children:
                ln = taxid_len[c] if taxid_len is not None else 1
                abund[c] += excess * (
                    abund[c] / ln * ((excess - expanded_sum) / csize +
                                     (0.0 if expanded_sum == 0 else
                                      edge_weight[c] / expanded_sum))) / weighted
                stack.append(c)

    def _em_update(self, abund0, abund1, read_count, coo, tree,
                   taxid_len, edge_weight):
        """EMupdate (reference Quantifier.hpp:186-234).  The E-step runs as
        COO segment sums (np.add.at applies updates in element order, so the
        per-target float addition sequence is identical to the reference's
        per-assignment loops)."""
        tree_size = tree.size()
        aidx, tgt, w_rep, n_assign = coo
        read_count[:] = 0.0
        av = abund0[tgt]
        s = np.zeros(n_assign)
        np.add.at(s, aidx, av)
        np.add.at(read_count, tgt, w_rep * av / s[aidx])
        total = 0.0
        for i in range(tree_size):
            total += read_count[i] / float(taxid_len[i])
        for i in range(tree_size):
            abund1[i] = read_count[i] / float(taxid_len[i]) / total
        self._generate_tree_abundance(0, abund1, tree)
        self._redistribute(0, abund1, tree, None, edge_weight)
        diff = 0.0
        for i in range(tree_size):
            diff += abs(abund0[i] - abund1[i])
        return diff

    def _estimate_em(self, assignments, tree, taxid_len, edge_weight,
                     read_count, abund):
        """EstimateAbundanceWithEM (reference Quantifier.hpp:236-281)."""
        # (assignment, target) COO arrays shared by every EM iteration
        tcounts = np.fromiter((len(a.targets) for a in assignments),
                              np.int64, len(assignments))
        aidx = np.repeat(np.arange(len(assignments), dtype=np.int64), tcounts)
        tgt = np.fromiter((t for a in assignments for t in a.targets),
                          np.int64, int(tcounts.sum()))
        weights = np.fromiter((a.weight for a in assignments),
                              np.float64, len(assignments))
        coo = (aidx, tgt, weights[aidx], len(assignments))
        np.add.at(read_count, tgt, (weights / tcounts)[aidx])
        self._generate_tree_abundance(tree.root, read_count, tree)
        self._redistribute(tree.root, read_count, tree, taxid_len, edge_weight)
        tree_size = tree.size()
        factor = read_count[tree.root]
        for i in range(tree_size):
            abund[i] = read_count[i] / factor
        next_abund = np.zeros(tree_size)
        for _ in range(1000):
            delta = self._em_update(abund, next_abund, read_count, coo,
                                    tree, taxid_len, edge_weight)
            abund[:tree_size] = next_abund
            if delta < 1e-6 and delta < 0.1 / float(tree_size):
                break
        self._generate_tree_abundance(0, read_count, tree)
        self._redistribute(tree.root, read_count, tree, taxid_len, edge_weight)

    def quantification(self):
        """Quantification (reference Quantifier.hpp:640-743)."""
        self.coalesce_assignments()
        tax = self.tax
        all_tree = convert_taxonomy_to_tree(tax)

        covered = {}     # MapID: compact tid -> subtree id (insertion order)
        covered_list = []

        def covered_add(t):
            if t in covered:
                return covered[t]
            nid = len(covered_list)
            covered[t] = nid
            covered_list.append(t)
            return nid

        subtree_size = 1
        covered_add(all_tree.root)
        sub_assignments = []
        for a in self.assignments:
            targets = list(a.targets)
            sa = _Assignment()
            sa.weight = a.weight
            sa.count = a.count
            sa.uniq_count = a.uniq_count
            sa.targets = targets[:]
            for j, ctid in enumerate(targets):
                if ctid == tax.node_cnt:
                    sa.targets[j] = 0
                    self.read_count[all_tree.root] += a.count / len(targets)
                    self.uniq_read_count[all_tree.root] += a.uniq_count
                    continue
                self.read_count[ctid] += a.count / len(targets)
                self.uniq_read_count[ctid] += a.uniq_count
                p = ctid
                while covered_add(p) == subtree_size:
                    subtree_size += 1
                    p = int(tax.parent[p])
                sa.targets[j] = covered[ctid]
            sub_assignments.append(sa)
        self._generate_tree_abundance(all_tree.root, self.read_count, all_tree)
        self._generate_tree_abundance(all_tree.root, self.uniq_read_count, all_tree)

        subtree = TreePlain(root=0)
        subtree.init(subtree_size)
        for i in range(1, subtree_size):
            subtree.add_edge(i, covered[int(tax.parent[covered_list[i]])])

        sub_len = np.zeros(subtree_size, dtype=np.int64)
        for i in range(all_tree.size()):
            if i in covered:
                sub_len[covered[i]] = self.taxid_length[i] + \
                    self.taxid_length[tax.root_ctax] // 10

        sub_abund = np.zeros(subtree_size)
        sub_read_count = np.zeros(subtree_size)
        self._estimate_em(sub_assignments, subtree, sub_len, None,
                          sub_read_count, sub_abund)
        for i in range(subtree_size):
            self.abund[covered_list[i]] = sub_abund[i]

    # ----------------------------------------------------------------- output

    def _lineage_string(self, ctid, style, use_name, canonical_only):
        """GetTaxLineagePathString (reference Quantifier.hpp:300-350)."""
        path = list(reversed(self.tax.lineage_path(ctid)))
        parts = []
        n = len(path)
        for i, t in enumerate(path):
            if canonical_only and not self.tax.is_canonical(t):
                continue
            piece = ""
            if style == FORMAT_METAPHLAN and use_name:
                if self.tax.is_canonical(t):
                    rs = rank_string(self.tax.tax_rank(t))
                    ch = "d" if rs in ("superkingdom", "acellular root") else rs[0]
                    piece += ch + "__"
                else:
                    piece += "__"
            piece += (self.tax.tax_name(t) if use_name
                      else str(self.tax.orig_tax_id(t)))
            parts.append((i, piece))
        out = ""
        for k, (i, piece) in enumerate(parts):
            out += piece
            if i < n - 1:
                out += "|"
        return out

    def output(self, fp, fmt):
        """Output (reference Quantifier.hpp:746-818)."""
        tax = self.tax
        n = tax.node_cnt
        if fmt == FORMAT_METAPHLAN:
            fp.write("#clade_name\tNCBI_tax_id\trelative_abundance\tadditional_species\n")
            for i in range(n):
                if self.read_count[i] < 1e-6 or not tax.is_canonical(i):
                    continue
                idpath = self._lineage_string(i, fmt, False, True)
                namepath = self._lineage_string(i, fmt, True, True)
                fp.write("%s\t%s\t%.5f\t\n" % (namepath, idpath, self.abund[i] * 100.0))
        elif fmt == FORMAT_CAMI:
            fp.write("@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE\n")
            for i in range(n):
                if self.read_count[i] < 1e-6 or not tax.is_canonical(i):
                    continue
                idpath = self._lineage_string(i, fmt, False, True)
                namepath = self._lineage_string(i, fmt, True, True)
                fp.write("%d\t%s\t%s\t%s\t%.5f\n" % (
                    tax.orig_tax_id(i), rank_string(tax.tax_rank(i)),
                    idpath, namepath, self.abund[i] * 100.0))
        elif fmt == FORMAT_KREPORT:
            tree = convert_taxonomy_to_tree(tax)
            self._kreport_dfs(tree, tree.root, 0, 0, "", fp)
        else:
            fp.write("name\ttaxID\ttaxRank\tgenomeSize\tnumReads\tnumUniqueReads\tabundance\n")
            for i in range(n):
                if self.read_count[i] < 1e-6:
                    continue
                fp.write("%s\t%d\t%s\t%d\t%d\t%d\t%.7f\n" % (
                    tax.tax_name(i), tax.orig_tax_id(i),
                    rank_string(tax.tax_rank(i)), self.taxid_length[i],
                    int(self.read_count[i] + 1e-3),
                    int(self.uniq_read_count[i] + 1e-3), self.abund[i]))

    def _kreport_dfs(self, tree, ctid, depth, dist, prev_symbol, fp):
        """OutputKreportDFS (reference Quantifier.hpp:353-399)."""
        tax = self.tax
        if self.read_count[ctid] < 1e-6:
            return
        rs = rank_string(tax.tax_rank(ctid))
        if tax.is_canonical(ctid) and rs != "strain":
            r = "D" if rs in ("superkingdom", "acellular root") else rs[0].upper()
            dist = 0
        else:
            if prev_symbol == "":
                r = "R"
            else:
                r = "%s%d" % (prev_symbol, dist)
        children = tree.get_children(ctid)
        children_count = 0.0
        for c in children:
            children_count += self.read_count[c]
        fp.write("%.2f\t%.0f\t%.0f\t%s\t%d\t" % (
            self.abund[ctid] * 100, self.read_count[ctid],
            self.read_count[ctid] - children_count, r, tax.orig_tax_id(ctid)))
        fp.write("  " * depth)
        fp.write("%s\n" % tax.tax_name(ctid))
        for c in children:
            self._kreport_dfs(tree, c, depth + 1, dist + 1, r[0], fp)


def _is_gz(path):
    try:
        with open(path, "rb") as f:
            return f.read(2) == b"\x1f\x8b"
    except OSError:
        return False
