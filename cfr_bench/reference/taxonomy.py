"""The taxonomy the plain reference reports against, read from the dumps.

A frozen copy of the parts of the port's taxonomy module that
classification reads (dump parsing, compact ids, sequence ids, ReduceTaxIds:
reference Centrifuger Taxonomy.hpp:150-352, 733-849), copied and not
imported.  numpy only.
"""

import numpy as np

RANKS = [
    "no rank", "strain", "species", "genus", "family", "order", "class",
    "phylum", "kingdom", "domain", "forma", "infraclass", "infraorder",
    "parvorder", "subclass", "subfamily", "subgenus", "subkingdom", "suborder",
    "subphylum", "subspecies", "subtribe", "superclass", "superfamily",
    "superkingdom", "superorder", "superphylum", "tribe", "varietas", "life",
    "acellular root",
]
_RANK_ID = {r: i for i, r in enumerate(RANKS)}

# rank levels of ReduceTaxIds (Taxonomy::InitTaxRankNum, Taxonomy.hpp:100-144)
_LEVELS = [
    ("subspecies strain", 0), ("species", 1), ("subgenus genus", 2),
    ("subfamily family superfamily", 3),
    ("suborder infraorder parvorder order superorder", 4),
    ("infraclass subclass class superclass", 5),
    ("subphylum phylum superphylum", 6), ("subkingdom kingdom", 7),
    ("superkingdom acellular_root domain", 8),
    ("forma subtribe tribe varietas life no_rank", 9),
]
LEVEL = np.zeros(len(RANKS), np.int64)
for _names, _lv in _LEVELS:
    for _r in _names.split():
        LEVEL[_RANK_ID[_r.replace("_", " ")]] = _lv
UNKNOWN_LEVEL = int(LEVEL[0])


def rank_string(rid):
    return RANKS[rid] if 0 < rid < len(RANKS) else "no rank"


def _tokens_until_bar(toks):
    out = []
    for tk in toks:
        if tk == "|":
            break
        out.append(tk)
    return out


class Taxonomy:
    def __init__(self, nodes_file, names_file, conversion_file):
        present = set()
        with open(conversion_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and line[0] != "#":
                    try:
                        present.add(int(parts[1]))
                    except ValueError:
                        pass
        tree = {}
        with open(nodes_file) as f:
            for line in f:
                if not line.strip() or line[0] == "#":
                    continue
                toks = line.split()
                tid = int(toks[0])
                if tid not in tree:
                    tree[tid] = (int(toks[2]),
                                 _RANK_ID.get(" ".join(_tokens_until_bar(toks[4:])), 0))
        selected = set()
        for tid in present:
            p = tid
            while p in tree and p not in selected:
                selected.add(p)
                p = tree[p][0]
        ids = sorted(t for t in tree if t in selected)
        self.node_cnt = len(ids)
        self.orig_ids = ids
        self.compact = {t: i for i, t in enumerate(ids)}
        self.parent = [self.compact.get(tree[t][0], i) for i, t in enumerate(ids)]
        self.rank = [tree[t][1] for t in ids]
        self.root = next((i for i in range(self.node_cnt) if self.parent[i] == i),
                         self.node_cnt)
        self.seq_names = []
        self.seq_id = {}
        raw = {}
        with open(conversion_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2 or line[0] == "#":
                    continue
                name, tid = parts[0], int(parts[1])
                if name not in self.seq_id:
                    self.seq_id[name] = len(self.seq_names)
                    self.seq_names.append(name)
                    raw[name] = tid
                else:       # a duplicated sequence name takes the LCA (Taxonomy.hpp:330-352)
                    raw[name] = self._lca_orig(self.compact.get(raw[name], self.node_cnt),
                                               self.compact.get(tid, self.node_cnt))
        self.seq_cnt = len(self.seq_names)
        self.seq_tax = [self.compact.get(raw[s], 0) for s in self.seq_names]

    def _path(self, c):
        if c >= self.node_cnt:
            return [self.root]
        path = []
        while True:
            path.append(c)
            c = self.parent[c]
            if c == self.parent[c]:
                return path

    def _lca_orig(self, a, b):
        pa, pb = self._path(a), self._path(b)
        i, j = len(pa) - 1, len(pb) - 1
        while i >= 0 and j >= 0 and pa[i] == pb[j]:
            i -= 1
            j -= 1
        if i == len(pa) - 1 or (i + 1 < len(pa) and j + 1 < len(pb)
                                and pa[i + 1] != pb[j + 1]):
            return self.orig_ids[0]
        return self.orig_ids[pa[i + 1]]

    def add_seq_name(self, name):
        """A FASTA sequence the map lacks gets an id of its own (Builder.hpp:140-150)."""
        if name not in self.seq_id:
            self.seq_id[name] = len(self.seq_names)
            self.seq_names.append(name)
        return self.seq_id[name]

    def seq_tax_id(self, sid):
        return self.seq_tax[sid] if sid < self.seq_cnt else self.node_cnt

    def orig(self, c):
        return self.orig_ids[c] if c < self.node_cnt else self.orig_ids[self.root]

    def tax_rank(self, c):
        return self.rank[c] if c < self.node_cnt else 0

    def reduce(self, tax_ids, k):
        """ReduceTaxIds (Taxonomy.hpp:733-849): promote up rank levels until
        at most k ids remain."""
        if len(tax_ids) <= k:
            return list(tax_ids)
        if any(t >= self.node_cnt for t in tax_ids):
            return [self.node_cnt]
        levels = [dict() for _ in range(len(RANKS))]
        for t in tax_ids:
            prev = 0
            levels[0][t] = 1
            while True:
                lv = int(LEVEL[self.rank[t]])
                if lv != UNKNOWN_LEVEL and lv > prev:
                    for ri in range(lv - 1, prev, -1):
                        levels[ri][t] = 1
                    if t in levels[lv]:
                        break
                    levels[lv][t] = 1
                    prev = lv
                t = self.parent[t]
                if t == self.parent[t]:
                    break
        ri = 0
        while ri < UNKNOWN_LEVEL and len(levels[ri]) > k:
            ri += 1
        return sorted(levels[ri]) or [self.root]
