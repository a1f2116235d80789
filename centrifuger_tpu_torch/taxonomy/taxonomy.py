# Port copy of centrifuger_tpu.taxonomy.taxonomy (host code, no accelerator).
"""Taxonomy tree: parsing of NCBI-style dump files, compact id mapping, rank
promotion (ReduceTaxIds) and lineage utilities.

Value-equivalent re-implementation of the reference Taxonomy class
(reference Taxonomy.hpp).  Key replicated behaviors:
  * compact tax ids are assigned in ascending original-taxid order over the
    nodes on root-paths of present leaves (Taxonomy.hpp:202-221, std::map order)
  * sequence ids are assigned in first-occurrence order of the conversion table
    (Taxonomy.hpp:325-329)
  * duplicated seqids promote their taxid to the LCA (Taxonomy.hpp:330-352)
  * ReduceTaxIds: per-rank-level promotion until <= k ids remain
    (Taxonomy.hpp:733-849)
"""

import numpy as np

# rank enum ids; order matters for serialization compat (reference Taxonomy.hpp:25-59)
RANKS = [
    "no rank", "strain", "species", "genus", "family", "order", "class",
    "phylum", "kingdom", "domain", "forma", "infraclass", "infraorder",
    "parvorder", "subclass", "subfamily", "subgenus", "subkingdom", "suborder",
    "subphylum", "subspecies", "subtribe", "superclass", "superfamily",
    "superkingdom", "superorder", "superphylum", "tribe", "varietas", "life",
    "acellular root",
]
RANK_UNKNOWN = 0
RANK_MAX = len(RANKS)
_RANK_TO_ID = {r: i for i, r in enumerate(RANKS)}


def rank_id(rank_str):
    return _RANK_TO_ID.get(rank_str, RANK_UNKNOWN)


def rank_string(rid):
    if 0 < rid < RANK_MAX:
        return RANKS[rid]
    return "no rank"


def _make_rank_num():
    """Rank-level ordering used by ReduceTaxIds (Taxonomy::InitTaxRankNum,
    reference Taxonomy.hpp:100-144)."""
    num = {}
    level = 0
    num["subspecies"] = level
    num["strain"] = level; level += 1
    num["species"] = level; level += 1
    num["subgenus"] = level
    num["genus"] = level; level += 1
    num["subfamily"] = level
    num["family"] = level
    num["superfamily"] = level; level += 1
    num["suborder"] = level
    num["infraorder"] = level
    num["parvorder"] = level
    num["order"] = level
    num["superorder"] = level; level += 1
    num["infraclass"] = level
    num["subclass"] = level
    num["class"] = level
    num["superclass"] = level; level += 1
    num["subphylum"] = level
    num["phylum"] = level
    num["superphylum"] = level; level += 1
    num["subkingdom"] = level
    num["kingdom"] = level; level += 1
    num["superkingdom"] = level
    num["acellular root"] = level
    num["domain"] = level; level += 1
    num["forma"] = level
    num["subtribe"] = level
    num["tribe"] = level
    num["varietas"] = level
    num["life"] = level
    num["no rank"] = level
    out = np.zeros(RANK_MAX, dtype=np.int64)
    for r, lv in num.items():
        out[_RANK_TO_ID[r]] = lv
    return out


TAX_RANK_NUM = _make_rank_num()

CANONICAL_RANKS = {  # IsCanonicalRankNum (reference Taxonomy.hpp:435-443)
    "strain", "species", "genus", "family", "order", "class", "phylum",
    "kingdom", "superkingdom", "domain", "acellular root",
}


def _parse_dmp_fields(line):
    return [f.strip() for f in line.rstrip("\n").split("|")]


class Taxonomy:
    def __init__(self):
        self.node_cnt = 0
        self.parent = np.zeros(0, dtype=np.int64)    # compact parent ids
        self.rank = np.zeros(0, dtype=np.uint8)
        self.leaf = np.zeros(0, dtype=bool)
        self.orig_ids = np.zeros(0, dtype=np.uint64)  # compact -> original taxid
        self.names = []                               # compact -> scientific name
        self.seq_names = []                           # seqid -> name string
        self.seq_name_to_id = {}
        self.seq_id_to_tax = np.zeros(0, dtype=np.int64)  # seqid -> compact taxid
        self.seq_cnt = 0
        self.extra_seq_cnt = 0
        self.root_ctax = 0
        self._orig_to_compact = {}

    # ------------------------------------------------------------------ parsing

    @classmethod
    def from_dumps(cls, nodes_file, names_file, conversion_file=None,
                   conversion_at_file_level=False, presence_from_nodes=False):
        t = cls()
        present = {}
        if conversion_file is not None and not presence_from_nodes:
            # taxids present as leaves (ReadPresentTaxonomyLeafs filetype 0)
            with open(conversion_file) as f:
                for line in f:
                    if not line.strip() or line[0] == "#":
                        continue
                    parts = line.split()
                    if len(parts) < 2:
                        continue
                    seq_name = parts[0]
                    if conversion_at_file_level:
                        seq_name = _file_base_name(seq_name)
                    try:
                        present[int(parts[1])] = 0
                    except ValueError:
                        continue
        else:
            # filetype 1: first column of nodes.dmp itself
            with open(nodes_file) as f:
                for line in f:
                    if not line.strip() or line[0] == "#":
                        continue
                    present[int(line.split()[0])] = 0

        t._read_tree(nodes_file, present)
        t._read_names(names_file, present)
        if conversion_file is not None and not presence_from_nodes:
            t._read_seq_names(conversion_file, conversion_at_file_level)
        t.root_ctax = t._find_root()
        return t

    def _read_tree(self, nodes_file, present):
        tree = {}
        with open(nodes_file) as f:
            for line in f:
                if not line.strip() or line[0] == "#":
                    continue
                # parse "tid | parent | rank ..." token-wise like the reference
                # (Taxonomy.hpp:156-167: rank may contain spaces, e.g. "acellular root")
                toks = line.split()
                tid = int(toks[0])
                parent = int(toks[2])
                rank_toks = []
                for tk in toks[4:]:
                    if tk == "|":
                        break
                    rank_toks.append(tk)
                rstr = " ".join(rank_toks)
                if tid in tree:
                    continue
                tree[tid] = (parent, rank_id(rstr))

        # closure: all nodes on root paths of present leaves (Taxonomy.hpp:183-199)
        selected = {}
        for tid in present:
            if tid not in tree:
                continue
            p = tid
            while p not in selected:
                selected[p] = 1
                p = tree[p][0]
        present.clear()
        present.update(selected)

        ids = sorted(t for t in tree if t in selected)
        self.node_cnt = len(ids)
        self.orig_ids = np.array(ids, dtype=np.uint64)
        self._orig_to_compact = {t: i for i, t in enumerate(ids)}
        self.parent = np.zeros(self.node_cnt, dtype=np.int64)
        self.rank = np.zeros(self.node_cnt, dtype=np.uint8)
        self.leaf = np.ones(self.node_cnt, dtype=bool)
        for i, tid in enumerate(ids):
            ptid, r = tree[tid]
            self.rank[i] = r
            if ptid in self._orig_to_compact:
                self.parent[i] = self._orig_to_compact[ptid]
            else:
                self.parent[i] = i  # orphan: parent to itself (Taxonomy.hpp:231-235)
        for i in range(self.node_cnt):
            if self.parent[i] != i:
                self.leaf[self.parent[i]] = False

    def _read_names(self, names_file, present):
        self.names = [""] * self.node_cnt
        with open(names_file) as f:
            for line in f:
                if not line.strip() or line[0] == "#":
                    continue
                if "scientific name" not in line:
                    continue
                toks = line.split()
                tid = int(toks[0])
                if tid not in present or tid not in self._orig_to_compact:
                    continue
                name_toks = []
                for tk in toks[2:]:
                    if tk == "|":
                        break
                    name_toks.append(tk)
                # tokens joined with '_' (Taxonomy.hpp:253-264)
                self.names[self._orig_to_compact[tid]] = "_".join(name_toks)

    def _read_seq_names(self, conversion_file, at_file_level):
        raw = {}
        with open(conversion_file) as f:
            for line in f:
                if not line.strip() or line[0] == "#":
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                name = parts[0]
                if at_file_level:
                    name = _file_base_name(name)
                tid = int(parts[1])
                if name not in self.seq_name_to_id:
                    self.seq_name_to_id[name] = len(self.seq_names)
                    self.seq_names.append(name)
                    raw[name] = tid
                else:
                    # duplicate seqid: promote to LCA (Taxonomy.hpp:330-352)
                    a = self.compact_tax_id(raw[name])
                    b = self.compact_tax_id(tid)
                    raw[name] = self._lca_orig(a, b)
        self.seq_cnt = len(self.seq_names)
        self.seq_id_to_tax = np.zeros(self.seq_cnt, dtype=np.int64)
        for name, tid in raw.items():
            # missing taxids map to compact 0 (MapID::Map default-insert quirk)
            self.seq_id_to_tax[self.seq_name_to_id[name]] = \
                self._orig_to_compact.get(tid, 0)

    def _lca_orig(self, a, b):
        """LCA of two compact ids, returned as ORIGINAL taxid; replicates the
        path-compare in ReadSeqNameFile including the pre-root-init quirk where
        _rootCTaxId is still 0 (Taxonomy.hpp:338-351)."""
        pa = self.lineage_path(a)
        pb = self.lineage_path(b)
        i, j = len(pa) - 1, len(pb) - 1
        while i >= 0 and j >= 0:
            if pa[i] != pb[j]:
                break
            i -= 1
            j -= 1
        if i == len(pa) - 1 or (i + 1 < len(pa) and j + 1 < len(pb)
                                and pa[i + 1] != pb[j + 1]):
            return int(self.orig_ids[0])  # GetOrigTaxId(_rootCTaxId=0)
        return int(self.orig_ids[pa[i + 1]])

    # ------------------------------------------------------------------ queries

    def compact_tax_id(self, orig):
        return self._orig_to_compact.get(int(orig), self.node_cnt)

    def orig_tax_id(self, ctid):
        """GetOrigTaxId: out-of-range returns the root's original id
        (reference Taxonomy.hpp:633-639)."""
        if ctid >= self.node_cnt:
            return int(self.orig_ids[self.root_ctax])
        return int(self.orig_ids[ctid])

    def seq_id_to_tax_id(self, seq_id):
        if seq_id < self.seq_cnt:
            return int(self.seq_id_to_tax[seq_id])
        return self.node_cnt

    def seq_id_to_name(self, seq_id):
        return self.seq_names[seq_id]

    def seq_name_to_seq_id(self, name):
        return self.seq_name_to_id.get(name, len(self.seq_names))

    def add_extra_seq_name(self, name):
        sid = len(self.seq_names)
        if name in self.seq_name_to_id:
            return self.seq_name_to_id[name]
        self.seq_name_to_id[name] = sid
        self.seq_names.append(name)
        self.extra_seq_cnt += 1
        return sid

    def tax_rank(self, ctid):
        if ctid >= self.node_cnt:
            return RANK_UNKNOWN
        return int(self.rank[ctid])

    def tax_name(self, ctid):
        if ctid < self.node_cnt:
            return self.names[ctid]
        return "Unknown"

    def lineage_path(self, ctid):
        """Compact-id path from ctid up to (but excluding) the root, unless ctid
        is out of range -> [root_ctax] (GetTaxLineagePath, Taxonomy.hpp:853-869)."""
        if ctid >= self.node_cnt:
            return [self.root_ctax]
        path = []
        while True:
            path.append(ctid)
            ctid = int(self.parent[ctid])
            if ctid == int(self.parent[ctid]):
                break
        return path

    def _find_root(self):
        for i in range(self.node_cnt):
            if self.parent[i] == i:
                return i
        return self.node_cnt

    def is_canonical(self, ctid):
        return rank_string(self.tax_rank(ctid)) in CANONICAL_RANKS

    def get_children_tax(self, ctid):
        """Set of compact ids in the subtree rooted at ctid, inclusive
        (GetChildrenTax, reference Taxonomy.hpp:914-958)."""
        if ctid >= self.node_cnt:
            return set()
        visited = np.full(self.node_cnt, -1, dtype=np.int8)
        visited[ctid] = 1
        for i in range(self.node_cnt):
            t = i
            path = []
            while t != self.parent[t]:
                if visited[t] != -1:
                    break
                path.append(t)
                t = int(self.parent[t])
            res = visited[t]
            if res == -1:
                res = 0
            for p in path:
                visited[p] = res
        return set(np.flatnonzero(visited == 1).tolist())

    # --------------------------------------------------------------- reduction

    def reduce_tax_ids(self, tax_ids, k, want_children=False):
        """Promote tax ids up rank levels until <= k remain.
        Returns (promoted list, children list-of-lists or None).
        Exact port of Taxonomy::ReduceTaxIds (reference Taxonomy.hpp:733-849)."""
        tax_ids = list(tax_ids)
        if len(tax_ids) <= k:
            return tax_ids, ([] if want_children else None)

        for t in tax_ids:
            if t >= self.node_cnt:
                children = None
                if want_children:
                    children = [list(tax_ids)]
                return [self.node_cnt], children

        unknown_level = int(TAX_RANK_NUM[RANK_UNKNOWN])
        levels = [dict() for _ in range(RANK_MAX)]
        for t0 in tax_ids:
            t = t0
            prev_level = 0
            levels[0][t] = 1
            while True:
                lv = int(TAX_RANK_NUM[self.rank[t]])
                if lv != unknown_level and lv > prev_level:
                    for ri in range(lv - 1, prev_level, -1):
                        levels[ri][t] = 1
                    if t not in levels[lv]:
                        levels[lv][t] = 1
                    else:
                        break  # upper id already added; stop climbing
                    prev_level = lv
                t = int(self.parent[t])
                if t == int(self.parent[t]):
                    break  # reached the root (root itself is not processed)
        # find the first level with <= k ids
        ri = 0
        while ri < unknown_level:
            if len(levels[ri]) <= k:
                break
            ri += 1
        promoted = sorted(levels[ri].keys())
        children = None
        if len(promoted) == 0:
            promoted = [self.root_ctax]
        elif want_children and ri > 0:
            prom_idx = {t: i for i, t in enumerate(sorted(levels[ri].keys()))}
            children = [[] for _ in promoted]
            for t0 in sorted(levels[ri - 1].keys()):
                t = t0
                while t != int(self.parent[t]):
                    t = int(self.parent[t])
                    lv = int(TAX_RANK_NUM[self.rank[t]])
                    if lv > ri:
                        break
                    if lv == ri:
                        if t in prom_idx:
                            children[prom_idx[t]].append(t0)
                        break
        return promoted, children

    # ----------------------------------------------------- genome length logic

    def seq_length_to_tax_length(self, seq_length):
        """taxidLength[] from per-seq lengths: consecutive accessions of the same
        genome sum, max over genomes per taxid, then averaged up the tree
        (ConvertSeqLengthToTaxLength, reference Taxonomy.hpp:987-1026)."""
        tax_len = np.zeros(self.node_cnt + 1, dtype=np.int64)
        names = sorted(self.seq_names)
        i = 0
        cnt = len(names)
        while i < cnt:
            sid = self.seq_name_to_seq_id(names[i])
            ln = seq_length.get(sid, 0)
            tid = self.seq_id_to_tax_id(sid)
            j = i + 1
            while j < cnt:
                nsid = self.seq_name_to_seq_id(names[j])
                if self.seq_id_to_tax_id(nsid) != tid or \
                        not _is_next_seq_same_genome(names[j - 1], names[j]):
                    break
                ln += seq_length.get(nsid, 0)
                j += 1
            if tid < self.node_cnt and ln > tax_len[tid]:
                tax_len[tid] = ln
            i = j
        self.infer_all_tax_length(tax_len, True)
        return tax_len

    def infer_all_tax_length(self, tax_len, from_seq_length):
        """InferAllTaxLength (reference Taxonomy.hpp:1032-1089), in place."""
        n = self.node_cnt
        count = np.zeros(n, dtype=np.int64)
        new_len = np.zeros(n, dtype=np.int64)
        preset = tax_len[:n] != 0
        count[preset] = 1
        for i in np.flatnonzero(preset):
            if self.parent[i] == i or not self.leaf[i]:
                continue
            p = int(self.parent[i])
            while True:
                count[p] += 1
                new_len[p] += tax_len[i]
                if p == int(self.parent[p]):
                    break
                p = int(self.parent[p])
        for i in range(n):
            if tax_len[i] == 0 or from_seq_length:
                s = new_len[i] + (tax_len[i] if preset[i] else 0)
                if count[i] == 0:
                    tax_len[i] = s
                else:
                    tax_len[i] = s // count[i]

    def set_tax_id_as_seq_id(self):
        """--concat-tax-genome mode (SetTaxIdAsSeqId, reference Taxonomy.hpp:1093-1112)."""
        self.seq_names = []
        self.seq_name_to_id = {}
        self.seq_id_to_tax = np.arange(self.node_cnt + 1, dtype=np.int64)
        for i in range(self.node_cnt):
            name = self.names[i]
            if name not in self.seq_name_to_id:
                self.seq_name_to_id[name] = i
            self.seq_names.append(name)
        self.seq_names.append("uncategorized")
        self.seq_name_to_id.setdefault("uncategorized", self.node_cnt)
        self.extra_seq_cnt = 0
        self.seq_cnt = self.node_cnt + 1

    # ------------------------------------------------------------- persistence

    def save(self, path):
        import json
        meta = dict(node_cnt=self.node_cnt, seq_cnt=self.seq_cnt,
                    extra_seq_cnt=self.extra_seq_cnt, root_ctax=self.root_ctax)
        np.savez(path,
                 parent=self.parent, rank=self.rank, leaf=self.leaf,
                 orig_ids=self.orig_ids, seq_id_to_tax=self.seq_id_to_tax,
                 names=np.frombuffer("\n".join(self.names).encode(), dtype=np.uint8),
                 seq_names=np.frombuffer("\n".join(self.seq_names).encode(), dtype=np.uint8),
                 meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))

    @classmethod
    def load(cls, path):
        import json
        z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        meta = json.loads(bytes(z["meta"]).decode())
        t = cls()
        t.node_cnt = meta["node_cnt"]
        t.seq_cnt = meta["seq_cnt"]
        t.extra_seq_cnt = meta["extra_seq_cnt"]
        t.root_ctax = meta["root_ctax"]
        t.parent = z["parent"]
        t.rank = z["rank"]
        t.leaf = z["leaf"]
        t.orig_ids = z["orig_ids"]
        t.seq_id_to_tax = z["seq_id_to_tax"]
        names_blob = bytes(z["names"]).decode()
        t.names = names_blob.split("\n") if names_blob else []
        seq_blob = bytes(z["seq_names"]).decode()
        t.seq_names = seq_blob.split("\n") if seq_blob else []
        t.seq_name_to_id = {}
        for i, s in enumerate(t.seq_names):
            t.seq_name_to_id.setdefault(s, i)
        t._orig_to_compact = {int(o): i for i, o in enumerate(t.orig_ids)}
        return t


def _file_base_name(path, exts=("fna", "fa", "fasta", "faa")):
    """Utils::GetFileBaseName semantics: strip directory and the listed extensions
    (possibly with .gz)."""
    base = path.rsplit("/", 1)[-1]
    if base.endswith(".gz"):
        base = base[:-3]
    for e in exts:
        if base.endswith("." + e):
            return base[: -(len(e) + 1)]
    return base


def _is_next_seq_same_genome(a, b):
    """IsNextSeqNameFromTheSameGenome (reference Taxonomy.hpp:372-406)."""
    ids = []
    for s in (a, b):
        j = 0
        while j < len(s) and not s[j].isdigit():
            j += 1
        v = 0
        while j < len(s) and s[j].isdigit():
            v = v * 10 + int(s[j])
            j += 1
        if j < 3 or len(s) < 3 or s[2] != "_":
            return False
        ids.append(v)
    return ids[1] == ids[0] + 1
