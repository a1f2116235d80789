# Port copy of centrifuger_tpu.quant.tree (host code, no accelerator).
"""Literal port of Tree_Plain (reference compactds/Tree_Plain.hpp): parent /
sibling / child / lastChild arrays with the root index doubling as the chain
sentinel.  We keep the exact semantics (including sentinel quirks) because
children iteration order determines floating-point summation order in the
abundance EM, and we target bit-identical output."""


class TreePlain:
    def __init__(self, root=0):
        self.root = root
        self.parent = []
        self.sibling = []
        self.child = []
        self.last_child = []

    def init(self, n):
        r = self.root
        self.parent = [r] * n
        self.sibling = [r] * n
        self.child = [r] * n
        self.last_child = [r] * n
        self.n = n

    def add_edge(self, c, parent):
        self.parent[c] = parent
        last = self.last_child[parent]
        if last == self.root:
            self.child[parent] = c
        else:
            self.sibling[last] = c
        self.last_child[parent] = c

    def get_children(self, v):
        out = []
        c = self.child[v]
        while c != self.root:
            out.append(c)
            c = self.sibling[c]
        return out

    def is_leaf(self, v):
        return self.child[v] == self.root

    def size(self):
        return self.n


def convert_taxonomy_to_tree(tax):
    """Taxonomy::ConvertToGeneralTree (reference Taxonomy.hpp:962-984),
    including the disjoint-tree reconnection pass with its exact AddEdge order."""
    tree = TreePlain(root=tax.root_ctax)
    tree.init(tax.node_cnt)
    for i in range(tax.node_cnt):
        if i != int(tax.parent[i]):
            tree.add_edge(i, int(tax.parent[i]))
    root_children = set(tree.get_children(tree.root))
    for i in range(tax.node_cnt):
        if tree.parent[i] == tree.root and i not in root_children:
            tree.add_edge(i, tree.root)
    return tree
