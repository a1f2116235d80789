"""The port's succinct trees (centrifuger_tpu_torch/succinct/trees.py) against
the JAX package's and against the plain trees: every tree kind is built in
both packages from the same seeded random tree, held equal attribute for
attribute, asked every operation at every node (port against JAX), and
checked op by op against PlainTree / CardinalPlainTree as
tests/test_trees.py does."""

import numpy as np
import pytest

from test_torch_succinct import PORT, assert_same, both, query
from test_trees import BruteParens, _check_ordinal

ORDINAL_OPS = ("children_count", "child_rank", "is_leaf", "parent", "node_map", "first_child",
               "last_child", "next_sibling", "prev_sibling", "depth", "subtree_size",
               "leaf_count_in_subtree", "post_order", "close")


def random_tree(pk, n, seed, max_label=5):
    rng = np.random.default_rng(seed)
    t = pk.trees.PlainTree()
    for _ in range(n - 1):
        v = t.add_node(int(rng.integers(0, t.n)))
        t.set_label(v, int(rng.integers(0, max_label)))
    return t


def random_cardinal(pk, n, c, seed):
    rng = np.random.default_rng(seed)
    t = pk.trees.CardinalPlainTree(c)
    while t.n < n:
        v, lab = int(rng.integers(0, t.n)), int(rng.integers(0, c))
        if t.slots[v][lab] == -1:
            t.add_node(v, lab)
    return t


def trees(cls_name, n, seed, **kw):
    """(port plain tree, port tree, JAX tree) of one seeded tree."""
    plain, jplain = both(lambda pk: random_tree(pk, n, seed, **kw))
    t, jt = both(lambda pk: getattr(pk.trees, cls_name).from_plain(
        plain if pk is PORT else jplain))
    return plain, t, jt


def same_ops(t, jt, handles, ops, rng, plain_n):
    """Every op of `ops` the class has, at every handle, and child_select,
    lca and is_ancestor, port against JAX."""
    ops = [o for o in ops if hasattr(jt, o)]
    for h in handles:
        for o in ops:
            query(t, jt, o, h)
        for k in range(1, min(int(jt.children_count(h)), 8) + 1):
            query(t, jt, "child_select", h, k)
    for _ in range(100):
        hu, hv = (handles[int(rng.integers(0, plain_n))] for _ in range(2))
        query(t, jt, "lca", hu, hv)
        query(t, jt, "is_ancestor", hu, hv)


# ---------------------------------------------------------------- excess ops

def random_parens(n_pairs, seed):
    return PORT.trees.TreeBP.from_plain(random_tree(PORT, n_pairs, seed)).bp.bits[
        :2 * n_pairs].copy()


@pytest.mark.parametrize("n_pairs,seed", [(600, 7), (40, 2)])
def test_balanced_parens_excess_ops(n_pairs, seed):
    bits = random_parens(n_pairs, seed)
    bp, jbp = both(lambda pk: pk.trees.BalancedParens(bits))
    br = BruteParens(bits)
    n = len(bits)
    rng = np.random.default_rng(1)
    for _ in range(300):
        i, d = int(rng.integers(0, n)), int(rng.integers(-8, 9))
        assert query(bp, jbp, "fwd_search", i, d) == br.fwd_search(i, d), (i, d)
        assert query(bp, jbp, "bwd_search", i, d) == br.bwd_search(i, d), (i, d)
        query(bp, jbp, "excess", i)
    for _ in range(300):
        i = int(rng.integers(0, n - 1))
        j = int(rng.integers(i, n))
        for op in ("min_excess", "max_excess", "rmq", "rMq", "min_count"):
            assert query(bp, jbp, op, i, j) == getattr(br, op)(i, j), (op, i, j)
        t = int(rng.integers(1, br.min_count(i, j) + 1))
        assert query(bp, jbp, "min_select", i, j, t) == br.min_select(i, j, t)
        query(bp, jbp, "extreme_excess", i, j, bool(t & 1))
    query(bp, jbp, "nbytes")


def test_balanced_parens_matching():
    bits = random_parens(400, 11)
    bp, jbp = both(lambda pk: pk.trees.BalancedParens(bits))
    stack, match = [], {}
    for i, b in enumerate(bits):
        if b:
            stack.append(i)
        else:
            match[stack.pop()] = i
    for o, c in match.items():
        assert query(bp, jbp, "find_close", o) == c
        assert query(bp, jbp, "find_open", c) == o
        query(bp, jbp, "enclose", o)
    for o in list(match)[1:200]:
        depth = 0
        for j in range(o - 1, -1, -1):
            depth += 1 if bits[j] else -1
            if depth == 1:
                assert bp.enclose(o) == j
                break


@pytest.mark.parametrize("pat", [(1, 0), (0, 0), (1, 1, 0)])
def test_pattern_rank_select(pat):
    bits = np.random.default_rng(3).integers(0, 2, 5000).astype(np.uint8)
    prs, jprs = both(lambda pk: pk.trees.PatternRankSelect(bits, pat))
    p = len(pat)
    occ = [i for i in range(len(bits) - p + 1) if tuple(bits[i:i + p]) == pat]
    assert prs.total == len(occ)
    for i in range(0, len(bits), 37):
        assert query(prs, jprs, "rank", i) == sum(1 for o in occ if o <= i)
        assert query(prs, jprs, "rank", i, inclusive=False) == sum(1 for o in occ if o < i)
    for k in range(1, len(occ) + 1, 53):
        assert query(prs, jprs, "select", k) == occ[k - 1]


# ---------------------------------------------------------------- tree reps

@pytest.mark.parametrize("cls", ["TreeLOUDS", "TreeBP", "TreeDFUDS"])
@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (300, 2), (500, 3)])
def test_ordinal_trees(cls, n, seed):
    plain, t, jt = trees(cls, n, seed)
    _check_ordinal(t, plain, t.id_map, None)
    handles = [t.node_select(t.id_map[v]) for v in range(plain.n)]
    same_ops(t, jt, handles, ORDINAL_OPS, np.random.default_rng(seed), plain.n)
    for i in range(plain.n):
        query(t, jt, "node_select", i)
    query(t, jt, "nbytes")
    assert_same(t, jt, "after the queries")


def test_bp_extras():
    plain, t, jt = trees("TreeBP", 400, 9)
    for v in range(plain.n):
        h = t.node_select(t.id_map[v])
        assert query(t, jt, "depth", h) == plain.depth(v)
        assert query(t, jt, "subtree_size", h) == plain.subtree_size(v)
        assert query(t, jt, "leaf_count_in_subtree", h) == plain.leaf_count_in_subtree(v)
        assert query(t, jt, "post_order_select", query(t, jt, "post_order", h)) == h
        query(t, jt, "leaf_rank", h)
        query(t, jt, "leaf_rank", h, inclusive=False)
    for i, v in enumerate(plain.preorder()):
        assert t.id_map[v] == i
    for k in range(1, t.leaves.total + 1, 7):
        query(t, jt, "leaf_select", k)


def test_dfuds_extras():
    plain, t, jt = trees("TreeDFUDS", 400, 13)
    for v in range(plain.n):
        h = t.node_select(t.id_map[v])
        assert query(t, jt, "subtree_size", h) == plain.subtree_size(v)
        assert query(t, jt, "leaf_count_in_subtree", h) == plain.leaf_count_in_subtree(v)
        query(t, jt, "leaf_rank", h)
    leaves = sorted(t.node_select(t.id_map[v]) for v in range(plain.n) if plain.is_leaf(v))
    for k, h in enumerate(leaves, 1):
        assert query(t, jt, "leaf_select", k) == h


def test_labeled_tree():
    plain, t, jt = trees("TreeLabeled", 300, 17, max_label=4)
    for v in range(plain.n):
        h = t.node_select(t.id_map[v])
        if v != 0:
            assert query(t, jt, "child_label", h) == plain.get_label(v)
        for lab in range(4):
            kids = [c for c in plain.children[v] if plain.get_label(c) == lab]
            assert query(t, jt, "children_labeled", h, lab) == len(kids)
            for k, c in enumerate(kids, 1):
                assert t.node_map(query(t, jt, "labeled_child_select", h, lab, k)) == \
                    t.id_map[c]
            if kids:
                query(t, jt, "labeled_child", h, lab)
    assert_same(t, jt, "after the queries")


def cardinal(cls_name, n, c, seed):
    plain, jplain = both(lambda pk: random_cardinal(pk, n, c, seed))
    t, jt = both(lambda pk: getattr(pk.trees, cls_name).from_plain(
        plain if pk is PORT else jplain))
    return plain, t, jt


@pytest.mark.parametrize("n,c,seed", [(1, 3, 0), (200, 4, 1), (350, 2, 2)])
def test_cardinal_louds(n, c, seed):
    plain, t, jt = cardinal("TreeCardinalLOUDS", n, c, seed)
    m = t.id_map
    for v in range(plain.n):
        assert query(t, jt, "children_count", m[v]) == plain.children_count(v)
        assert query(t, jt, "is_leaf", m[v]) == plain.is_leaf(v)
        assert query(t, jt, "child_rank", m[v]) == plain.child_rank(v)
        for lab in range(c):
            ch = plain.labeled_child(v, lab)
            assert query(t, jt, "has_labeled_child", m[v], lab) == (ch != -1)
            assert query(t, jt, "labeled_child", m[v], lab) == (m[ch] if ch != -1 else -1)
            query(t, jt, "children_labeled", m[v], lab)
        for tt in range(1, plain.children_count(v) + 1):
            assert query(t, jt, "child_select", m[v], tt) == m[plain.child_select(v, tt)]
        if v != 0:
            assert query(t, jt, "parent", m[v]) == m[plain.parent[v]]
            assert query(t, jt, "child_label", m[v]) == plain.child_label(v)
    rng = np.random.default_rng(7)
    for _ in range(100):
        u, v = int(rng.integers(0, plain.n)), int(rng.integers(0, plain.n))
        assert query(t, jt, "lca", m[u], m[v]) == m[plain.lca(u, v)]
    query(t, jt, "nbytes")


@pytest.mark.parametrize("n,c,seed", [(1, 3, 0), (200, 4, 3), (350, 2, 4)])
def test_cardinal_ordinal(n, c, seed):
    plain, t, jt = cardinal("TreeCardinalOrdinal", n, c, seed)
    m = t.id_map
    for v in range(plain.n):
        h = t.node_select(m[v])
        assert query(t, jt, "children_count", h) == plain.children_count(v)
        assert query(t, jt, "is_leaf", h) == plain.is_leaf(v)
        if v != 0:
            assert query(t, jt, "child_label", h) == plain.child_label(v)
            assert t.node_map(query(t, jt, "parent", h)) == m[plain.parent[v]]
        for lab in range(c):
            ch = plain.labeled_child(v, lab)
            got = query(t, jt, "labeled_child", h, lab)
            assert got == -1 if ch == -1 else t.node_map(got) == m[ch]
            query(t, jt, "children_labeled", h, lab)


def test_space_is_succinct():
    plain, jplain = both(lambda pk: random_tree(pk, 4000, 23))
    for cls in ("TreeLOUDS", "TreeBP", "TreeDFUDS"):
        t, jt = both(lambda pk: getattr(pk.trees, cls).from_plain(
            plain if pk is PORT else jplain))
        assert t.B.nbytes() < 4000
        assert query(t, jt, "nbytes") == jt.nbytes()


def test_plain_tree_queries():
    """PlainTree's own operations, port against JAX, at every node."""
    plain, jplain = both(lambda pk: random_tree(pk, 300, 31))
    for v in range(plain.n):
        for op in ("children_count", "child_rank", "is_leaf", "is_first_child",
                   "is_last_child", "depth", "subtree_size", "leaf_count_in_subtree",
                   "get_label", "next_sibling", "prev_sibling", "first_child", "last_child"):
            query(plain, jplain, op, v)
        query(plain, jplain, "lca", v, (v * 7) % plain.n)
        query(plain, jplain, "is_ancestor", v, (v * 11) % plain.n)
    assert query(plain, jplain, "bfs_order") == jplain.bfs_order()
    assert query(plain, jplain, "preorder") == jplain.preorder()
    cp, jcp = both(lambda pk: random_cardinal(pk, 200, 3, 5))
    for v in range(cp.n):
        for op in ("existing_children", "children_count", "child_rank", "is_leaf",
                   "child_label"):
            query(cp, jcp, op, v)
        query(cp, jcp, "lca", v, (v * 7) % cp.n)
    assert query(cp, jcp, "bfs_order") == jcp.bfs_order()
    assert query(cp, jcp, "preorder") == jcp.preorder()
