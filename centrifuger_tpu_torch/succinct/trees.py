# Port copy of centrifuger_tpu.succinct.trees (host code, no accelerator).
"""Succinct tree family + balanced-parenthesis machinery.

Library counterparts of the reference's tree layer:
  Tree.hpp / Tree_Plain.hpp          -> PlainTree (brute-force oracle + builder)
  DS_RangeMinMaxTree.hpp (920 LoC)   -> BalancedParens (block-summary design)
  DS_Parenthesis.hpp                 -> BalancedParens.{find_close,find_open,enclose}
  DS_PatternRankSelect.hpp           -> PatternRankSelect
  Tree_LOUDS.hpp                     -> TreeLOUDS
  Tree_BP.hpp                        -> TreeBP
  Tree_DFUDS.hpp                     -> TreeDFUDS
  Tree_Labeled.hpp                   -> TreeLabeled
  Tree_Cardinal_Plain.hpp            -> CardinalPlainTree
  Tree_Cardinal_LOUDS.hpp            -> TreeCardinalLOUDS
  Tree_Cardinal_Ordinal.hpp          -> TreeCardinalOrdinal

Design notes (not a translation).  The reference's rmM-tree walks a pointer
binary tree of (min,max,count) blocks per query (DS_RangeMinMaxTree.hpp).
Here every query is a bounded in-block bit scan plus a *vectorized* numpy
reduction over per-block summary arrays — the same asymptotic space (o(n)
extra bits for block size b) but expressed as flat arrays, the layout that
would lower to device gathers if a tree ever landed on the classification
hot path.  Tree handles are positions in the underlying bit sequence, with
node_map/node_select converting to/from dense (BFS or preorder) node ids,
matching the reference's NodeMap/NodeSelect contract.

All excess conventions follow the reference exactly:
  excess step of bit x = 2*x - 1
  fwd_search(i, d): smallest j >= i with sum_{k=i..j} step(B[k]) == d  (else n)
  bwd_search(i, d): largest j <= i with sum_{k=j..i} -step(B[k]) == d, returns
                    that j (0 allowed, meaning the scan consumed B[0]); n if none
  find_close(i) = fwd_search(i, 0)          (DS_Parenthesis.hpp:80-84)
  find_open(i)  = bwd_search(i, 0)          (DS_Parenthesis.hpp:86-89)
  enclose(i)    = bwd_search(i, -1 - B[i])  (DS_Parenthesis.hpp:91-94)
"""

import numpy as np

from .bitvector import Bitvector
from .bitvectors import SelectSupport


# --------------------------------------------------------------------------
# Plain pointer trees (builders + brute-force oracles)
# --------------------------------------------------------------------------

class PlainTree:
    """Mutable ordinal tree; node 0 is the root, children kept in insertion
    order (reference compactds/Tree_Plain.hpp)."""

    def __init__(self):
        self.parent = [0]
        self.children = [[]]
        self.labels = [0]

    def add_node(self, parent):
        nid = len(self.parent)
        self.parent.append(int(parent))
        self.children.append([])
        self.children[parent].append(nid)
        self.labels.append(0)
        return nid

    def set_label(self, v, l):
        self.labels[v] = l

    def get_label(self, v):
        return self.labels[v]

    @property
    def n(self):
        return len(self.parent)

    def root(self):
        return 0

    def children_count(self, v):
        return len(self.children[v])

    def child_select(self, v, t):
        return self.children[v][t - 1]

    def first_child(self, v):
        return self.children[v][0]

    def last_child(self, v):
        return self.children[v][-1]

    def child_rank(self, v):
        if v == 0:
            return 0
        return self.children[self.parent[v]].index(v) + 1

    def next_sibling(self, v):
        sibs = self.children[self.parent[v]]
        return sibs[sibs.index(v) + 1]

    def prev_sibling(self, v):
        sibs = self.children[self.parent[v]]
        return sibs[sibs.index(v) - 1]

    def is_leaf(self, v):
        return not self.children[v]

    def is_first_child(self, v):
        return v == 0 or self.child_rank(v) == 1

    def is_last_child(self, v):
        return v == 0 or self.child_rank(v) == self.children_count(self.parent[v])

    def depth(self, v):
        d = 0
        while v != 0:
            v = self.parent[v]
            d += 1
        return d

    def lca(self, u, v):
        du, dv = self.depth(u), self.depth(v)
        while du > dv:
            u = self.parent[u]
            du -= 1
        while dv > du:
            v = self.parent[v]
            dv -= 1
        while u != v:
            u, v = self.parent[u], self.parent[v]
        return u

    def subtree_size(self, v):
        return 1 + sum(self.subtree_size(c) for c in self.children[v])

    def leaf_count_in_subtree(self, v):
        if self.is_leaf(v):
            return 1
        return sum(self.leaf_count_in_subtree(c) for c in self.children[v])

    def is_ancestor(self, u, v):
        while v != 0 and v != u:
            v = self.parent[v]
        return v == u

    def bfs_order(self):
        """BFS node list (children in insertion order)."""
        order, head = [0], 0
        while head < len(order):
            order.extend(self.children[order[head]])
            head += 1
        return order

    def preorder(self):
        order, stack = [], [0]
        while stack:
            v = stack.pop()
            order.append(v)
            stack.extend(reversed(self.children[v]))
        return order


class CardinalPlainTree:
    """Cardinal tree of arity c: each child slot has a fixed label in [0, c)
    (reference compactds/Tree_Cardinal_Plain.hpp)."""

    def __init__(self, c):
        self.c = int(c)
        self.slots = [[-1] * self.c]
        self.parent = [0]
        self.edge_label = [0]  # label of the edge from parent

    def add_node(self, parent, label):
        nid = len(self.parent)
        assert self.slots[parent][label] == -1
        self.slots.append([-1] * self.c)
        self.parent.append(int(parent))
        self.edge_label.append(int(label))
        self.slots[parent][label] = nid
        return nid

    @property
    def n(self):
        return len(self.parent)

    def root(self):
        return 0

    def existing_children(self, v):
        return [ch for ch in self.slots[v] if ch != -1]

    def children_count(self, v):
        return len(self.existing_children(v))

    def child_select(self, v, t):
        return self.existing_children(v)[t - 1]

    def labeled_child(self, v, l):
        """Child of v through edge labeled l, or -1."""
        return self.slots[v][l]

    def has_labeled_child(self, v, l):
        return self.slots[v][l] != -1

    def child_label(self, v):
        return self.edge_label[v]

    def child_rank(self, v):
        if v == 0:
            return 0
        return self.existing_children(self.parent[v]).index(v) + 1

    def is_leaf(self, v):
        return self.children_count(v) == 0

    def lca(self, u, v):
        pu, pv = set(), None
        while True:
            pu.add(u)
            if u == 0:
                break
            u = self.parent[u]
        while v not in pu:
            v = self.parent[v]
        return v

    def bfs_order(self):
        order, head = [0], 0
        while head < len(order):
            order.extend(self.existing_children(order[head]))
            head += 1
        return order

    def preorder(self):
        order, stack = [], [0]
        while stack:
            v = stack.pop()
            order.append(v)
            stack.extend(reversed(self.existing_children(v)))
        return order


# --------------------------------------------------------------------------
# Balanced-parenthesis support (rmM-tree role)
# --------------------------------------------------------------------------

class BalancedParens:
    """Excess machinery over a 0/1 sequence ('('=1, ')'=0).

    Per-block (default b=64) summaries: absolute excess at block start,
    absolute block min/max prefix excess, and min-multiplicity.  Queries do
    one or two bounded in-block scans plus vectorized reductions over the
    summary arrays (reference equivalent: compactds/DS_RangeMinMaxTree.hpp).
    """

    BLOCK = 64

    def __init__(self, bits):
        bits = np.asarray(bits).astype(np.int8)
        self.n = len(bits)
        b = self.BLOCK
        nb = max((self.n + b - 1) // b, 1)
        padded = np.zeros(nb * b, dtype=np.int8)
        padded[:self.n] = bits
        # excess steps, zero outside the sequence so padding is inert
        step = (2 * padded - 1).astype(np.int64)
        step[self.n:] = 0
        blk = step.reshape(nb, b)
        pe = np.cumsum(blk, axis=1)                # in-block prefix excess
        tot = pe[:, -1]
        self.start = np.zeros(nb + 1, dtype=np.int64)  # abs excess before blk
        np.cumsum(tot, out=self.start[1:])
        # mask padding positions out of min/max
        pos = np.arange(nb * b).reshape(nb, b)
        valid = pos < self.n
        big, small = np.int64(1) << 60, -(np.int64(1) << 60)
        pmin = np.where(valid, pe, big)
        pmax = np.where(valid, pe, small)
        self.bmin = pmin.min(axis=1) + self.start[:-1]   # absolute
        self.bmax = pmax.max(axis=1) + self.start[:-1]
        self.bmincnt = (pmin == pmin.min(axis=1)[:, None]).sum(axis=1)
        self.bits = padded
        self.nb = nb

    # -- scalar prefix excess (inclusive of position i; E(-1) = 0) --
    def excess(self, i):
        if i < 0:
            return 0
        b = self.BLOCK
        k = i // b
        seg = self.bits[k * b:k * b + (i - k * b + 1)].astype(np.int64)
        return int(self.start[k] + (2 * seg - 1).sum())

    def _block_prefix(self, k):
        """Absolute prefix excess array of block k (inclusive per position)."""
        b = self.BLOCK
        seg = self.bits[k * b:(k + 1) * b].astype(np.int64)
        return self.start[k] + np.cumsum(2 * seg - 1)

    def fwd_search(self, i, d):
        """Smallest j >= i with sum_{k=i..j} step == d; n if none
        (reference DS_RangeMinMaxTree::FwdSearch semantics, test.cpp:1405-1428)."""
        n, b = self.n, self.BLOCK
        if i >= n:
            return n
        target = self.excess(i - 1) + d
        k = i // b
        pe = self._block_prefix(k)
        lo, hi = i - k * b, min(n - k * b, b)
        hit = np.flatnonzero(pe[lo:hi] == target)
        if len(hit):
            return k * b + lo + int(hit[0])
        cand = np.flatnonzero((self.bmin[k + 1:] <= target)
                              & (target <= self.bmax[k + 1:]))
        if not len(cand):
            return n
        k2 = k + 1 + int(cand[0])
        pe = self._block_prefix(k2)
        hi = min(n - k2 * b, b)
        hit = np.flatnonzero(pe[:hi] == target)
        return k2 * b + int(hit[0])

    def bwd_search(self, i, d):
        """Largest j <= i with sum_{k=j..i} -step == d; n if none
        (reference semantics incl. j==0 when the scan consumes B[0],
        test.cpp:1431-1452)."""
        n, b = self.n, self.BLOCK
        if i < 0 or i >= n:
            return n
        target = self.excess(i) + d      # we need E(j-1) == target, j-1 in [-1, i-1]
        k = i // b
        pe = self._block_prefix(k)
        lo = k * b
        hi = i - lo                       # positions lo..i-1 have pe[0..hi-1]
        if hi > 0:
            hit = np.flatnonzero(pe[:hi] == target)
            if len(hit):
                return lo + int(hit[-1]) + 1
        if k == 0:
            return 0 if target == 0 else n
        cand = np.flatnonzero((self.bmin[:k] <= target) & (target <= self.bmax[:k]))
        if not len(cand):
            return 0 if target == 0 else n
        k2 = int(cand[-1])
        pe = self._block_prefix(k2)
        hit = np.flatnonzero(pe == target)
        return k2 * b + int(hit[-1]) + 1

    # -- range extreme excess over positions [i, j] inclusive --
    def _range_parts(self, i, j):
        b = self.BLOCK
        ki, kj = i // b, j // b
        if ki == kj:
            pe = self._block_prefix(ki)
            return [pe[i - ki * b:j - ki * b + 1]], None
        parts = [self._block_prefix(ki)[i - ki * b:],
                 self._block_prefix(kj)[:j - kj * b + 1]]
        return parts, (ki + 1, kj)        # full-block summary range

    def min_excess(self, i, j):
        parts, full = self._range_parts(i, j)
        m = min(int(p.min()) for p in parts if len(p))
        if full and full[0] < full[1]:
            m = min(m, int(self.bmin[full[0]:full[1]].min()))
        return m

    def max_excess(self, i, j):
        parts, full = self._range_parts(i, j)
        m = max(int(p.max()) for p in parts if len(p))
        if full and full[0] < full[1]:
            m = max(m, int(self.bmax[full[0]:full[1]].max()))
        return m

    def extreme_excess(self, i, j, want_max):
        return self.max_excess(i, j) if want_max else self.min_excess(i, j)

    def min_count(self, i, j):
        """Multiplicity of the minimum excess in [i, j]."""
        m = self.min_excess(i, j)
        b = self.BLOCK
        ki, kj = i // b, j // b
        cnt = 0
        if ki == kj:
            pe = self._block_prefix(ki)[i - ki * b:j - ki * b + 1]
            return int((pe == m).sum())
        cnt += int((self._block_prefix(ki)[i - ki * b:] == m).sum())
        cnt += int((self._block_prefix(kj)[:j - kj * b + 1] == m).sum())
        if ki + 1 < kj:
            sl = slice(ki + 1, kj)
            cnt += int(self.bmincnt[sl][self.bmin[sl] == m].sum())
        return cnt

    def rmq(self, i, j):
        """Leftmost position of the minimum excess in [i, j]."""
        m = self.min_excess(i, j)
        return self._nth_min_pos(i, j, m, 1)

    def rMq(self, i, j):
        """Leftmost position of the maximum excess in [i, j]."""
        M = self.max_excess(i, j)
        b = self.BLOCK
        ki, kj = i // b, j // b
        pe = self._block_prefix(ki)
        hi = min(j - ki * b, b - 1)
        seg = pe[i - ki * b:hi + 1]
        hit = np.flatnonzero(seg == M)
        if len(hit):
            return i + int(hit[0])
        if ki + 1 < kj:
            cand = np.flatnonzero(self.bmax[ki + 1:kj] == M)
            if len(cand):
                k2 = ki + 1 + int(cand[0])
                pe = self._block_prefix(k2)
                return k2 * b + int(np.flatnonzero(pe == M)[0])
        pe = self._block_prefix(kj)
        return kj * b + int(np.flatnonzero(pe[:j - kj * b + 1] == M)[0])

    def min_select(self, i, j, t):
        """Position of the t-th (1-based) occurrence of the min excess in [i,j]."""
        m = self.min_excess(i, j)
        return self._nth_min_pos(i, j, m, t)

    def _nth_min_pos(self, i, j, m, t):
        b = self.BLOCK
        ki, kj = i // b, j // b
        if ki == kj:
            pe = self._block_prefix(ki)[i - ki * b:j - ki * b + 1]
            return i + int(np.flatnonzero(pe == m)[t - 1])
        seg = self._block_prefix(ki)[i - ki * b:]
        hits = np.flatnonzero(seg == m)
        if t <= len(hits):
            return i + int(hits[t - 1])
        t -= len(hits)
        if ki + 1 < kj:
            sl_min = self.bmin[ki + 1:kj]
            sl_cnt = np.where(sl_min == m, self.bmincnt[ki + 1:kj], 0)
            cum = np.cumsum(sl_cnt)
            idx = np.searchsorted(cum, t, side="left")
            if idx < len(cum):
                k2 = ki + 1 + int(idx)
                prev = int(cum[idx - 1]) if idx else 0
                pe = self._block_prefix(k2)
                return k2 * b + int(np.flatnonzero(pe == m)[t - prev - 1])
            t -= int(cum[-1]) if len(cum) else 0
        pe = self._block_prefix(kj)[:j - kj * b + 1]
        return kj * b + int(np.flatnonzero(pe == m)[t - 1])

    # -- parenthesis ops (reference DS_Parenthesis.hpp:80-94) --
    def find_close(self, i):
        return self.fwd_search(i, 0)

    def find_open(self, i):
        return self.bwd_search(i, 0)

    def enclose(self, i):
        return self.bwd_search(i, -1 - int(self.bits[i]))

    def nbytes(self):
        return (self.bits.nbytes + self.start.nbytes + self.bmin.nbytes
                + self.bmax.nbytes + self.bmincnt.nbytes)


class PatternRankSelect:
    """Rank/select over occurrences of a short bit pattern (reference
    compactds/DS_PatternRankSelect.hpp — block-count binary tree there; here
    the occurrence mask reuses the Bitvector rank/select directory, same
    o(n)-extra-bits asymptotics)."""

    def __init__(self, bits, pattern):
        bits = np.asarray(bits).astype(np.uint8)
        pat = np.asarray(pattern, dtype=np.uint8)
        n, p = len(bits), len(pat)
        match = np.ones(max(n - p + 1, 0), dtype=bool)
        for off in range(p):
            match &= bits[off:n - p + 1 + off] == pat[off]
        mask = np.zeros(n, dtype=bool)
        mask[:len(match)] = match
        self.bv = Bitvector.from_bits(mask)
        self.sel = SelectSupport(self.bv, value=1)
        self.total = self.sel.total

    def rank(self, i, inclusive=True):
        """# of occurrences starting at positions <= i (or < i)."""
        i = i if inclusive else i - 1
        if i < 0:
            return 0
        return int(self.bv.rank1_inclusive(min(i, self.bv.n - 1)))

    def select(self, k):
        """Start of the k-th (1-based) occurrence."""
        return int(self.sel.select(k))


# --------------------------------------------------------------------------
# LOUDS
# --------------------------------------------------------------------------

class TreeLOUDS:
    """Level-order unary degree sequence tree (reference compactds/
    Tree_LOUDS.hpp).  Handles are positions in the 2n-1-bit sequence B;
    node_map/node_select convert to/from BFS ids."""

    def __init__(self, bits, n):
        self.n = int(n)
        self.B = Bitvector.from_bits(bits)
        self.sel0 = SelectSupport(self.B, value=0)
        self.sel1 = SelectSupport(self.B, value=1)

    @classmethod
    def from_plain(cls, tree: PlainTree):
        order = tree.bfs_order()
        bits = []
        for v in order:
            bits.extend([1] * tree.children_count(v))
            bits.append(0)
        bits = bits[:2 * tree.n - 1]
        t = cls(np.array(bits, dtype=np.uint8), tree.n)
        id_map = [0] * tree.n
        for bfs_i, v in enumerate(order):
            id_map[v] = bfs_i
        t.id_map = id_map
        return t

    # rank helpers (inclusive)
    def _rank1(self, i):
        return int(self.B.rank1_inclusive(i)) if i >= 0 else 0

    def _rank0(self, i):
        return i + 1 - self._rank1(i) if i >= 0 else 0

    def _succ0(self, v):
        return int(self.sel0.select(self._rank0(v - 1) + 1))

    def _pred0(self, v):
        r = self._rank0(v)
        return -1 if r == 0 else int(self.sel0.select(r))

    def root(self):
        return 0

    def children_count(self, v):
        return self._succ0(v) - v

    def child_select(self, v, t):
        return int(self.sel0.select(self._rank1(v + t - 1))) + 1

    def first_child(self, v):
        return self.child_select(v, 1)

    def last_child(self, v):
        return self.child_select(v, self.children_count(v))

    def child_rank(self, v):
        if v == 0:
            return 0
        j = int(self.sel1.select(self._rank0(v - 1)))
        return j - self._pred0(j)

    def next_sibling(self, v):
        return self._succ0(v) + 1

    def prev_sibling(self, v):
        return self._pred0(v - 2) + 1

    def parent(self, v):
        if v == 0:
            return 0
        j = int(self.sel1.select(self._rank0(v - 1)))
        return self._pred0(j) + 1

    def is_leaf(self, v):
        return int(self.B.access(v)) == 0

    def lca(self, u, v):
        while u != v:
            if u > v:
                u = self.parent(u)
            else:
                v = self.parent(v)
        return u

    def is_ancestor(self, u, v):
        while v != 0 and v != u:
            v = self.parent(v)
        return v == u

    def depth(self, v):
        d = 0
        while v != 0:
            v = self.parent(v)
            d += 1
        return d

    def node_map(self, v):
        return self._rank0(v - 1)

    def node_select(self, i):
        return 0 if i == 0 else int(self.sel0.select(i)) + 1

    def nbytes(self):
        return self.B.nbytes() + self.sel0.nbytes() + self.sel1.nbytes()


# --------------------------------------------------------------------------
# Balanced parenthesis tree (BP)
# --------------------------------------------------------------------------

class TreeBP:
    """Preorder balanced-parenthesis tree (reference compactds/Tree_BP.hpp).
    Handles are positions of '(' in the 2n-bit sequence."""

    def __init__(self, bits, n):
        self.n = int(n)
        bits = np.asarray(bits).astype(np.uint8)
        self.m = len(bits)
        self.B = Bitvector.from_bits(bits)
        self.sel0 = SelectSupport(self.B, value=0)
        self.sel1 = SelectSupport(self.B, value=1)
        self.bp = BalancedParens(bits)
        self.leaves = PatternRankSelect(bits, (1, 0))   # "()" pattern

    @classmethod
    def from_plain(cls, tree: PlainTree):
        bits = np.zeros(2 * tree.n, dtype=np.uint8)
        id_map = [0] * tree.n
        bi = 0
        visited = 0
        stack = [(0, False)]
        while stack:
            v, closing = stack.pop()
            if closing:
                bi += 1
                continue
            bits[bi] = 1
            bi += 1
            id_map[v] = visited
            visited += 1
            stack.append((v, True))
            for c in reversed(tree.children[v]):
                stack.append((c, False))
        t = cls(bits, tree.n)
        t.id_map = id_map
        return t

    def _rank1(self, i):
        return int(self.B.rank1_inclusive(i)) if i >= 0 else 0

    def root(self):
        return 0

    def close(self, v):
        return self.bp.find_close(v)

    def child_select(self, v, t):
        return self.bp.find_open(
            self.bp.min_select(v + 1, self.close(v) - 1, t))

    def first_child(self, v):
        return v + 1

    def last_child(self, v):
        return self.bp.find_open(self.close(v) - 1)

    def children_count(self, v):
        if self.is_leaf(v):
            return 0
        return self.bp.min_count(v + 1, self.close(v) - 1)

    def child_rank(self, v):
        if v == 0:
            return 0
        p = self.parent(v)
        if p + 1 == v:
            return 1
        return self.bp.min_count(p + 1, v - 1) + 1

    def next_sibling(self, v):
        return self.close(v) + 1

    def prev_sibling(self, v):
        return self.bp.find_open(v - 1)

    def parent(self, v):
        if v == 0:
            return 0
        return self.bp.enclose(v)

    def is_leaf(self, v):
        return int(self.B.access(v + 1)) == 0

    def lca(self, u, v):
        if u > v:
            u, v = v, u
        if u == v:
            return u
        if self.is_ancestor(u, v):
            return u
        return self.bp.enclose(self.bp.rmq(u, v) + 1)

    def is_ancestor(self, u, v):
        return u <= v <= self.close(u)

    def node_map(self, v):
        return self._rank1(v - 1)

    def node_select(self, i):
        return int(self.sel1.select(i + 1))

    def post_order(self, v):
        c = self.close(v)
        return c + 1 - self._rank1(c) - 1

    def post_order_select(self, i):
        return self.bp.find_open(int(self.sel0.select(i + 1)))

    def depth(self, v):
        return 2 * self._rank1(v - 1) - v

    def subtree_size(self, v):
        return (self.close(v) - v + 1) // 2

    def leaf_count_in_subtree(self, v):
        return (self.leaves.rank(self.close(v)) - self.leaves.rank(v - 1))

    def leaf_rank(self, v, inclusive=True):
        return self.leaves.rank(v, inclusive)

    def leaf_select(self, i):
        return self.leaves.select(i)

    def nbytes(self):
        return (self.B.nbytes() + self.sel0.nbytes() + self.sel1.nbytes()
                + self.bp.nbytes())


# --------------------------------------------------------------------------
# DFUDS
# --------------------------------------------------------------------------

class TreeDFUDS:
    """Depth-first unary degree sequence tree (reference compactds/
    Tree_DFUDS.hpp).  Handles are node start positions in the 2n-1-bit
    sequence (per node: childcount '('s then one ')')."""

    def __init__(self, bits, n):
        self.n = int(n)
        bits = np.asarray(bits).astype(np.uint8)
        self.m = len(bits)
        self.B = Bitvector.from_bits(bits)
        self.sel0 = SelectSupport(self.B, value=0)
        self.sel1 = SelectSupport(self.B, value=1)
        self.bp = BalancedParens(bits)
        self.leaves = PatternRankSelect(bits, (0, 0))   # leaf = "00" boundary

    @classmethod
    def from_plain(cls, tree: PlainTree):
        bits = np.zeros(2 * tree.n - 1, dtype=np.uint8) if tree.n else np.zeros(0, np.uint8)
        id_map = [0] * tree.n
        bi = 0
        visited = 0
        stack = [0]
        while stack:
            v = stack.pop()
            id_map[v] = visited
            visited += 1
            cc = tree.children_count(v)
            bits[bi:bi + cc] = 1
            bi += cc + 1
            stack.extend(reversed(tree.children[v]))
        t = cls(bits, tree.n)
        t.id_map = id_map
        return t

    def _rank0(self, i):
        if i < 0:
            return 0
        return i + 1 - int(self.B.rank1_inclusive(i))

    def _succ0(self, v):
        return int(self.sel0.select(self._rank0(v - 1) + 1))

    def _pred0(self, v):
        r = self._rank0(v)
        return -1 if r == 0 else int(self.sel0.select(r))

    def root(self):
        return 0

    def children_count(self, v):
        return self._succ0(v) - v

    def child_select(self, v, t):
        cc = self.children_count(v)
        return self.bp.find_close(v + cc - t) + 1

    def first_child(self, v):
        return self._succ0(v) + 1

    def last_child(self, v):
        return self.bp.find_close(v) + 1

    def child_rank(self, v):
        if v == 0:
            return 0
        o = self.bp.find_open(v - 1)
        return self._succ0(o) - o

    def next_sibling(self, v):
        return self.bp.fwd_search(v, -1) + 1

    def prev_sibling(self, v):
        return self.bp.find_close(self.bp.find_open(v - 1) + 1) + 1

    def parent(self, v):
        if v == 0:
            return 0
        return self._pred0(self.bp.find_open(v - 1)) + 1

    def subtree_size(self, v):
        return (self.bp.fwd_search(v, -1) - v) // 2 + 1

    def is_ancestor(self, u, v):
        return u <= v <= self.bp.fwd_search(u, -1)

    def is_leaf(self, v):
        return int(self.B.access(v)) == 0

    def lca(self, u, v):
        if v < u:
            u, v = v, u
        if u == v or self.is_ancestor(u, v):
            return u
        return self.parent(self.bp.rmq(u, v - 1) + 1)

    def leaf_count_in_subtree(self, v):
        if self.is_leaf(v):
            return 1
        vend = self.bp.fwd_search(v, -1)
        return self.leaves.rank(vend - 1) - self.leaves.rank(v)

    def leaf_rank(self, v, inclusive=True):
        return self.leaves.rank(v - 1, inclusive)

    def leaf_select(self, i):
        return self.leaves.select(i) + 1

    def node_map(self, v):
        return self._rank0(v - 1)

    def node_select(self, i):
        return 0 if i == 0 else int(self.sel0.select(i)) + 1

    def nbytes(self):
        return (self.B.nbytes() + self.sel0.nbytes() + self.sel1.nbytes()
                + self.bp.nbytes())


# --------------------------------------------------------------------------
# Labeled ordinal tree
# --------------------------------------------------------------------------

class TreeLabeled(TreeLOUDS):
    """LOUDS tree whose edges carry labels; labels stored in the BFS edge
    order aligned with the 1-bits of B (reference compactds/Tree_Labeled.hpp).
    """

    @classmethod
    def from_plain(cls, tree: PlainTree):
        t = super().from_plain(tree)
        order = tree.bfs_order()
        labels = []
        for v in order:
            labels.extend(tree.get_label(c) for c in tree.children[v])
        t.edge_labels = np.asarray(labels, dtype=np.int64)
        return t

    def _edge_range(self, v):
        """Edge-label indices of v's children: labels[rank1(v-1) .. +cc)."""
        lo = self._rank1(v - 1)
        return lo, lo + self.children_count(v)

    def child_label(self, v):
        """Label of the edge into v (v != root)."""
        j = int(self.sel1.select(self._rank0(v - 1)))
        return int(self.edge_labels[self._rank1(j) - 1])

    def children_labeled(self, v, l):
        """# of children of v whose edge label == l."""
        lo, hi = self._edge_range(v)
        return int((self.edge_labels[lo:hi] == l).sum())

    def labeled_child_select(self, v, l, t):
        """t-th (1-based) child of v with edge label l."""
        lo, hi = self._edge_range(v)
        idx = np.flatnonzero(self.edge_labels[lo:hi] == l)
        return self.child_select(v, int(idx[t - 1]) + 1)

    def labeled_child(self, v, l):
        return self.labeled_child_select(v, l, 1)


# --------------------------------------------------------------------------
# Cardinal trees (succinct)
# --------------------------------------------------------------------------

class TreeCardinalLOUDS:
    """Cardinal tree as an n*c-bit LOUDS-style matrix: bit v*c+l set iff BFS
    node v has a child through slot l (reference compactds/
    Tree_Cardinal_LOUDS.hpp).  Handles are BFS node ids."""

    def __init__(self, bits, n, c):
        self.n, self.c = int(n), int(c)
        self.B = Bitvector.from_bits(bits)
        self.sel1 = SelectSupport(self.B, value=1)

    @classmethod
    def from_plain(cls, tree: CardinalPlainTree):
        order = tree.bfs_order()
        c = tree.c
        bits = np.zeros(tree.n * c, dtype=np.uint8)
        inv = {v: i for i, v in enumerate(order)}
        for i, v in enumerate(order):
            for l in range(c):
                if tree.slots[v][l] != -1:
                    bits[i * c + l] = 1
        t = cls(bits, tree.n, c)
        t.id_map = [inv[v] for v in range(tree.n)]
        return t

    def _rank1(self, i):
        return int(self.B.rank1_inclusive(i)) if i >= 0 else 0

    def root(self):
        return 0

    def children_count(self, v):
        return self._rank1(v * self.c + self.c - 1) - self._rank1(v * self.c - 1)

    def child_select(self, v, t):
        """t-th existing child (BFS id): children are numbered by edge rank."""
        return self._rank1(v * self.c - 1) + t

    def first_child(self, v):
        return self.child_select(v, 1)

    def last_child(self, v):
        return self.child_select(v, self.children_count(v))

    def has_labeled_child(self, v, l):
        return int(self.B.access(v * self.c + l)) == 1

    def labeled_child(self, v, l):
        """BFS id of child through slot l, or -1."""
        if not self.has_labeled_child(v, l):
            return -1
        return self._rank1(v * self.c + l)

    def children_labeled(self, v, l):
        return 1 if self.has_labeled_child(v, l) else 0

    def parent(self, v):
        if v == 0:
            return 0
        return int(self.sel1.select(v)) // self.c

    def child_label(self, v):
        """Slot label of the edge into v."""
        return int(self.sel1.select(v)) % self.c

    def child_rank(self, v):
        if v == 0:
            return 0
        j = int(self.sel1.select(v))
        p = j // self.c
        return self._rank1(j) - self._rank1(p * self.c - 1)

    def next_sibling(self, v):
        return v + 1

    def prev_sibling(self, v):
        return v - 1

    def is_leaf(self, v):
        return self.children_count(v) == 0

    def lca(self, u, v):
        while u != v:
            if u > v:
                u = self.parent(u)
            else:
                v = self.parent(v)
        return u

    def node_map(self, v):
        return v

    def node_select(self, i):
        return i

    def nbytes(self):
        return self.B.nbytes() + self.sel1.nbytes()


class TreeCardinalOrdinal(TreeBP):
    """Cardinal tree stored as an ordinal BP tree plus per-edge slot labels in
    preorder (reference compactds/Tree_Cardinal_Ordinal.hpp).  Handles are BP
    '(' positions."""

    @classmethod
    def from_plain(cls, tree: CardinalPlainTree):
        n = tree.n
        bits = np.zeros(2 * n, dtype=np.uint8)
        id_map = [0] * n
        labels = np.zeros(n, dtype=np.int64)
        bi = visited = 0
        stack = [(0, False)]
        while stack:
            v, closing = stack.pop()
            if closing:
                bi += 1
                continue
            bits[bi] = 1
            bi += 1
            id_map[v] = visited
            labels[visited] = tree.edge_label[v]
            visited += 1
            stack.append((v, True))
            for ch in reversed(tree.existing_children(v)):
                stack.append((ch, False))
        t = cls(bits, n)
        t.id_map = id_map
        t.edge_labels = labels      # indexed by preorder id
        return t

    def child_label(self, v):
        return int(self.edge_labels[self.node_map(v)])

    def labeled_child(self, v, l):
        """Handle of child through slot l, or -1."""
        cc = self.children_count(v)
        ch = v + 1 if cc else -1
        for _ in range(cc):
            if self.child_label(ch) == l:
                return ch
            ch = self.next_sibling(ch)
        return -1

    def has_labeled_child(self, v, l):
        return self.labeled_child(v, l) != -1

    def children_labeled(self, v, l):
        return 1 if self.has_labeled_child(v, l) else 0
