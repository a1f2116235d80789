# Port copy of centrifuger_tpu.succinct.hashing (host code, no accelerator).
"""Universal hashing and minimal perfect hashing.

Library counterparts of the reference's compactds/UniversalHashGenerator.hpp
and compactds/PerfectHash.hpp.  The MPH is the BDZ / 3-hypergraph peeling
construction: 3 universal hash functions map each key to vertices of a
hypergraph of size ~1.23n; peeling orders the keys so each has a free vertex,
and a 2-bit-per-vertex table makes g(h0)+g(h1)+g(h2) mod 3 pick that vertex.
"""

import numpy as np

from .bits import FixedArray

_P = (1 << 61) - 1  # Mersenne prime


class UniversalHash:
    """(a*x + b) mod p mod m family (reference
    compactds/UniversalHashGenerator.hpp)."""

    def __init__(self, m, seed=0):
        rng = np.random.default_rng(seed)
        self.a = int(rng.integers(1, _P))
        self.b = int(rng.integers(0, _P))
        self.m = int(m)

    def __call__(self, x):
        x = np.asarray(x, dtype=np.uint64).astype(object)  # exact big-int math
        return np.array([(self.a * int(v) + self.b) % _P % self.m for v in x],
                        dtype=np.int64)


class PerfectHash:
    """Minimal perfect hash over a static key set (reference
    compactds/PerfectHash.hpp)."""

    def __init__(self, keys, gamma=1.23, max_tries=64):
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        assert len(np.unique(keys)) == n, "keys must be distinct"
        self.n = n
        m3 = max(int(np.ceil(gamma * n / 3)), 2)
        self.m = 3 * m3
        for attempt in range(max_tries):
            hs = [UniversalHash(m3, seed=1000 * attempt + j) for j in range(3)]
            hv = np.stack([hs[j](keys) + j * m3 for j in range(3)], axis=1)
            order = self._peel(hv, n)
            if order is not None:
                self.hashes = hs
                self.m3 = m3
                self._assign(hv, order)
                return
        raise RuntimeError("PerfectHash: peeling failed; raise gamma")

    def _peel(self, hv, n):
        """Peel the 3-hypergraph: repeatedly remove a key whose some vertex has
        degree 1.  Returns key order (reverse assignment order) or None."""
        deg = np.zeros(self.m, dtype=np.int64)
        for j in range(3):
            np.add.at(deg, hv[:, j], 1)
        # adjacency: vertex -> xor of incident key ids and count
        xor_keys = np.zeros(self.m, dtype=np.int64)
        for j in range(3):
            np.bitwise_xor.at(xor_keys, hv[:, j], np.arange(n))
        stack = list(np.flatnonzero(deg == 1))
        removed = np.zeros(n, dtype=bool)
        order = []
        while stack:
            v = stack.pop()
            if deg[v] != 1:
                continue
            k = xor_keys[v]
            if removed[k]:
                continue
            removed[k] = True
            order.append((k, v))
            for j in range(3):
                u = hv[k, j]
                deg[u] -= 1
                xor_keys[u] ^= k
                if deg[u] == 1:
                    stack.append(u)
        if len(order) != n:
            return None
        return order

    def _assign(self, hv, order):
        g = np.full(self.m, 3, dtype=np.int64)  # 3 = unassigned
        used = np.zeros(self.m, dtype=bool)
        for k, v in reversed(order):
            vs = hv[k]
            j = int(np.flatnonzero(vs == v)[0])
            s = 0
            for t in range(3):
                if vs[t] != v and g[vs[t]] != 3:
                    s += g[vs[t]]
            g[v] = (j - s) % 3
            used[v] = True
        g[g == 3] = 0
        self.g = FixedArray.from_values(g.astype(np.uint64), 2)
        # rank over chosen vertices for minimality
        chosen = np.zeros(self.m, dtype=bool)
        for k, v in order:
            chosen[v] = True
        from .bitvector import Bitvector
        self.chosen = Bitvector.from_bits(chosen)

    def lookup(self, keys):
        """Vectorized MPH value in [0, n) (correct only for member keys)."""
        keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
        hv = np.stack([self.hashes[j](keys) + j * self.m3 for j in range(3)],
                      axis=1)
        gsum = (self.g.read(hv[:, 0]) + self.g.read(hv[:, 1])
                + self.g.read(hv[:, 2])).astype(np.int64) % 3
        v = hv[np.arange(len(keys)), gsum]
        return (self.chosen.rank1_inclusive(v) - 1).astype(np.int64)

    def nbytes(self):
        return self.g.nbytes() + self.chosen.nbytes()
