"""The port's Ψ-based compressed suffix array
(centrifuger_tpu_torch/succinct/csa.py) against the JAX package's: psi,
lookup, inverse, count and nbytes equal on the same text, with sa= from the
brute-force sort and from the port's native suffix_array (and, on a short
text, the constructor's own sort), and held to the brute-force truth as
tests/test_csa.py does."""

import numpy as np
import pytest

from test_csa import brute_sa
from test_torch_succinct import both, query


def make(seed, n, sigma, terminator):
    text = np.random.default_rng(seed).integers(0, sigma, n).astype(np.int64)
    if terminator:
        text[-1] = 0
    return text


@pytest.mark.parametrize("seed,n,sigma,rate,terminator", [
    (5, 800, 4, 8, True), (9, 600, 4, 16, True), (3, 700, 4, 4, False),
    (4, 500, 21, 8, False), (6, 300, 2, 1, False)])
@pytest.mark.parametrize("sa_from", ["brute", "suffix_array"])
def test_csa(seed, n, sigma, rate, terminator, sa_from):
    from centrifuger_tpu_torch.fm.suffix_array import suffix_array
    text = make(seed, n, sigma, terminator)
    sa = brute_sa(text)
    if sa_from == "suffix_array":
        native = suffix_array(text.astype(np.uint8), sigma)
        assert np.array_equal(native, sa)    # the same suffix order as the sort
        sa = native
    csa, jcsa = both(lambda pk: pk.csa.CompressedSuffixArray(text, sa, sample_rate=rate,
                                                             sigma=sigma))
    isa = np.empty(n, np.int64)
    isa[sa] = np.arange(n)
    psi_true = isa[(sa + 1) % n]
    for i in range(n):
        assert query(csa, jcsa, "psi", i) == psi_true[i]
        assert query(csa, jcsa, "sym_of_row", i) == text[sa[i]]
    assert (query(csa, jcsa, "psi_batch", np.arange(0, n, 3)) == psi_true[::3]).all()
    for i in range(0, n, 3):
        assert query(csa, jcsa, "lookup", i) == sa[i]
        assert query(csa, jcsa, "inverse", i) == isa[i]
    joined = "".join(chr(65 + c) for c in text)
    pats = [text[i:i + m] for m in (1, 2, 3, 5, 8) for i in range(0, n - 8, 29)]
    pats += [np.full(12, sigma - 1), np.array([sigma - 1] * 3 + [0] * 9)]
    for pat in pats:
        got = query(csa, jcsa, "count", pat)
        pstr = "".join(chr(65 + c) for c in pat)
        truth = sum(1 for i in range(n - len(pat) + 1) if joined[i:i + len(pat)] == pstr)
        assert abs(got - truth) <= 1  # a cyclic rotation at the tail adds at most 1
    assert query(csa, jcsa, "nbytes") == jcsa.nbytes()


def test_csa_constructor_sort_and_space():
    text = make(1, 400, 4, True)
    csa, _ = both(lambda pk: pk.csa.CompressedSuffixArray(text, sample_rate=8))
    sa = brute_sa(text)
    assert all(csa.lookup(i) == sa[i] for i in range(0, 400, 5))
    text = make(1, 4000, 4, True)
    csa, jcsa = both(lambda pk: pk.csa.CompressedSuffixArray(text, brute_sa(text),
                                                             sample_rate=32))
    assert query(csa, jcsa, "nbytes") < 8 * len(text)   # beats the plain 8-byte SA
