"""The port's Ψ-based compressed suffix array
(centrifuger_tpu_torch/succinct/csa.py) against the JAX package's: psi,
lookup, inverse, count and nbytes equal on the same text, with sa= from the
brute-force sort and from the port's native suffix_array (and, on a short
text, the constructor's own sort), and held to the brute-force truth as
tests/test_csa.py does.

count is the one method where the two packages part: the port's count equals
brute force exactly, while the JAX method can be one off where the pattern
runs over the text's last symbol (its length-1 suffix is counted as if it
could extend). The JAX value is recorded there, not asserted equal."""

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
    pats = [text[i:i + m] for m in (1, 2, 3, 5, 8) for i in range(0, n - 8, 29)]
    pats += [np.full(12, sigma - 1), np.array([sigma - 1] * 3 + [0] * 9)]
    pats += [text[n - m:] for m in (1, 2, 5, 12)]          # runs to the text's end
    jax_off = []
    for pat in pats:
        got, truth = csa.count(pat), brute_count(text, pat)
        assert got == truth, (pat, got, truth)
        jgot = jcsa.count(pat)
        if jgot != truth:
            jax_off.append((pat.tolist(), jgot, truth))
    # the JAX package's known fault: never more than one off
    assert all(abs(j - t) == 1 for _, j, t in jax_off), jax_off
    assert query(csa, jcsa, "nbytes") == jcsa.nbytes()


def brute_count(text, pat):
    """Occurrences of pat in text, overlapping ones included."""
    m = len(pat)
    if m > len(text):
        return 0
    win = np.lib.stride_tricks.sliding_window_view(np.asarray(text), m)
    return int((win == np.asarray(pat)).all(axis=1).sum())


def test_count_repro_last_symbol_step():
    """The first differing count: the port and brute force give 1, the JAX
    package 0 (the pattern steps over the text's last symbol, 2)."""
    from centrifuger_tpu.succinct.csa import CompressedSuffixArray as JaxCSA
    from centrifuger_tpu_torch.fm.suffix_array import suffix_array
    from centrifuger_tpu_torch.succinct.csa import CompressedSuffixArray
    text = np.random.default_rng(3).integers(0, 4, 600).astype(np.uint8)
    sa = suffix_array(text, 4)
    pat = text[134:146]
    assert pat.tolist() == [2, 0, 3, 3, 3, 2, 3, 2, 2, 3, 2, 3] and text[-1] == 2
    assert brute_count(text, pat) == 1
    assert CompressedSuffixArray(text, sa).count(pat) == 1
    assert JaxCSA(text, sa).count(pat) == 0


@pytest.mark.parametrize("seed,n,sigma", [
    (11, 7, 4), (12, 60, 2), (13, 600, 4), (14, 2000, 21), (15, 20000, 4),
    (16, 3000, 3)])
def test_count_property(seed, n, sigma):
    """~340 patterns a text (2,040 in all), lengths 1-12, half cut from the
    text and half drawn at random (mostly absent), each equal to brute force."""
    from centrifuger_tpu_torch.fm.suffix_array import suffix_array
    from centrifuger_tpu_torch.succinct.csa import CompressedSuffixArray
    rng = np.random.default_rng(seed)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    csa = CompressedSuffixArray(text, suffix_array(text, sigma), sample_rate=8,
                                sigma=sigma)
    present = 0
    for k in range(340):
        m = int(rng.integers(1, 13))
        if k % 2 and m <= n:
            i = int(rng.integers(0, n - m + 1))
            pat = text[i:i + m]
        else:
            pat = rng.integers(0, sigma, m).astype(np.uint8)
        truth = brute_count(text, pat)
        present += truth > 0
        assert csa.count(pat) == truth, (pat.tolist(), truth)
    assert 0 < present < 340


def test_csa_constructor_sort_and_space():
    text = make(1, 400, 4, True)
    csa, _ = both(lambda pk: pk.csa.CompressedSuffixArray(text, sample_rate=8))
    sa = brute_sa(text)
    assert all(csa.lookup(i) == sa[i] for i in range(0, 400, 5))
    text = make(1, 4000, 4, True)
    csa, jcsa = both(lambda pk: pk.csa.CompressedSuffixArray(text, brute_sa(text),
                                                             sample_rate=32))
    assert query(csa, jcsa, "nbytes") < 8 * len(text)   # beats the plain 8-byte SA
