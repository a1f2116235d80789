"""The plain reference against the reference binary's goldens."""

import os

import numpy as np
import pytest

from cfr_bench.reference.classify import RefClassifier
from cfr_bench.reference.index import build_state
from cfr_bench.reference.taxonomy import Taxonomy

FX = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                  "tests", "fixtures")
CASES = {"tiny": (True, False), "small": (True, False), "tiny_single": (False, False),
         "tiny_protein": (False, True)}


def fastq(path):
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    out = []
    for i in range(0, len(lines) - 3, 4):
        rid = lines[i][1:].split()[0].decode()
        out.append((rid[:-2] if rid[-2:] in ("/1", "/2") else rid,
                    np.frombuffer(lines[i + 1], np.uint8)))
    return out


def fixture_rows(name, k, score_dtype=None):
    paired, protein = CASES[name]
    d = os.path.join(FX, name)
    tax = Taxonomy(d + "/nodes.dmp", d + "/names.dmp", d + "/ref_seqid.map")
    ix = build_state(d + "/ref.fa", tax, protein, 4 if protein else 10, 16, None, "cpu")
    r1 = fastq(d + "/reads_1.fq")
    r2 = fastq(d + "/reads_2.fq") if paired else [(None, None)] * len(r1)
    reads = [(a[0], a[1], b[1]) for a, b in zip(r1, r2)]
    rows = RefClassifier(ix, tax, k=k, score_dtype=score_dtype).rows(reads)
    got = [row for rid, _, _ in reads for row in rows[rid]]
    with open(os.path.join(d, "golden_class_k%d.tsv" % k)) as f:
        want = [w for w in f.read().split("\n")[1:] if w]
    return got, want


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_reproduces_goldens(name, k):
    got, want = fixture_rows(name, k)
    assert got == want


@pytest.mark.parametrize("name", ["small", "tiny", "tiny_single"])
def test_control_misses_goldens(name):
    """The control (float16 scores) gives other rows than the binary.  Not
    on tiny_protein: its 100 bp single reads score under 2,048, which
    float16 holds exactly (the 150 bp pairs of the protein cell do not)."""
    got, want = fixture_rows(name, 1, np.float16)
    assert sum(a != b for a, b in zip(got, want)) > 0
