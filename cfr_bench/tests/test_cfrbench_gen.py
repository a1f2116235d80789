"""The read generator: the same seed gives the same bytes, and any read can
be made again alone."""

import numpy as np
import pytest

from cfr_bench.gen.db import Database
from cfr_bench.gen.reads import ReadGen
from cfr_bench.spec import load_json
from cfr_bench.tests.tiny import BENCH, TINY_AA, TINY_NT

MIXES = ["pe150", "se150", "ont"]


def db_of(kind):
    base = "aa128-protein" if kind == "aa" else "nt256-plain"
    cfg = dict(load_json("%s/configs/%s.json" % (BENCH, base)), **(TINY_AA if kind == "aa" else TINY_NT))
    return Database.make(cfg, cfg["db_seed"])


@pytest.fixture(scope="module")
def dbs():
    return {"nt": db_of("nt"), "aa": db_of("aa")}


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("kind", ["nt", "aa"])
def test_same_seed_same_bytes(dbs, kind, mix):
    t = load_json("%s/traffic/%s.json" % (BENCH, mix))
    seed = 2 ** 33 + 17
    a, b = ReadGen(dbs[kind], t, seed), ReadGen(dbs[kind], t, seed)
    for blk in (0, 3):
        x, y = a.block(blk), b.block(blk)
        assert x.fastq(1) == y.fastq(1)
        if x.r2 is not None:
            assert x.fastq(2) == y.fastq(2)
    assert a.block(0).fastq(1) != ReadGen(dbs[kind], t, seed + 1).block(0).fastq(1)
    assert a.block(0).fastq(1) != ReadGen(dbs[kind], t, seed, stream=1).block(0).fastq(1)


@pytest.mark.parametrize("mix", MIXES)
def test_read_made_again_alone(dbs, mix):
    t = load_json("%s/traffic/%s.json" % (BENCH, mix))
    gen = ReadGen(dbs["nt"], t, 99)
    B = gen.block_reads
    i = 2 * B + 5
    rid, m1, m2 = ReadGen(dbs["nt"], t, 99).reads([i])[i]
    blk = gen.block(2)
    assert rid == blk.read_id(5) == "r%010d" % i
    assert np.array_equal(m1, blk.mate(1, 5))
    assert (m2 is None) == (blk.r2 is None)
    if m2 is not None:
        assert np.array_equal(m2, blk.mate(2, 5))
    assert len(m1) == gen.block_lengths(2)[5]


def test_mix_follows_its_file(dbs):
    t = load_json("%s/traffic/pe150.json" % BENCH)
    blk = ReadGen(dbs["nt"], t, 5).block(0)
    assert blk.r2 is not None and np.all(np.diff(blk.offs1) == 150)
    kinds = np.bincount(blk.kinds, minlength=3) / blk.n
    assert abs(kinds[0] - 0.8) < 0.08 and abs(kinds[2] - 0.1) < 0.05


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("kind", ["nt", "aa"])
def test_fastq_reads_back(dbs, kind, mix, tmp_path):
    """Four lines a record, quality as long as the sequence, and the port's
    object-route reader gives back each read's id and bases."""
    from centrifuger_tpu_torch.io.readers import ReadFiles
    t = load_json("%s/traffic/%s.json" % (BENCH, mix))
    blk = ReadGen(dbs[kind], t, 7).block(1)
    for m in (1, 2) if blk.r2 is not None else (1,):
        data = blk.fastq(m)
        lines = data.split(b"\n")
        assert lines[-1] == b"" and (len(lines) - 1) == 4 * blk.n
        for j in range(blk.n):
            h, s, plus, q = lines[4 * j:4 * j + 4]
            assert h == b"@" + blk.read_id(j).encode() and plus == b"+"
            assert s == blk.mate(m, j).tobytes() and len(q) == len(s)
        path = tmp_path / ("m%d.fq" % m)
        path.write_bytes(data)
        rf = ReadFiles()
        rf.add_read_file(str(path))
        got = [(r.id, r.seq) for r in rf]
        assert got == [(blk.read_id(j), blk.mate(m, j).tobytes().decode()) for j in range(blk.n)]
