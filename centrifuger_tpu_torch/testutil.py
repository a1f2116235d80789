# Port copy of centrifuger_tpu.testutil (host code, no accelerator).
"""In-memory synthetic index construction for entry points, benchmarks and tests."""

import numpy as np

from .fm.builder import FMBuildParams, build_fm


def synthetic_fm(n_genomes=4, genome_len=30000, seed=0, sample_rate=16,
                 precompute_width=10, rbbwt_b=0, runs=True):
    """Build an FMIndexData over random genomes (codes 0..3). Returns
    (fm, genomes) where genomes is the list of code arrays."""
    rng = np.random.default_rng(seed)
    genomes = []
    for i in range(n_genomes):
        g = rng.integers(0, 4, genome_len).astype(np.uint8)
        if runs:
            # sprinkle homopolymer runs so the run-block structure is exercised
            for _ in range(max(1, genome_len // 2000)):
                p = rng.integers(0, genome_len - 50)
                g[p:p + rng.integers(10, 50)] = rng.integers(0, 4)
        genomes.append(g)
    codes = np.concatenate(genomes)
    lens = [len(g) for g in genomes]
    params = FMBuildParams(sample_rate=sample_rate,
                           precompute_width=precompute_width, rbbwt_b=rbbwt_b)
    fm = build_fm(codes, lens, np.arange(n_genomes), "ACGT", params)
    return fm, genomes


def sample_reads(genomes, n_reads, read_len, seed=1, err=0.005):
    """Sample error-injected reads (uint8 byte arrays of ACGT/N)."""
    rng = np.random.default_rng(seed)
    to_char = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.array([3, 2, 1, 0], dtype=np.uint8)
    reads = []
    for _ in range(n_reads):
        gi = rng.integers(0, len(genomes))
        g = genomes[gi]
        pos = rng.integers(0, len(g) - read_len)
        frag = g[pos:pos + read_len].copy()
        if rng.random() < 0.5:
            frag = comp[frag][::-1]
        errs = rng.random(read_len) < err
        frag = np.where(errs, rng.integers(0, 4, read_len).astype(np.uint8), frag)
        b = to_char[frag].copy()
        ns = rng.random(read_len) < err * 0.2
        b[ns] = ord("N")
        reads.append(b)
    return reads
