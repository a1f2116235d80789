#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives centrifuger_tpu_torch's paths through the kernels built from this
checkout and holds every kernel to its plain PyTorch twin:

  main  paired-end nucleotide cfr-classify, fused engine, plain serving layout
  B     the same index and reads with --serve-layout runblock (the mega-table)
  A     protein (translated) classify: a --protein index, nucleotide reads
  C     a nucleotide index built with --ftabchars 12 (wide ftab)
  D     the main index loaded as an int64 index (force_idtype="int64", K9)
  E     the non-fused engine (--engine jax), long reads and -k 0
  F     the main index served sharded (--shards N, K10), and the data-parallel
        step (classify_dp_step, K11)
  G     the main reads' read 1 single-end through the bulk FASTQ route (native
        parse and pack), with and without the wide-row cache file
  H     the read-prep flags (barcodes, UMIs, --read-format, --un / --cl,
        --merge-readpair, a sample sheet)
  I     --n-ranks 2 and cfr-merge-shards-torch
  J     the reference-built .cfr indexes (nucleotide and protein)
  K12   the dependent-gather microbenchmark (tools/micro_gather.py)
  L     the main DB through the chunked, memory-bounded builder
        (cfr-build-torch -t 8 --build-mem 2G --bmax 4194304 --checkpoint
        --emit-cfr) and the written .cfr index classified on the card
  M     the downstream CLIs (cfr-quant-torch, cfr-kreport-torch,
        cfr-promote-torch, cfr-inspect-torch) on the main path's TSV
  N     the succinct library (host code) at the main index's scale, its
        sequences' rank held to rank_probe on the card
  O     cfr-download-torch from a local mirror, then cfr-build-torch over two
        downloaded genomes and classify on the card and on the CPU

Phases (any failure exits non-zero and prints no result):

  1. the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels (one nvcc per source, in parallel); the three
     synthetic databases are made and indexed meanwhile, one process each,
     and a fourth process indexes the main DB's genomes again with the
     chunked builder (path L); each build's seconds and peak RSS
  3. goldens on the card: the tests/fixtures indexes built by the port,
     classified by the port's CLI on cuda, byte-identical to the goldens
     (nucleotide with the plain and the runblock layout, with and without
     --no-rowmap; tiny_protein); cfr-quant-torch (formats 0 and 3) on each
     fixture's golden_class_k1.tsv, and cfr-kreport-torch and
     cfr-promote-torch on tiny, byte-identical to their goldens
  4. the main path at size: a seeded synthetic DB (default 64 Mnt: 20
     genomes, every odd one a 3% mutant of the one before, with inverted
     repeats), built with the port's builder (rowmap included), and 65,536
     paired 100 bp reads classified through the CLI in batches of 8,192 pairs;
     every kernel of the path must have launched during this run
  5. the same run with --no-rowmap (the LF-walk resolve): the same TSV
  B. the same index loaded with --serve-layout runblock: the same TSV
  A. a seeded synthetic protein DB (default 32 M amino acids: 20 proteomes,
     every odd one a 3% mutant of the one before, 2% of the proteins shared by
     all even ones) and 65,536 paired 100 bp reads back-translated from it
  C. the first five genomes of the main DB (16 Mnt) indexed with
     --ftabchars 12 and 8,192 read pairs
  D. the main index and reads again through the CLI, its classifier made
     with force_idtype="int64" (TorchFM.from_index(fm, force_idtype="int64"),
     what a database past 2^31 - 8 symbols loads as): plain with the rowmap,
     plain with --no-rowmap, and --serve-layout runblock (which an int64 index
     serves as generic); each TSV equals the main path's and every launch is
     an ":i64" instantiation.  Then an offset-rows rank of 2^20 random rows
     (every occ + O, O = 5 * 2^32 + 12,345): the 40-bit occ's hi byte, held
     to its twin and to the original rank plus O.
  E. the main index and reads through --engine jax (the non-fused engine):
     the main path's TSV; 1,024 single-end reads of 9,000-20,000 bp drawn
     from the main DB with 1% substitutions through the default engine,
     which hands them to the non-fused engine; and -k 0 on the first 8,192
     pairs.  The long reads and -k 0 are held to a --device cpu run of their
     first 128 reads / pairs.
  F. the main index and reads through the CLI with --shards 2 (all 65,536
     pairs), --shards 4 --no-rowmap, the int64 classifier with shards=2 and
     --engine jax --shards 2 (the first 8,192 pairs each): the big tables cut
     into shards (all on the one card where there is one; over two cards with
     peer access as well where there are two), every launch a plain_sharded
     instantiation, each TSV the main path's (or its head); one batch split
     over two views of cuda:0 (the split and gather of several cards) equal
     to the one-view program.  K11: classify_dp_step on one batch's 32,768
     code lanes of 128 over [cuda:0] and over [cuda:0, cuda:0], and from a
     host index's replica on cuda:0, equal to each other and to the plain
     versions.
  G. the main index with the 65,536 read 1 records single-end (-u) through
     the CLI's bulk route twice: first with no <prefix>.serve_plain_w.npz
     (the run builds the wide rows and writes the file), then from the file;
     then the same file on stdin (-u -), which takes the object route; the
     three TSVs equal; each run's index-load seconds.
  H. the first 8,192 pairs of main with seeded barcode and UMI reads (a
     whitelist, 1-bp errors), --read-format and --un / --cl; with mates
     rewritten to overlap read 1 and --merge-readpair; cut into a two-sample
     --sample-sheet: each run's TSV, dumps and per-sample files equal to the
     same run with --device cpu.
  I. --n-ranks 2 (each rank through the CLI with its --rank-index) merged by
     cfr-merge-shards-torch, equal to the single run: the 65,536 pairs (the
     main path's TSV) and the bulk route's reads (path G's TSV).
  J. tests/fixtures/tiny/refidx (.cfr) on the card: golden_class_k1.tsv,
     and no cache file written beside it; tests/fixtures/tiny_protein/refidx
     (the one-tree protein .cfr) read with its self-check timed, then
     classified on the card at -k 1, 2 and 5 (the K7 generic chain, then K3
     with K2 inline; K5 and a K2 launch only for fallback units):
     golden_class_k1/k2/k5.tsv, and no file written beside it.
  K12. the dependent-gather microbenchmark through its driver, then its
     kernel against its twin.
  L. the chunked build of phase 2 (about 16 chunks of at most 2^22
     suffixes, so the ~10% state checkpoint is written; the rowmap captured,
     its 4 bytes a symbol within the budget): its peak RSS growth over the
     build's start (the .cfr write included) within --build-mem 2G, with the
     bmax it chose; its .fm.npz and .rowmap.npz arrays equal the main
     index's; a DB of the main DB's first two genomes built chunked with
     --checkpoint --bmax 262144, stopped after its first state checkpoint
     and run again at --bmax 524288 (it starts afresh: another chunk plan),
     its arrays equal that DB's SA-IS build's; the port's builds of the
     tiny and small fixtures written by its .cfr writer, byte for byte the
     reference-built refidx.1.cfr; the main build's four .cfr files, copied
     to a prefix of their own, read back through the port's reader (the
     main index's n, first_isa, sampled SA, BWT and lengths; no rowmap) and
     classify the first 8,192 main pairs on cuda to the head of the main
     path's TSV, K1-K5 launched and K2 by LF walk; the .cfr write and read
     seconds.
  M. the main path's 65,536-pair TSV through cfr-quant-torch -x main in
     formats 0-3 (-c file, the native ingest, equal to -c -, the line
     loop; each run's seconds), cfr-kreport-torch with and without --no-lca
     (the root clade count plus the unclassified count make the TSV's
     distinct read ids), cfr-promote-torch at genus and lca, and
     cfr-inspect-torch with each of its six flags.
  N. rank_probe's rank and symbol of 65,536 seeded (symbol, row) queries of
     the main BWT on the card (rows 0, first_isa and its neighbours, n - 1
     among them; the FM's exclusive occ reconciled with them), then, in three
     processes of their own beside path O and phase 6: SequencePlain,
     SequenceWavelet (plain and Huffman shaped), SequenceRunLength and
     SequenceHybrid over the 64 M-symbol BWT, each query's rank and access
     equal the card's; a CompressedSuffixArray over the first genome with
     sa= the native SA-IS suffix array (4,096 lookup and inverse against the
     SA, 1,024 counts of 8-32-symbol patterns equal to numpy's k-mer
     counts); a PerfectHash of 10^6 distinct 31-mers (a bijection onto
     [0, n)); PartialSum over the sequence lengths (65,536 searches against
     np.searchsorted), CompactMapper over the taxids, a Permutation of 10^6
     with t = 8 (next, and 4,096 prev against np.argsort); HuffmanCode over
     the BWT's symbol counts and Elias gamma / delta of its run lengths, each
     a round trip of 10^6 values; TreeLOUDS, TreeBP and TreeDFUDS over a
     random tree of 10^6 nodes held op by op to PlainTree at 10,000 nodes.
     Each structure's build seconds and bytes an element.
  O. a mirror of the NCBI paths (the refseq bacteria assembly summary with a
     row per main DB genome and two the filters drop, each genome gzipped,
     the taxdump); cfr-download-torch -P 4 refseq, the same with -f, and
     taxonomy, its fetch copying from the mirror and urlopen replaced by one
     that fails the path: the printed map equals the main DB's conversion
     table, nodes.dmp and names.dmp the smoke's; cfr-build-torch over the
     first two downloaded genomes with that map and taxonomy; the first
     8,192 main pairs classified from it on the card and with --device cpu,
     the two TSVs identical.  Each step's seconds.
     Each path's run is its reads through the CLI, then the public rank,
     BackwardExtend and LF of the same index and layout at 4,096 rows, held
     to the host index.
     Each path: the launch counts of its own run, pairs/s through the CLI, the
     steady-state engine rate, the device's busy time and idle share in one
     profiled pass ("not measured" where the profiler did not keep every
     launch of the port's kernels that the wrappers counted), peak device
     memory, and the head of its TSV against a
     --device cpu run (the plain twins).
  6. each kernel the paths launched against its plain twin on the same CUDA
     tensors at the path's shapes, timed by CUDA events around the wrapper
     call (the host's enqueue included) and by device time (events behind a
     spin kernel that hides the enqueue; a PyTorch call that computes the
     same function, where there is one, both ways too): chain_search and
     finalize_units on one batch of 8,192 pairs (on path A fed by
     translate_frames, K13, on the batch's mates; on the main index, path B
     and path D generic also with the rowmap off: the warp LF-walk resolve
     of --no-rowmap), prefix_search and resolve_rows on the very tensors the
     host finish stage hands them for a batch (resolve_rows with the rowmap
     and, with its LF-walk step count, without), rank_probe (one rank, one
     extend, one LF of each layout) at the batch's lane count, one rank of
     2^20 random rows per layout, and rank_probe's group modes (extend and
     LF through Lanes<Layout>, a warp a query, as every kernel of a lane
     runs them) on 2^20 queries per layout, beside the one-thread modes; the
     int64 instantiations of path D the same way; for each run of path E
     (--engine jax, the long reads, -k 0) chain_search_lanes, prefix_search
     and resolve_rows on the very tensors the non-fused engine hands them for
     the run's first batch (all 1,024 long reads are one batch: 2,048 lanes
     of 20,032 codes); path F's plain_sharded instantiations (int32 and
     int64, and --engine jax's) the same ways, beside the unsharded kernels'
     times of this run; classify_dp_step (K11); and dep_gather at the
     probe's shape.

The second-to-last stdout line is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.  Logs go to chiprun_out/, and so does a copy
of the standard output (smoke_stdout.txt).

  python3 chip_smoke.py [--db-nt N] [--db-aa N] [--seed S]
"""

import argparse
import collections
import contextlib
import functools
import gc
import io
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
OUT = os.path.join(REPO, "chiprun_out")
HBM_BYTES_PER_MS = 3.35e12 / 1e3      # H100 SXM HBM3, NVIDIA data sheet
OPS_PER_MS = 67e12 / 1e3              # H100 SXM float32 peak (no integer entry
                                      # in the data sheet; int32 is no faster)
OPS_PER_TABLE_BYTE = 2                # ~8 integer ops (xor, not, shifts, and,
                                      # popc, add) per 4-byte rank word read
BATCH_PAIRS = 8192
N_PAIRS = 65536
READ_LEN = 100
N_GENOMES = 20
FTAB12_GENOMES = 5                    # path C: the main DB's first genomes
FTAB12_PAIRS = 8192
CPU_PAIRS = {"main": 8192, "protein": 8192, "ftab12": 2048,   # TSV head run on the CPU
             "long": 128, "k0": 128}
MANY_ROWS = 1 << 20                   # rank_probe: rows of the per-layout timing
N_LONG = 1024                         # path E: long single-end reads, 9-20 kbp
LONG_LEN = (9000, 20000)
K0_PAIRS = 8192                       # path E: -k 0 on the first pairs
OFFSET = 5 * 2 ** 32 + 12345          # path D: the offset-rows constant O
CHUNKED_BUILD = ["-t", "8", "--build-mem", "2G", "--bmax", "4194304", "--checkpoint",
                 "--emit-cfr"]        # path L: the main DB through the chunked builder
CHUNKED_BUDGET_MB = 2048              # path L: the --build-mem above, in MB
RESUME_BMAX = (262144, 524288)        # path L: the resume check's two --bmax
INSPECT_FLAGS = ("--summary", "--conversion-table", "--taxonomy-tree", "--name-table",
                 "--size-table", "--index-size")
SUCCINCT_QUERIES = 65536              # path N: rank / access of the BWT, PartialSum searches
CSA_QUERIES, CSA_PATTERNS = 4096, 1024  # path N: CSA lookup / inverse (and Permutation prev),
                                      # counts of 8-32-symbol patterns
N_KEYS = 1_000_000                    # path N: PerfectHash keys, Permutation, code round trips
N_TREE, TREE_SAMPLE = 1_000_000, 10_000  # path N: tree nodes, nodes held op by op
PERM_T = 8
AA_LETTERS = "ARNDCEQGHILKMFPSTWYV"   # codes 1..20 of the protein alphabet
FX = os.path.join(REPO, "tests", "fixtures")
CSRC = "centrifuger_tpu_torch/kernels/csrc/%s.cu"


def fail(msg):
    sys.stderr.write("chip_smoke FAILED: %s\n" % msg)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


class Tee:
    """Writes to the standard output and to a file."""

    def __init__(self, stream, path):
        self.stream, self.file = stream, open(path, "w")

    def write(self, text):
        self.file.write(text)
        return self.stream.write(text)

    def flush(self):
        self.file.flush()
        self.stream.flush()


# ------------------------------------------------------------ synthetic data

def make_taxonomy(n_genomes):
    """root(1) - phylum(10) - genus(100 + i//2) - species(1000 + i) -
    strain(10000 + i), the tree of tools/make_fixture.py."""
    nodes = {1: (1, "no rank"), 10: (1, "phylum")}
    names = {1: "root", 10: "Testphylum"}
    seq_taxids = []
    for i in range(n_genomes):
        genus, species, strain = 100 + i // 2, 1000 + i, 10000 + i
        if genus not in nodes:
            nodes[genus] = (10, "genus")
            names[genus] = "Genus_%d" % genus
        nodes[species] = (genus, "species")
        names[species] = "Species_%d" % species
        nodes[strain] = (species, "strain")
        names[strain] = "Strain_%d" % strain
        seq_taxids.append(strain)
    return nodes, names, seq_taxids


def write_taxonomy(d, seq_names, seq_taxa):
    """nodes.dmp / names.dmp of the N_GENOMES taxa and the seqid map."""
    nodes, names, taxids = make_taxonomy(N_GENOMES)
    with open(os.path.join(d, "ref_seqid.map"), "w") as f:
        f.writelines("%s\t%d\n" % (s, taxids[t]) for s, t in zip(seq_names, seq_taxa))
    with open(os.path.join(d, "nodes.dmp"), "w") as f:
        f.writelines("%d\t|\t%d\t|\t%s\t|\n" % (t, *nodes[t]) for t in sorted(nodes))
    with open(os.path.join(d, "names.dmp"), "w") as f:
        f.writelines("%d\t|\t%s\t|\t\t|\tscientific name\t|\n" % (t, names[t])
                     for t in sorted(names))


def make_genomes(n_nt, seed):
    """N_GENOMES code arrays; every odd genome is a 3% point mutant of the one
    before (sister strains), and each new genome carries inverted repeats
    (1 kb segments copied reverse-complemented) so that some reads hit both
    strands and take the boundary-adjustment path."""
    rng = np.random.default_rng(seed)
    glen = n_nt // N_GENOMES
    genomes, prev = [], None
    for i in range(N_GENOMES):
        if i % 2 == 1:
            g = prev.copy()
            pos = rng.integers(0, glen, int(0.03 * glen))
            g[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        else:
            g = rng.integers(0, 4, glen, dtype=np.uint8)
            for _ in range(max(1, glen // 500_000)):
                a, b = rng.integers(0, glen - 1000, 2)
                g[b:b + 1000] = 3 - g[a:a + 1000][::-1]
            prev = g
        genomes.append(g)
    return genomes


def write_fasta(path, names, seqs, letters):
    table = np.frombuffer(letters.encode(), np.uint8)
    with open(path, "wb") as f:
        for name, g in zip(names, seqs):
            f.write(b">%s\n" % name.encode())
            s = table[g]
            pad = (-len(s)) % 70
            rows = np.concatenate([s, np.zeros(pad, np.uint8)]).reshape(-1, 70)
            out = np.concatenate([rows, np.full((len(rows), 1), 10, np.uint8)], 1)
            out = out.reshape(-1)
            f.write(out[out != 0].tobytes())


def write_db(genomes, d):
    names = ["SEQ_%06d" % i for i in range(len(genomes))]
    write_fasta(os.path.join(d, "ref.fa"), names, genomes, "ACGT")
    write_taxonomy(d, names, range(len(genomes)))


def write_pair(f1, f2, i, frag, rng):
    """One read pair from a fragment of nucleotide codes: half of the fragments
    reverse complemented, 0.5% substitutions."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if rng.random() < 0.5:
        frag = 3 - frag[::-1]
    mates = [frag[:READ_LEN].copy(), (3 - frag[-READ_LEN:][::-1]).copy()]
    for m, f in zip(mates, (f1, f2)):
        err = rng.random(READ_LEN) < 0.005
        m[err] = rng.integers(0, 4, int(err.sum()), dtype=np.uint8)
        f.write(b"@p%07d\n%s\n+\n%s\n" % (i, acgt[m].tobytes(), b"I" * READ_LEN))


def write_reads(genomes, n_pairs, seed, d):
    """Paired 100 bp reads from 200-400 bp fragments of the genomes."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(d, "reads_1.fq"), "wb") as f1, \
            open(os.path.join(d, "reads_2.fq"), "wb") as f2:
        for i in range(n_pairs):
            g = genomes[rng.integers(0, len(genomes))]
            fl = int(rng.integers(200, 400))
            p = int(rng.integers(0, len(g) - fl))
            write_pair(f1, f2, i, g[p:p + fl], rng)


def make_proteomes(n_aa, seed):
    """N_GENOMES proteomes as lists of amino-acid code arrays (1..20), proteins
    of 150-550 residues.  Every odd proteome is a 3% point mutant of the one
    before; the first 2% of every even proteome's proteins are those of
    proteome 0 (conserved proteins, which every taxon carries)."""
    rng = np.random.default_rng(seed)
    per = n_aa // N_GENOMES
    lens = []
    while sum(lens) < per:
        lens.append(int(rng.integers(150, 550)))
    cuts = np.cumsum(lens)[:-1]
    shared = cuts[max(1, len(lens) // 50) - 1]
    proteomes, prev = [], None
    for i in range(N_GENOMES):
        if i % 2 == 1:
            flat = prev.copy()
            pos = rng.integers(0, len(flat), int(0.03 * len(flat)))
            flat[pos] = rng.integers(1, 21, len(pos), dtype=np.uint8)
        else:
            flat = rng.integers(1, 21, sum(lens), dtype=np.uint8)
            if proteomes:
                flat[:shared] = np.concatenate(proteomes[0])[:shared]
            prev = flat
        proteomes.append(np.split(flat, cuts))
    return proteomes


def write_protein_db(proteomes, d):
    names = ["T%02d_P%05d" % (t, j) for t, ps in enumerate(proteomes)
             for j in range(len(ps))]
    taxa = [t for t, ps in enumerate(proteomes) for _ in ps]
    write_fasta(os.path.join(d, "ref.fa"), names, [p - 1 for ps in proteomes for p in ps],
                AA_LETTERS)
    write_taxonomy(d, names, taxa)


def codon_table():
    """(codons [21, 6, 3] nucleotide codes, count [21]) of the standard code,
    by amino-acid code 1..20."""
    from centrifuger_tpu_torch.classify.translate import _STD_CODE
    codons = np.zeros((21, 6, 3), np.uint8)
    count = np.zeros(21, np.int64)
    for codon, aa in sorted(_STD_CODE.items()):
        if aa == "_":
            continue
        a = AA_LETTERS.index(aa) + 1
        codons[a, count[a]] = ["ACGT".index(c) for c in codon]
        count[a] += 1
    return codons, count


def write_protein_reads(proteomes, n_pairs, seed, d):
    """Paired 100 bp nucleotide reads from 200-400 bp fragments back-translated
    from the proteins with a random choice among each residue's codons."""
    rng = np.random.default_rng(seed)
    codons, count = codon_table()
    with open(os.path.join(d, "reads_1.fq"), "wb") as f1, \
            open(os.path.join(d, "reads_2.fq"), "wb") as f2:
        for i in range(n_pairs):
            ps = proteomes[rng.integers(0, len(proteomes))]
            p = ps[rng.integers(0, len(ps))]
            fl = int(rng.integers(200, 400))
            n_res = fl // 3 + 2
            a = int(rng.integers(0, len(p) - n_res))
            aa = p[a:a + n_res]
            pick = (rng.random(n_res) * count[aa]).astype(np.int64)
            nt = codons[aa, pick].reshape(-1)
            off = int(rng.integers(0, 3))
            write_pair(f1, f2, i, nt[off:off + fl], rng)


def write_long_reads(genomes, n, seed, d):
    """n single-end reads of LONG_LEN bp from the genomes, half reverse
    complemented, 1% substitutions (nanopore / PacBio read lengths)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    os.makedirs(d)
    with open(os.path.join(d, "reads_1.fq"), "wb") as f:
        for i in range(n):
            g = genomes[rng.integers(0, len(genomes))]
            ln = int(rng.integers(LONG_LEN[0], LONG_LEN[1] + 1))
            p = int(rng.integers(0, len(g) - ln))
            r = g[p:p + ln].copy()
            if rng.random() < 0.5:
                r = 3 - r[::-1]
            err = rng.random(ln) < 0.01
            r[err] = rng.integers(0, 4, int(err.sum()), dtype=np.uint8)
            f.write(b"@l%05d\n%s\n+\n%s\n" % (i, acgt[r].tobytes(), b"I" * ln))


def head_pairs(d, n_pairs, out, paired=True):
    os.makedirs(out, exist_ok=True)
    for name in ("reads_1.fq", "reads_2.fq")[:2 if paired else 1]:
        with open(os.path.join(d, name), "rb") as f, \
                open(os.path.join(out, name), "wb") as g:
            for _ in range(4 * n_pairs):
                g.write(f.readline())


# ----------------------------------------------------------------- runners

def build(fx_dir, prefix, log, extra=()):
    """The port's cfr-build entry in-process."""
    from centrifuger_tpu_torch.cli import build_cli
    with contextlib.redirect_stderr(log):
        rc = build_cli.main(["-r", os.path.join(fx_dir, "ref.fa"),
                             "--taxonomy-tree", os.path.join(fx_dir, "nodes.dmp"),
                             "--name-table", os.path.join(fx_dir, "names.dmp"),
                             "--conversion-table", os.path.join(fx_dir, "ref_seqid.map"),
                             "-o", prefix] + list(extra))
    if rc != 0:
        fail("build_cli returned %r for %s" % (rc, prefix))


def peak_rss_mb():
    """Starts a thread that samples this process's resident set size from
    /proc/self/statm every 20 ms; returns a function that gives the peak so
    far in MB, or None where statm cannot be read.  The function's
    reset=True returns the current RSS instead and restarts the peak from it.
    Neither getrusage's ru_maxrss (it survives the exec of a spawned child,
    which then reads its parent's high-water mark) nor VmHWM (absent from
    the chip machine's /proc) measures the child's own peak."""
    import threading
    page = os.sysconf("SC_PAGE_SIZE")
    peak = [0]

    def now():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    def sample():
        peak[0] = max(peak[0], now())
    try:
        sample()
    except (OSError, ValueError, IndexError):
        return lambda reset=False: None

    def run():
        while True:
            sample()
            time.sleep(0.02)
    threading.Thread(target=run, daemon=True).start()

    def read(reset=False):
        if reset:
            peak[0] = now()
        return peak[0] / 2 ** 20
    return read


def mb_text(mb):
    return "not measured" if mb is None else "%.0f MB" % mb


def make_database(kind, size, seed):
    """One synthetic database with its reads and index under WORK/<kind>
    (run in a process of its own, beside the others).  Kind "chunked" is the
    main DB's genomes again (the same seed), no reads, indexed by the chunked
    builder with --emit-cfr (path L), then the resume check (resume_check).
    Writes times.json: the data and build seconds, the .cfr write seconds,
    the process's peak RSS after the data and after the build, its RSS at
    the build's start and its peak from there (peak_rss_mb)."""
    rss_mb = peak_rss_mb()
    d = os.path.join(WORK, kind)
    os.makedirs(d)
    t0 = time.time()
    times = {}
    if kind == "protein":
        proteomes = make_proteomes(size, seed)
        write_protein_db(proteomes, d)
        write_protein_reads(proteomes, N_PAIRS, seed + 1, d)
        extra = ["--protein"]
    else:
        genomes = make_genomes(size, seed)
        if kind == "ftab12":
            genomes = genomes[:FTAB12_GENOMES]
        write_db(genomes, d)
        if kind != "chunked":
            write_reads(genomes, FTAB12_PAIRS if kind == "ftab12" else N_PAIRS, seed + 1, d)
        if kind == "main":
            write_long_reads(genomes, N_LONG, seed + 2, os.path.join(d, "long"))
        extra = {"ftab12": ["--ftabchars", "12"], "chunked": CHUNKED_BUILD}.get(kind, [])
    if kind == "chunked":
        from centrifuger_tpu_torch.interop import cfr_write
        save = cfr_write.save_cfr_index

        def timed_save(*a, **k):    # build_cli imports it when --emit-cfr runs
            t = time.time()
            save(*a, **k)
            times["cfr_write_s"] = time.time() - t
        cfr_write.save_cfr_index = timed_save
        os.makedirs(os.path.join(d, "resume"))              # the resume check's DB
        write_db(genomes[:2], os.path.join(d, "resume"))
        times["resume_nt"] = sum(len(g) for g in genomes[:2])
    genomes = proteomes = None    # freed before the build: its peak is mostly its own
    gc.collect()
    t1 = time.time()
    times.update(data_s=t1 - t0, rss_data_mb=rss_mb(), rss_start_mb=rss_mb(reset=True))
    with open(os.path.join(OUT, "build_%s.txt" % kind), "w") as log:
        build(d, os.path.join(d, "db"), log, extra)
    times.update(build_s=time.time() - t1 - times.get("cfr_write_s", 0.0),
                 rss_build_peak_mb=rss_mb())
    times["rss_peak_mb"] = None if times["rss_build_peak_mb"] is None else \
        max(times["rss_data_mb"], times["rss_build_peak_mb"])   # the whole process's peak
    if kind == "chunked":
        times.update(resume_check(os.path.join(d, "resume")))
    with open(os.path.join(d, "times.json"), "w") as f:
        json.dump(times, f)


def resume_check(d):
    """Path L's resume check on a DB of the main DB's first two genomes: a
    chunked --checkpoint build at --bmax RESUME_BMAX[0], interrupted just
    after its first state checkpoint, then run again at --bmax
    RESUME_BMAX[1]; against the DB's SA-IS build.  Returns what the phase-2
    report prints."""
    from centrifuger_tpu_torch.fm import builder
    out = {}
    logs = {}
    state = os.path.join(d, "chunked_checkpoint_state.npz")
    real_add = builder._StreamAccum.add

    def add(self, row0, sa):        # stop the build once its state file exists
        real_add(self, row0, sa)
        if os.path.exists(state):
            raise KeyboardInterrupt("path L: interrupted after the first state checkpoint")
    for name, extra in (("sais", []),
                        ("interrupted", ["-t", "8", "--bmax", str(RESUME_BMAX[0]),
                                         "--checkpoint"]),
                        ("resumed", ["-t", "8", "--bmax", str(RESUME_BMAX[1]),
                                     "--checkpoint"])):
        logs[name] = io.StringIO()
        t0 = time.time()
        builder._StreamAccum.add = add if name == "interrupted" else real_add
        try:
            build(d, os.path.join(d, "sais" if name == "sais" else "chunked"), logs[name], extra)
        except KeyboardInterrupt:
            out["resume_stopped"] = name
        finally:
            builder._StreamAccum.add = real_add
        out["resume_%s_s" % name] = time.time() - t0
        with open(os.path.join(OUT, "build_resume_%s.txt" % name), "w") as f:
            f.write(logs[name].getvalue())
    fresh = re.findall(r"\] (checkpoint state [^\n]*; starting fresh)",
                       logs["resumed"].getvalue())
    ckpt = re.findall(r"\] (checkpoint at chunk \d+/\d+)", logs["interrupted"].getvalue())
    out.update(resume_interrupted=ckpt, resume_fresh=fresh,
               resume_equal=all(same_arrays(os.path.join(d, "sais" + ext),
                                            os.path.join(d, "chunked" + ext))
                                for ext in (".fm.npz", ".rowmap.npz")))
    return out


LOAD_S = []   # index-load seconds of each classify() run (load_index + the classifier)


def timed_into(spent, fn):
    """fn, adding the seconds of each call to spent[0]."""
    def run(*a, **k):
        t0 = time.time()
        try:
            return fn(*a, **k)
        finally:
            spent[0] += time.time() - t0
    return run


def classify(prefix, reads_dir, extra, log, paired=True, **make_kw):
    """The port's CLI entry in-process; returns (TSV text, (fast units,
    fallback units)).  reads_dir None: the read arguments are in extra.
    make_kw goes to the make_classifier the CLI calls (force_idtype="int64":
    the CLI's classifier with that index type; shard_devices).  Appends the
    run's index-load seconds (the index files read, the tables built or read
    from the wide-row cache and uploaded) to LOAD_S."""
    from centrifuger_tpu_torch.cli import classify_cli
    rargs = [] if reads_dir is None else \
        (["-1", os.path.join(reads_dir, "reads_1.fq"),
          "-2", os.path.join(reads_dir, "reads_2.fq")] if paired
         else ["-u", os.path.join(reads_dir, "reads_1.fq")])
    buf, err = io.StringIO(), io.StringIO()
    make, load = classify_cli.make_classifier, classify_cli.load_index
    spent = [0.0]
    classify_cli.make_classifier = timed_into(spent, functools.partial(make, **make_kw))
    classify_cli.load_index = timed_into(spent, load)
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = classify_cli.main(["-x", prefix] + rargs + extra)
    finally:
        classify_cli.make_classifier, classify_cli.load_index = make, load
    LOAD_S.append(spent[0])
    log.write(err.getvalue())
    if rc != 0:
        fail("classify_cli returned %r" % rc)
    m = re.search(r"Device units: (\d+) fast, (\d+) fallback", err.getvalue())
    placed = re.search(r"sharded index: .*", err.getvalue())
    if placed:
        say("  %s" % placed.group(0))
    return buf.getvalue(), (tuple(map(int, m.groups())) if m else None)


def run_cli(main, argv, stdin_path=None):
    """A host CLI's main in-process: (return code, stdout, stderr, seconds);
    stdin_path is read as its standard input."""
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    t0 = time.time()
    try:
        if stdin_path:
            sys.stdin = open(stdin_path)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(argv)
            except SystemExit as e:
                rc = e.code
    finally:
        if stdin_path:
            sys.stdin.close()
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue(), time.time() - t0


def read_batches(reads_dir, paired=True):
    """The reads as the CLI batches them: engine queries per batch of
    BATCH_PAIRS pairs (or single reads)."""
    from centrifuger_tpu_torch.cli.classify_cli import _batch_queries
    from centrifuger_tpu_torch.io.readers import ReadFiles
    r1, r2 = ReadFiles(), ReadFiles()
    r1.add_read_file(os.path.join(reads_dir, "reads_1.fq"))
    if paired:
        r2.add_read_file(os.path.join(reads_dir, "reads_2.fq"))
    pairs = list(zip(r1, r2)) if paired else [(r, None) for r in r1]
    return [_batch_queries(pairs[i:i + BATCH_PAIRS])
            for i in range(0, len(pairs), BATCH_PAIRS)]


def make_engine(prefix, serve_layout="plain", force_idtype=None, unfused=False,
                param=None, dev=None, shards=0):
    """The engine the CLI makes (or, unfused, --engine jax's), on the card;
    dev shares an engine's device index; shards > 1 serves through a
    ShardedIndex, as --shards does."""
    from centrifuger_tpu_torch.build import load_index, is_protein_index
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    from centrifuger_tpu_torch.classify.engine_unfused import ClassifierTorchUnfused
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    from centrifuger_tpu_torch.fm.device import fm_arrays
    from centrifuger_tpu_torch.parallel.sharded import ShardedIndex
    fm_host, tax, _, _ = load_index(prefix)
    if shards > 1:
        dev = ShardedIndex(fm_arrays(fm_host), shards, force_idtype=force_idtype)
    cls = ClassifierTorchUnfused if unfused else ClassifierTorch
    return cls(fm_host, tax, param or ClassifierParam(), device="cuda", dev=dev,
               protein=is_protein_index(prefix), serve_layout=serve_layout,
               force_idtype=force_idtype)


def cuda_ms(fn, reps):
    """Median milliseconds of fn() on the card (CUDA events, after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


SPIN_CYCLES = 2_000_000   # about 1 ms of the card's clock: more than a call's host enqueue


def device_ms(fn, reps):
    """Median device milliseconds of one fn() call: CUDA events recorded
    around fn() while the card is still busy with a spin kernel queued just
    before (torch.cuda._sleep), so that the call's work is queued whole before
    the first event is reached and the events time the device's work only,
    not the host's enqueue that cuda_ms includes.  fn must not synchronise
    with the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


def ms_text(ms):
    return "not measured" if ms is None else "%.4f ms" % ms


def lf_steps(fm, rows, valid):
    """LF steps the LF-walk resolve of `rows` takes in all (the plain twin's
    walk: a row steps until it reaches a stored row)."""
    cur, pend, steps = rows.long().clone(), valid.clone(), 0
    while True:
        pend &= ~fm.stored_here(cur)
        idx = pend.nonzero()[:, 0]
        if not len(idx):
            return steps
        steps += len(idx)
        cur[idx] = fm.lf(cur[idx])


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def index_bytes(fm):
    """(rank-table bytes, all index bytes) of an index on the card: its
    buffers, and a sharded index's shards."""
    if fm.layout == "plain_sharded":
        shards = [t for ts in fm.shards.values() for t in ts]
        return nbytes(*fm.shards["rows"]), nbytes(*fm.buffers()) + nbytes(*shards)
    rank_tables = [t for t in (fm.rows, fm.mega) if t is not None] + \
        [t for m in (fm.ind, fm.lit, fm.run) if m is not None for t in m.buffers()]
    return nbytes(*rank_tables), nbytes(*fm.buffers())


def whole_rowmap(fm):
    """The rowmap as one tensor, for the library call it is timed against (a
    sharded index's shards concatenated: the port itself keeps no such
    copy)."""
    import torch
    return torch.cat(fm.shards["rowmap"]) if fm.layout == "plain_sharded" else fm.rowmap


def max_abs_err(a, b):
    if a.shape != b.shape:
        fail("shape mismatch %s vs %s" % (tuple(a.shape), tuple(b.shape)))
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# ------------------------------------------------------------------ phases

def phase_goldens(log):
    for fx, paired, protein in (("tiny", True, False), ("tiny_single", False, False),
                                ("small", True, False), ("tiny_protein", False, True)):
        prefix = os.path.join(WORK, "fx_" + fx)
        build(os.path.join(FX, fx), prefix, log, ["--protein"] if protein else [])
        modes = [[]] if protein else [
            [], ["--serve-layout", "runblock"], ["--serve-layout", "runblock", "--no-rowmap"]]
        for mode in modes:
            for tag, extra in (("k1", []), ("k2", ["-k", "2"]), ("k5", ["-k", "5"])):
                got, _ = classify(prefix, os.path.join(FX, fx), extra + mode, log, paired)
                with open(os.path.join(FX, fx, "golden_class_%s.tsv" % tag)) as f:
                    if got != f.read():
                        fail("golden %s %s %s differs on the card" % (fx, tag, mode))
        say("phase 3: goldens %s k1/k2/k5 byte-identical on cuda%s"
            % (fx, "" if protein else
               " (plain; runblock with and without --no-rowmap)"))
        say("phase 3: goldens %s: %s byte-identical" % (fx, ", ".join(cli_goldens(fx, prefix))))


def cli_goldens(fx, prefix):
    """The downstream CLIs' fixture goldens on the port's index of `fx`:
    cfr-quant-torch on golden_class_k1.tsv (formats 0 and 3), and on tiny
    cfr-kreport-torch and cfr-promote-torch.  Returns the files held."""
    from centrifuger_tpu_torch.cli import kreport_cli, promote_cli, quant_cli
    d = os.path.join(FX, fx)
    runs = [("golden_quant_centrifuger.tsv", quant_cli.main,
             ["-x", prefix, "-c", os.path.join(d, "golden_class_k1.tsv")]),
            ("golden_quant_kreport.tsv", quant_cli.main,
             ["-x", prefix, "-c", os.path.join(d, "golden_class_k1.tsv"),
              "--output-format", "3"])]
    if fx == "tiny":
        runs += [("golden_kreport_script.tsv", kreport_cli.main,
                  ["-x", prefix, os.path.join(d, "golden_class_k1.tsv")]),
                 ("golden_kreport_nolca.tsv", kreport_cli.main,
                  ["-x", prefix, "--no-lca", os.path.join(d, "golden_class_k5.tsv")]),
                 ("golden_promote_genus.tsv", promote_cli.main,
                  [prefix, os.path.join(d, "golden_class_k5.tsv"), "genus"]),
                 ("golden_promote_lca.tsv", promote_cli.main,
                  [prefix, os.path.join(d, "golden_class_k5.tsv"), "lca"])]
    for name, main, argv in runs:
        rc, out, _, _ = run_cli(main, argv)
        with open(os.path.join(d, name)) as f:
            if rc != 0 or out != f.read():
                fail("golden %s %s differs (rc %r)" % (fx, name, rc))
    return [name for name, _, _ in runs]


def probe_index(prefix, serve_layout, force_idtype=None, n_probe=4096, shards=0):
    """The index's public rank, BackwardExtend and LF on the card (the
    counterparts of DeviceFM.rank / backward_extend / lf, which rank_probe.cu
    computes) at the table edges and seeded random rows, held to the host
    index; shards > 1 asks them of a ShardedIndex."""
    import torch
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.fm import device as fd
    from centrifuger_tpu_torch.parallel.sharded import ShardedIndex
    fm = load_index(prefix)[0]
    dev_fm = ShardedIndex(fd.fm_arrays(fm), shards, force_idtype=force_idtype) \
        if shards > 1 else fd.TorchFM.from_index(fm, "cuda", serve_layout, force_idtype)
    rng = np.random.default_rng(fm.n)
    fi = fm.first_isa
    rows = np.concatenate([
        [0, 1, fi - 1, fi, fi + 1, fm.n - 1, 255, 256, 1919, 1920],
        rng.integers(0, fm.n, n_probe - 10)])
    rows = np.clip(rows, 0, fm.n - 1).astype(np.int64)
    c = rng.integers(0, fm.sigma, len(rows))
    c[:4] = fm.last_chr
    ep = np.minimum(rows + rng.integers(0, 4, len(rows)) * 7, fm.n - 1)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to("cuda", dev_fm.idtype)
    rank, sym = fd.rank_sym(dev_fm, dev(c), dev(rows))
    nsp, nep = fd.backward_extend(dev_fm, dev(c), dev(rows), dev(ep))
    got = torch.stack([rank, sym, nsp, nep, fd.lf(dev_fm, dev(rows))]).cpu().numpy()
    hsp, hep = fm.backward_extend(c, rows, ep)
    want = [fm.bwt.rank_inclusive(c, rows), fm.bwt.access(rows), hsp, hep, fm.lf(rows)]
    for what, g, w in zip(("rank", "symbol", "extend sp", "extend ep", "lf"), got, want):
        if not np.array_equal(g, np.asarray(w).astype(np.int64)):
            fail("the %s layout's %s disagrees with the host index of %s"
                 % (dev_fm.layout, what, prefix))
    return dev_fm.layout, len(rows)


def run_path(name, label, prefix, reads_dir, extra, n_pairs, expect, log, paired=True,
             force_idtype=None, **make_kw):
    """One run of a path with the launch counts set to 0 just before and read
    just after: the reads through the CLI and, where `expect` names
    rank_probe, the index's public rank / extend / LF on the same index and
    layout (probe_index).  Fails if a kernel named in `expect` never
    launched, with force_idtype int64 if any launch was not an int64
    instantiation, and with --shards if any was not a plain_sharded one."""
    import torch
    from centrifuger_tpu_torch import kernels
    gc.collect()    # the earlier runs' engines: their buffers are not this path's peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    if force_idtype:
        make_kw["force_idtype"] = force_idtype
    tsv, units = classify(prefix, reads_dir, extra + ["--batch-size", str(BATCH_PAIRS)], log,
                          paired, **make_kw)
    shards = int(extra[extra.index("--shards") + 1]) if "--shards" in extra else 0
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    if any(k.startswith("rank_probe") for k in expect):
        layout = extra[extra.index("--serve-layout") + 1] \
            if "--serve-layout" in extra else "plain"
        t1 = time.time()
        say("%s: %s: rank, BackwardExtend and LF of %d rows on the card (%s layout) equal "
            "the host index's (%.1f s, index load included)"
            % ((label, name) + probe_index(prefix, layout, force_idtype, shards=shards)[::-1]
               + (time.time() - t1,)))
    launches = dict(kernels.LAUNCHES)
    say("%s: %s: %d %s in %.2f s through the CLI (index load included): %.0f %s/s; "
        "units fast %d fallback %d; launches %s; peak device memory %.1f MB"
        % (label, name, n_pairs, "pairs" if paired else "reads", wall, n_pairs / wall,
           "read pairs" if paired else "reads", units[0], units[1], launches, peak / 1e6))
    missing = [k for k in expect if not launches.get(k)]
    if missing:
        fail("kernels never launched on the %s path: %s" % (name, missing))
    if force_idtype == "int64" and any(":i64" not in k for k in launches):
        fail("%s: a launch of the int64 path was not an :i64 instantiation: %s"
             % (name, launches))
    if shards > 1 and any(":plain_sharded" not in k for k in launches):
        fail("%s: a launch of the sharded path was not a plain_sharded instantiation: %s"
             % (name, launches))
    return tsv, launches


def outputs(d):
    """{file name: bytes} of a run's output directory, gzip files read
    through."""
    import gzip
    got = {}
    for name in sorted(os.listdir(d)):
        with (gzip.open if name.endswith(".gz") else open)(os.path.join(d, name), "rb") as f:
            got[name] = f.read()
    return got


def phase_bulk(prefix, reads_dir, log):
    """Path G: the main reads' read 1 single-end through the CLI's bulk FASTQ
    route (native parse and pack on the producer thread), with no wide-row
    cache file (the run builds and writes it) and then with it; then the same
    file on stdin, which the bulk route refuses: the object route.  The
    three TSVs must be equal.  Returns the bulk TSV."""
    from centrifuger_tpu_torch.fm.device import SERVE_CACHE_SUFFIX
    cache = prefix + SERVE_CACHE_SUFFIX
    if os.path.exists(cache):
        os.remove(cache)
    expect = ["chain_search:plain", "finalize_units:plain"]
    got, loads = {}, {}
    for name in ("cold", "warm"):
        got[name], _ = run_path("bulk route, %s wide-row cache" % name, "path G", prefix,
                                reads_dir, [], N_PAIRS, expect, log, paired=False)
        loads[name] = LOAD_S[-1]
        if not os.path.exists(cache):
            fail("path G: the %s run left no wide-row cache file" % name)
    with open(os.path.join(reads_dir, "reads_1.fq")) as f:
        stdin, sys.stdin = sys.stdin, f
        try:
            got["object"], _ = run_path("object route (-u -, stdin)", "path G", prefix, None,
                                        ["-u", "-"], N_PAIRS, expect, log, paired=False)
        finally:
            sys.stdin = stdin
        loads["object"] = LOAD_S[-1]
    if not got["cold"] == got["warm"] == got["object"]:
        fail("path G: the bulk route's TSVs (cold, warm cache) and the object route's differ")
    say("path G: index load %.2f s with no cache file (rows built and written), %.2f s "
        "from the cache, %.2f s for the object route's run; the three TSVs identical "
        "(%d lines)" % (loads["cold"], loads["warm"], loads["object"],
                        got["cold"].count("\n")))
    return got["cold"]


def write_read_prep(k0_dir, d, seed):
    """Path H's inputs from the first K0_PAIRS pairs of main: seeded barcode
    reads (16 bp from a 96-barcode whitelist, a 1-bp error in 30% of them)
    and UMI reads (10 bp), the whitelist, mates rewritten to overlap their
    read 1 in half of the pairs (the reverse complement of read 1 from a
    random offset of 0-40: read-through pairs for --merge-readpair), and
    the pairs cut into two samples with their sheet."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    os.makedirs(d)
    whitelist = [acgt[rng.integers(0, 4, 16)].tobytes() for _ in range(96)]
    with open(os.path.join(d, "whitelist.txt"), "wb") as f:
        f.write(b"\n".join(whitelist) + b"\n")
    with open(os.path.join(d, "bc.fq"), "wb") as fb, open(os.path.join(d, "um.fq"), "wb") as fu:
        for i in range(K0_PAIRS):
            bc = bytearray(whitelist[rng.integers(0, len(whitelist))])
            if rng.random() < 0.3:
                bc[rng.integers(0, 16)] = acgt[rng.integers(0, 4)]
            fb.write(b"@b%07d\n%s\n+\n%s\n" % (i, bytes(bc), np.frombuffer(
                b"#5?I", np.uint8)[rng.integers(0, 4, 16)].tobytes()))
            fu.write(b"@u%07d\n%s\n+\n%s\n" % (i, acgt[rng.integers(0, 4, 10)].tobytes(),
                                               b"I" * 10))
    with open(os.path.join(k0_dir, "reads_1.fq"), "rb") as f1, \
            open(os.path.join(k0_dir, "reads_2.fq"), "rb") as f2, \
            open(os.path.join(d, "merge_2.fq"), "wb") as out:
        for _ in range(K0_PAIRS):
            r1 = [f1.readline() for _ in range(4)]
            r2 = [f2.readline() for _ in range(4)]
            if rng.random() < 0.5:
                mate = r1[1].strip()[rng.integers(0, 41):].translate(comp)[::-1]
                r2 = [r2[0], mate + b"\n", b"+\n", b"I" * len(mate) + b"\n"]
            out.writelines(r2)
    half = K0_PAIRS // 2
    for name in ("reads_1.fq", "reads_2.fq"):
        with open(os.path.join(k0_dir, name), "rb") as f:
            lines = f.readlines()
        for k, part in enumerate((lines[:4 * half], lines[4 * half:])):
            with open(os.path.join(d, "s%d_%s" % (k + 1, name)), "wb") as g:
                g.writelines(part)


def phase_read_prep(prefix, k0_dir, log, seed):
    """Path H: the read-prep flags on the card, each run's TSV, dumps and
    per-sample files held to the same run with --device cpu."""
    d = os.path.join(WORK, "read_prep")
    write_read_prep(k0_dir, d, seed)
    r1, r2 = os.path.join(k0_dir, "reads_1.fq"), os.path.join(k0_dir, "reads_2.fq")
    runs = [
        ("barcodes, UMIs, whitelist, --read-format, --un / --cl",
         ["-1", r1, "-2", r2, "--barcode", os.path.join(d, "bc.fq"),
          "--UMI", os.path.join(d, "um.fq"),
          "--barcode-whitelist", os.path.join(d, "whitelist.txt"),
          "--read-format", "r1:0:89,r2:5:-1", "--un", "{out}/un", "--cl", "{out}/cl"]),
        ("--merge-readpair", ["-1", r1, "-2", os.path.join(d, "merge_2.fq"),
                              "--merge-readpair"]),
        ("two-sample --sample-sheet", ["--sample-sheet", "{out}/sheet.tsv"]),
    ]
    expect = ["chain_search:plain", "finalize_units:plain"]
    for i, (name, args) in enumerate(runs):
        got = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(d, "%s_%d" % (dev, i))
            os.makedirs(out)
            with open(os.path.join(out, "sheet.tsv"), "w") as f:
                f.write("".join("%s %s . . %s\n" % (
                    os.path.join(d, "s%d_reads_1.fq" % k), os.path.join(d, "s%d_reads_2.fq" % k),
                    os.path.join(out, "sample%d.tsv" % k)) for k in (1, 2)))
            argv = [a.replace("{out}", out) for a in args]
            t0 = time.time()
            if dev == "cuda":
                tsv, _ = run_path(name, "path H", prefix, None, argv, K0_PAIRS, expect, log)
            else:
                tsv, _ = classify(prefix, None, argv + ["--device", "cpu",
                                                        "--batch-size", str(BATCH_PAIRS)], log)
            files = outputs(out)
            files.pop("sheet.tsv")
            got[dev] = (tsv, files, time.time() - t0)
        if got["cuda"][:2] != got["cpu"][:2]:
            fail("path H: %s: the card's output differs from the cpu run's" % name)
        tsv, files, _ = got["cuda"]
        say("path H: %s: TSV (%d lines) and %s identical on cuda and cpu (cpu run %.1f s)"
            % (name, tsv.count("\n"), ", ".join("%s %d bytes" % (k, len(v))
                                               for k, v in files.items()) or "no files",
               got["cpu"][2]))


def phase_multihost(prefix, reads_dir, want, log):
    """Path I: --n-ranks 2, each rank's run through the CLI with its
    --rank-index, and cfr-merge-shards-torch: the merged TSV must equal the
    single run's, on the paired object route and on the bulk route."""
    from centrifuger_tpu_torch.cli import merge_cli
    expect = ["chain_search:plain", "finalize_units:plain"]
    r1, r2 = os.path.join(reads_dir, "reads_1.fq"), os.path.join(reads_dir, "reads_2.fq")
    for route, reads in (("paired", ["-1", r1, "-2", r2]), ("bulk", ["-u", r1])):
        argv = ["-o", os.path.join(WORK, "merged_%s.tsv" % route)]
        for r in range(2):
            idx = os.path.join(WORK, "rank%d_%s.idx" % (r, route))
            tsv, _ = run_path("%s --n-ranks 2 --rank %d" % (route, r), "path I", prefix, None,
                              reads + ["--n-ranks", "2", "--rank", str(r), "--rank-index", idx],
                              N_PAIRS // 2, expect, log, paired=route == "paired")
            path = os.path.join(WORK, "rank%d_%s.tsv" % (r, route))
            with open(path, "w") as f:
                f.write(tsv)
            argv += ["--shard", path, idx]
        if merge_cli.main(argv) != 0:
            fail("path I: cfr-merge-shards-torch failed")
        with open(argv[1]) as f:
            if f.read() != want[route]:
                fail("path I: the merged %s TSV differs from the single run's" % route)
        say("path I: %s: two ranks merged by cfr-merge-shards-torch equal the single run "
            "(%d lines)" % (route, want[route].count("\n")))


def phase_cfr(log, protein_prefix):
    """Path J: the checked-in reference-built indexes (.cfr) on the card: tiny
    (the two-tree nucleotide layout) at -k 1 and tiny_protein (the one-tree
    protein layout) at -k 1, 2 and 5, each TSV its golden and no file
    written beside the prefix; the one-tree load's seconds and its
    self-check's, and the ftab half of the check on path A's index (its
    BWT and ftab as the port built them) beside that index's load."""
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.interop import cfr
    prefix = os.path.join(FX, "tiny", "refidx")
    before = sorted(os.listdir(os.path.join(FX, "tiny")))
    tsv, _ = run_path(".cfr index", "path J", prefix, os.path.join(FX, "tiny"), [], 60,
                      ["chain_search:plain", "finalize_units:plain"], log)
    with open(os.path.join(FX, "tiny", "golden_class_k1.tsv")) as f:
        if tsv != f.read():
            fail("path J: the .cfr index's TSV differs from golden_class_k1.tsv")
    if sorted(os.listdir(os.path.join(FX, "tiny"))) != before:
        fail("path J: a file was written beside a reference-built index")
    say("path J: tests/fixtures/tiny/refidx (.cfr) on cuda: golden_class_k1.tsv byte for "
        "byte; no cache file written beside it")

    d = os.path.join(FX, "tiny_protein")
    prefix = os.path.join(d, "refidx")
    checks = [0.0]
    counts_check, ftab_check = cfr._check_one_tree_counts, cfr._check_one_tree_ftab
    cfr._check_one_tree_counts = timed_into(checks, counts_check)
    cfr._check_one_tree_ftab = timed_into(checks, ftab_check)
    loads = []
    try:
        for _ in range(2):      # the process's first one-tree load, then a second
            checks[0] = 0.0
            t0 = time.time()
            fm = cfr.load_cfr_fm(prefix + ".1.cfr", protein=True)
            loads.append((time.time() - t0, checks[0]))
    finally:
        cfr._check_one_tree_counts, cfr._check_one_tree_ftab = counts_check, ftab_check
    say("path J: tiny_protein/refidx.1.cfr (one-tree, %d symbols, b %d) read in %.4f s, "
        "its self-check (psum counts, %d sampled ftab rows) %.4f s of it; a second read "
        "%.4f s, its check %.4f s" % ((fm.n, fm.bwt.b, loads[0][0], cfr.ONE_TREE_CHECK_ROWS,
                                       loads[0][1]) + loads[1]))
    with open(os.path.join(d, "reads_1.fq")) as f:
        n_reads = sum(1 for _ in f) // 4
    before = sorted(os.listdir(d))
    for tag, extra in (("k1", []), ("k2", ["-k", "2"]), ("k5", ["-k", "5"])):
        tsv, _ = run_path("protein .cfr index %s" % tag, "path J", prefix, d, extra, n_reads,
                          ["translate_frames", "chain_search:generic:lanes",
                           "finalize_units:generic:protein"], log, paired=False)
        with open(os.path.join(d, "golden_class_%s.tsv" % tag)) as f:
            if tsv != f.read():
                fail("path J: the protein .cfr index's TSV differs from golden_class_%s.tsv"
                     % tag)
    if sorted(os.listdir(d)) != before:
        fail("path J: a file was written beside the reference-built protein index")
    say("path J: tests/fixtures/tiny_protein/refidx (.cfr, one-tree) on cuda: "
        "golden_class_k1/k2/k5.tsv byte for byte; no file written beside it")
    t0 = time.time()
    fm, _, _, _ = load_index(protein_prefix)
    load_s = time.time() - t0
    codes = fm.bwt.decode()
    t0 = time.time()
    counts_check(codes, fm.psum, protein_prefix)
    t1 = time.time()
    ftab_check(fm, np.stack([fm.ftab_start, fm.ftab_len], axis=1), protein_prefix)
    say("path J: the self-check on path A's index (%d symbols, b %d): psum counts %.4f s, "
        "%d sampled ftab rows %.4f s; that index's .npz load %.2f s"
        % (fm.n, fm.bwt.b, t1 - t0, cfr.ONE_TREE_CHECK_ROWS, time.time() - t1, load_s))


def same_arrays(a, b):
    za, zb = np.load(a), np.load(b)
    return sorted(za.files) == sorted(zb.files) and \
        all(np.array_equal(za[k], zb[k]) for k in za.files)


def cfr_fixture_bytes(log):
    """Path L: the port's build of tiny and small, written by its .cfr
    writer, gives the fixtures' reference-built refidx.1.cfr byte for byte."""
    from centrifuger_tpu_torch.build import build_index
    from centrifuger_tpu_torch.interop.cfr_write import save_cfr_fm
    for fx in ("tiny", "small"):
        d = os.path.join(FX, fx)
        out = os.path.join(WORK, "cfr_bytes_" + fx)
        t0 = time.time()
        with contextlib.redirect_stderr(log):
            fm, _, _ = build_index([os.path.join(d, "ref.fa")], os.path.join(d, "nodes.dmp"),
                                   os.path.join(d, "names.dmp"),
                                   os.path.join(d, "ref_seqid.map"),
                                   conversion_at_file_level=False, output_prefix=out)
        save_cfr_fm(fm, out + ".1.cfr")
        with open(out + ".1.cfr", "rb") as a, open(os.path.join(d, "refidx.1.cfr"), "rb") as b:
            got, want = a.read(), b.read()
        if got != want:
            fail("path L: the .1.cfr written for %s differs from the reference-built "
                 "refidx.1.cfr" % fx)
        say("path L: %s: the port's build written by its .cfr writer equals the "
            "reference-built refidx.1.cfr (%d bytes), %.2f s" % (fx, len(got), time.time() - t0))


def phase_chunked(prefixes, k0_dir, want, log):
    """Path L: the main DB's genomes built by the chunked builder (phase 2,
    CHUNKED_BUILD) give the main index's .fm.npz and .rowmap.npz arrays; the
    writer gives the fixtures' reference bytes (cfr_fixture_bytes); its
    four .cfr files, copied to a prefix of their own, load through the port's
    reader (the main index's n, first_isa, sampled SA, BWT and lengths, no
    rowmap) and classify the first K0_PAIRS pairs on the card to the head of
    the main path's TSV, K2 by LF walk.  Returns the run's launches."""
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.interop.cfr import load_cfr_index
    main, chunked = prefixes["main"], prefixes["chunked"]
    for ext in (".fm.npz", ".rowmap.npz"):
        if not os.path.exists(chunked + ext) or not same_arrays(main + ext, chunked + ext):
            fail("path L: the chunked build's %s differs from the main index's" % ext)
    say("path L: the chunked build's .fm.npz and .rowmap.npz arrays equal the main "
        "(SA-IS) index's")
    cfr_fixture_bytes(log)
    only = os.path.join(WORK, "cfr_only", "db")
    os.makedirs(os.path.dirname(only))
    for part in (1, 2, 3, 4):
        shutil.copy("%s.%d.cfr" % (chunked, part), "%s.%d.cfr" % (only, part))
    t0 = time.time()
    fm, _, seq_length, meta = load_cfr_index(only)
    load_s = time.time() - t0
    ref, _, ref_lengths, _ = load_index(main)
    if (fm.n, fm.first_isa, seq_length) != (ref.n, ref.first_isa, ref_lengths) or \
            getattr(fm, "rowmap", None) is not None or \
            not np.array_equal(np.asarray(fm.sampled_sa), np.asarray(ref.sampled_sa)) or \
            not np.array_equal(fm.bwt.decode(), ref.bwt.decode()):
        fail("path L: the .cfr index read back differs from the main index")
    say("path L: .cfr read back through the port's reader in %.2f s (%d symbols, "
        "sequence_type %s): n, first_isa, sampled SA, BWT and lengths equal the main "
        "index's; no rowmap" % (load_s, fm.n, meta.get("sequence_type")))
    del fm, ref
    gc.collect()
    tsv, launches = run_path(
        ".cfr of the chunked build", "path L", only, k0_dir, [], K0_PAIRS,
        ["chain_search:plain", "finalize_units:plain", "prefix_search:plain",
         "resolve_rows:plain"], log)
    if not want.startswith(tsv) or tsv.count("\n") != K0_PAIRS + 1:
        fail("path L: the .cfr index's TSV is not the head of the main path's")
    say("path L: the .cfr index's TSV equals the first %d pairs of the main path's "
        "(LF-walk resolve; the CLI run's wall holds its own .cfr read and %.2f s of "
        "device tables)" % (K0_PAIRS, LOAD_S[-1]))
    return launches


def phase_downstream(prefix, tsv_text):
    """Path M: the downstream CLIs on the main path's TSV: cfr-quant-torch in
    formats 0-3, the file (native ingest) against stdin (the line loop);
    cfr-kreport-torch with and without --no-lca (the root clade plus the
    unclassified count make the TSV's reads); cfr-promote-torch at genus and
    lca; cfr-inspect-torch with each flag."""
    from centrifuger_tpu_torch.build import load_index_tax_only
    from centrifuger_tpu_torch.cli import inspect_cli, kreport_cli, promote_cli, quant_cli
    path = os.path.join(WORK, "main.tsv")
    with open(path, "w") as f:
        f.write(tsv_text)
    lines = tsv_text.splitlines()
    reads = {line.split("\t", 1)[0] for line in lines[1:]}
    for fmt in range(4):
        a = run_cli(quant_cli.main, ["-x", prefix, "-c", path, "--output-format", str(fmt)])
        b = run_cli(quant_cli.main, ["-x", prefix, "-c", "-", "--output-format", str(fmt)],
                    stdin_path=path)
        if a[0] != 0 or b[0] != 0 or a[1] != b[1] or a[1].count("\n") < 2:
            fail("path M: cfr-quant-torch --output-format %d: the file and stdin runs "
                 "differ or failed (rc %r / %r)" % (fmt, a[0], b[0]))
        say("path M: cfr-quant-torch --output-format %d: -c file (native ingest) %.2f s, "
            "-c - (line loop) %.2f s, identical (%d lines)"
            % (fmt, a[3], b[3], a[1].count("\n")))
    for extra in ([], ["--no-lca"]):
        rc, out, _, secs = run_cli(kreport_cli.main, ["-x", prefix] + extra + [path])
        rows = [line.split("\t") for line in out.splitlines()]
        counts = {int(r[4]): int(r[1]) for r in rows if len(r) >= 6}
        total = counts.get(0, 0) + counts.get(1, 0)
        # --no-lca sums 1/numMatches a row: %d prints the float sum truncated
        low = len(reads) - (1 if extra else 0)
        if rc != 0 or not low <= total <= len(reads):
            fail("path M: cfr-kreport-torch %s: root %d + unclassified %d against %d reads"
                 % (extra, counts.get(1, 0), counts.get(0, 0), len(reads)))
        say("path M: cfr-kreport-torch%s: %.2f s, %d lines; root %d + unclassified %d = "
            "%d reads" % (" " + extra[0] if extra else "", secs, len(rows), counts.get(1, 0),
                          counts.get(0, 0), len(reads)))
    for level in ("genus", "lca"):
        rc, out, _, secs = run_cli(promote_cli.main, [prefix, path, level])
        got = out.splitlines()
        if rc != 0 or not got or got[0] != lines[0] or \
                {line.split("\t", 1)[0] for line in got[1:]} != reads or \
                len(got) > len(lines) or (level == "lca" and len(got) != len(reads) + 1):
            fail("path M: cfr-promote-torch %s: %d lines for %d reads (rc %r)"
                 % (level, len(got), len(reads), rc))
        say("path M: cfr-promote-torch %s: %.2f s, %d lines for %d reads"
            % (level, secs, len(got) - 1, len(reads)))
    tax, seq_length = load_index_tax_only(prefix)
    want = {"--summary": len(seq_length),
            "--conversion-table": tax.seq_cnt + tax.extra_seq_cnt,
            "--taxonomy-tree": tax.node_cnt, "--name-table": tax.node_cnt}
    for flag in INSPECT_FLAGS:
        rc, out, err, secs = run_cli(inspect_cli.main, ["-x", prefix, flag])
        n = (err if flag == "--index-size" else out).count("\n")
        if rc != 0 or n != want.get(flag, n) or n == 0 or \
                (flag == "--index-size" and n != 4):
            fail("path M: cfr-inspect-torch %s: %d lines (rc %r)" % (flag, n, rc))
        say("path M: cfr-inspect-torch %s: %.2f s, %d lines" % (flag, secs, n))


def built(what, make, n_elems):
    """make() timed (path N); says its build seconds and bytes an element."""
    t0 = time.time()
    obj = make()
    secs = time.time() - t0
    nb = obj.nbytes()
    say("path N: %s built in %.2f s: %d bytes, %.4f bytes an element (%d elements)"
        % (what, secs, nb, nb / n_elems, n_elems))
    return obj


def kmer_counts(text, pats):
    """Occurrences of each pattern (lengths <= 32) as a window of text: the
    text's 2-bit packed k-mers of each length, sorted, searched."""
    lens = np.array([len(p) for p in pats])
    out = np.zeros(len(pats), np.int64)
    keys = np.zeros(len(text), np.uint64)
    t = text.astype(np.uint64)
    for m in range(1, int(lens.max()) + 1):
        w = len(text) - m + 1
        keys[:w] = (keys[:w] << np.uint64(2)) | t[m - 1:]
        sel = np.flatnonzero(lens == m)
        if len(sel):
            s = np.sort(keys[:w])
            pk = np.array([functools.reduce(lambda a, c: (a << 2) | int(c), pats[i], 0)
                           for i in sel], np.uint64)
            out[sel] = np.searchsorted(s, pk, "right") - np.searchsorted(s, pk, "left")
    return out


def succinct_oracle(prefix, seed, out_path):
    """Path N's oracle of the sequences: rank_probe's rank and symbol of
    seeded (symbol, row) queries of the main BWT on the card, written to
    out_path for succinct_sequences.  rank_probe counts the BWT as stored (the
    text's last character displaced to row first_isa), inclusive of the row,
    as the library's rank does; the FM's occ is exclusive and adds one for
    the last character up to first_isa, and is reconciled with it here."""
    import torch
    from centrifuger_tpu_torch import kernels
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.fm import device as fd
    fm = load_index(prefix)[0]
    n, fi = fm.n, fm.first_isa
    rng = np.random.default_rng(seed)
    rows = np.concatenate([[0, 1, fi - 1, fi, fi + 1, n - 1],
                           rng.integers(0, n, SUCCINCT_QUERIES - 6)])
    rows = np.clip(rows, 0, n - 1).astype(np.int64)
    syms = rng.integers(0, fm.sigma, len(rows))
    syms[:6] = fm.last_chr
    dev_fm = fd.TorchFM.from_index(fm, "cuda")
    kernels.reset_launches()
    rank, sym = (t.long().cpu().numpy() for t in fd.rank_sym(
        dev_fm, *(torch.from_numpy(a).to("cuda", dev_fm.idtype) for a in (syms, rows))))
    launches = dict(kernels.LAUNCHES)
    if not launches.get("rank_probe:plain"):
        fail("path N: rank_probe never launched (%s)" % launches)
    occ = fm.rank(syms, rows, inclusive=False)
    if not np.array_equal(occ, rank - (sym == syms) + ((syms == fm.last_chr) & (rows <= fi))):
        fail("path N: the FM's occ and rank_probe's inclusive rank do not reconcile")
    np.savez(out_path, rows=rows, syms=syms, rank=rank, sym=sym)
    say("path N: %d rank_probe rank / symbol queries of the main BWT (%d symbols) on the "
        "card (launches %s); the FM's occ at those rows reconciled with them"
        % (len(rows), n, launches))


def succinct_process(lines_path, parts, ctx):
    """Path N's parts (the names of succinct_* functions) in a process of
    their own, their lines written to lines_path; ctx: prefix, db_nt, seed,
    map_path, oracle_path (all parts share one seeded generator)."""
    sys.path.insert(0, REPO)
    ctx = types.SimpleNamespace(**ctx, rng=np.random.default_rng(ctx["seed"] + 5))
    with open(lines_path, "w", buffering=1) as out, contextlib.redirect_stdout(out):
        for part in parts:
            t0 = time.time()
            SUCCINCT_PARTS[part](ctx)
            say("path N: %s took %.1f s" % (part, time.time() - t0))


def main_bwt(prefix):
    """(the main index's BWT as stored, sigma)."""
    from centrifuger_tpu_torch.build import load_index
    fm = load_index(prefix)[0]
    return fm.bwt.decode(), fm.sigma


def succinct_sequences(ctx):
    """The five sequence kinds over the main BWT as stored: rank (inclusive)
    and access at the oracle's rows, held to rank_probe's answers on the card
    (succinct_oracle)."""
    from centrifuger_tpu_torch.succinct import sequences
    bwt, sigma = main_bwt(ctx.prefix)
    z = np.load(ctx.oracle_path)
    rows, syms, rank, sym = z["rows"], z["syms"], z["rank"], z["sym"]
    for what, make in (
            ("SequencePlain", lambda: sequences.SequencePlain(bwt, sigma)),
            ("SequenceWavelet", lambda: sequences.SequenceWavelet(bwt, sigma)),
            ("SequenceWavelet (Huffman shaped)",
             lambda: sequences.SequenceWavelet(bwt, sigma, huffman=True)),
            ("SequenceRunLength", lambda: sequences.SequenceRunLength(bwt, sigma)),
            ("SequenceHybrid", lambda: sequences.SequenceHybrid(bwt, sigma))):
        seq = built(what, make, len(bwt))
        t0 = time.time()
        got = np.empty(len(rows), np.int64)
        for c in range(sigma):
            m = syms == c
            got[m] = seq.rank(c, rows[m])
        if not np.array_equal(got, rank) or \
                not np.array_equal(np.atleast_1d(seq.access(rows)), sym):
            fail("path N: %s's rank or access disagrees with rank_probe on the card" % what)
        say("path N: %s: %d rank and access queries equal rank_probe's (%.2f s)"
            % (what, len(rows), time.time() - t0))
        del seq
        gc.collect()


def succinct_csa(ctx):
    """The CSA over the main DB's first genome, sa= the native SA-IS suffix
    array: lookup and inverse held to the SA, count to numpy's k-mer counts
    (exactly)."""
    from centrifuger_tpu_torch.fm.suffix_array import suffix_array
    from centrifuger_tpu_torch.succinct.csa import CompressedSuffixArray
    rng = ctx.rng
    genome = make_genomes(ctx.db_nt, ctx.seed)[0]
    text = genome.astype(np.int64)
    t0 = time.time()
    sa = suffix_array(genome, 4)
    say("path N: suffix_array of the first genome (%d symbols, native SA-IS) in %.2f s"
        % (len(text), time.time() - t0))
    csa = built("CompressedSuffixArray (sample rate 16)",
                lambda: CompressedSuffixArray(text, sa, sample_rate=16, sigma=4), len(text))
    isa = np.empty_like(sa)
    isa[sa] = np.arange(len(sa))
    q = rng.integers(0, len(text), CSA_QUERIES)
    t0 = time.time()
    if [csa.lookup(int(i)) for i in q] != sa[q].tolist() or \
            [csa.inverse(int(i)) for i in q] != isa[q].tolist():
        fail("path N: the CSA's lookup or inverse disagrees with the suffix array")
    t1 = time.time()
    lens = rng.choice([8, 12, 16, 20, 24, 28, 32], CSA_PATTERNS)
    starts = rng.integers(0, len(text) - 32, CSA_PATTERNS)
    pats = [text[s:s + m] for s, m in zip(starts, lens)]
    truth = kmer_counts(text, pats)
    t2 = time.time()
    got = np.array([csa.count(p) for p in pats])
    if (got != truth).any() or (truth < 1).any():
        bad = int(np.flatnonzero(got != truth)[0]) if (got != truth).any() else 0
        fail("path N: the CSA's count differs from numpy's k-mer count: %d of %d "
             "(first: pattern %d, %d against %d)" % (int((got != truth).sum()), len(pats),
                                                     bad, got[bad], truth[bad]))
    say("path N: CSA: %d lookup and %d inverse equal the suffix array and its inverse "
        "(%.2f s); %d counts of 8-32-symbol patterns equal numpy's k-mer counts (%d of "
        "%d exact; %.2f s, numpy %.2f s)" % (len(q), len(q), t1 - t0, len(pats),
                                            int((got == truth).sum()), len(pats),
                                            time.time() - t2, t2 - t1))


def succinct_hashing(ctx):
    """A minimal perfect hash of N_KEYS distinct 31-mers of the main DB."""
    from centrifuger_tpu_torch.succinct.hashing import PerfectHash
    g = np.concatenate(make_genomes(ctx.db_nt, ctx.seed)[:2]).astype(np.uint64)
    w = min(N_KEYS + N_KEYS // 4, len(g) - 30)
    keys = np.zeros(w, np.uint64)
    for k in range(31):
        keys = (keys << np.uint64(2)) | g[k:k + w]
    keys = np.unique(keys)
    keys = keys[ctx.rng.permutation(len(keys))[:N_KEYS]]
    if len(keys) < N_KEYS:
        fail("path N: fewer than %d distinct 31-mers" % N_KEYS)
    mph = built("PerfectHash of %d distinct 31-mers" % N_KEYS,
                lambda: PerfectHash(keys), N_KEYS)
    t0 = time.time()
    if not np.array_equal(np.sort(mph.lookup(keys)), np.arange(N_KEYS)):
        fail("path N: the PerfectHash is not a bijection onto [0, n)")
    say("path N: PerfectHash: a bijection onto [0, %d) (lookup %.2f s)"
        % (N_KEYS, time.time() - t0))


def succinct_mapper(ctx):
    """PartialSum over the main DB's sequence lengths, CompactMapper over its
    taxids, a seeded Permutation of N_KEYS and its inverse."""
    from centrifuger_tpu_torch.build import load_index_tax_only
    from centrifuger_tpu_torch.succinct.mapper import CompactMapper, PartialSum
    from centrifuger_tpu_torch.succinct.permutation import Permutation
    rng = ctx.rng
    seq_length = load_index_tax_only(ctx.prefix)[1]
    lengths = np.array([seq_length[k] for k in sorted(seq_length)], np.int64)
    ps = built("PartialSum of the %d sequence lengths" % len(lengths),
               lambda: PartialSum(lengths), len(lengths))
    cums = np.cumsum(lengths)
    xs = rng.integers(0, int(cums[-1]), SUCCINCT_QUERIES)
    if not np.array_equal(ps.search(xs), np.searchsorted(cums, xs, side="right")):
        fail("path N: PartialSum.search disagrees with np.searchsorted")
    with open(ctx.map_path) as f:
        taxids = np.array(sorted({int(line.split("\t")[1]) for line in f}), np.int64)
    cm = built("CompactMapper of the %d sequences' taxids" % len(taxids),
               lambda: CompactMapper(taxids), len(taxids))
    if not np.array_equal(cm.to_compact(taxids), np.arange(len(taxids))) or \
            not np.array_equal(cm.to_orig(np.arange(len(taxids))), taxids) or \
            cm.contains(np.setdiff1d(np.arange(taxids.max() + 1), taxids)).any():
        fail("path N: CompactMapper does not map the taxids to [0, m) and back")
    pi = rng.permutation(N_KEYS)
    perm = built("Permutation of %d (t = %d)" % (N_KEYS, PERM_T),
                 lambda: Permutation(pi, t=PERM_T), N_KEYS)
    inv = np.argsort(pi)
    q = rng.integers(0, N_KEYS, CSA_QUERIES)
    t0 = time.time()
    if not np.array_equal(perm.next(np.arange(N_KEYS)), pi) or \
            [perm.prev(int(i)) for i in q] != inv[q].tolist():
        fail("path N: the Permutation or its inverse disagrees with pi / np.argsort")
    say("path N: %d PartialSum searches equal np.searchsorted; CompactMapper maps the "
        "taxids to [0, %d) and back; Permutation next equals pi, %d prev equal np.argsort "
        "(%.2f s)" % (len(xs), len(taxids), len(q), time.time() - t0))


def succinct_codes(ctx):
    """HuffmanCode over the BWT's symbol counts, a round trip of its first
    N_KEYS symbols; Elias gamma and delta round trips of N_KEYS of its run
    lengths."""
    from centrifuger_tpu_torch.succinct import codes
    bwt, sigma = main_bwt(ctx.prefix)
    hc = codes.HuffmanCode(np.bincount(bwt, minlength=sigma))
    change = np.flatnonzero(np.diff(bwt[:4 * N_KEYS].astype(np.int8)) != 0)
    runs = np.diff(change)[:N_KEYS].astype(np.uint64)
    for what, encode, decode, vals in (
            ("HuffmanCode (lengths %s) of the first %d BWT symbols"
             % (hc.lengths.tolist(), N_KEYS), hc.encode,
             lambda e, v: hc.decode(e[0], e[1], len(v)), bwt[:N_KEYS].astype(np.int64)),
            ("Elias gamma of %d BWT run lengths" % N_KEYS, codes.elias_gamma_encode,
             lambda e, v: codes.elias_gamma_decode(e[0], e[2]), runs),
            ("Elias delta of %d BWT run lengths" % N_KEYS, codes.elias_delta_encode,
             lambda e, v: codes.elias_delta_decode(e[0], e[2]), runs)):
        t0 = time.time()
        enc = encode(vals)
        t1 = time.time()
        if len(vals) != N_KEYS or not np.array_equal(decode(enc, vals), vals):
            fail("path N: %s does not round-trip" % what)
        say("path N: %s: encoded in %.2f s, %.4f bits a value; decoded to the same values "
            "in %.2f s" % (what, t1 - t0, enc[1] / len(vals), time.time() - t1))


def succinct_trees(ctx):
    """TreeLOUDS, TreeBP and TreeDFUDS over a seeded random tree of N_TREE
    nodes, held op by op to PlainTree at TREE_SAMPLE nodes."""
    from centrifuger_tpu_torch.succinct import trees
    rng = ctx.rng
    t0 = time.time()
    plain = trees.PlainTree()
    for p in rng.integers(0, np.arange(1, N_TREE)).tolist():
        plain.add_node(p)
    sample = rng.integers(0, N_TREE, TREE_SAMPLE).tolist()
    say("path N: a seeded random PlainTree of %d nodes in %.2f s"
        % (N_TREE, time.time() - t0))
    for cls in (trees.TreeLOUDS, trees.TreeBP, trees.TreeDFUDS):
        t = built(cls.__name__, lambda: cls.from_plain(plain), N_TREE)
        ids = t.id_map
        t0 = time.time()
        for v in sample:
            h = t.node_select(ids[v])
            cc = plain.children_count(v)
            ok = t.node_map(h) == ids[v] and t.children_count(h) == cc and \
                t.child_rank(h) == plain.child_rank(v) and \
                (v == 0 or t.node_map(t.parent(h)) == ids[plain.parent[v]]) and \
                all(t.node_map(t.child_select(h, k)) == ids[plain.child_select(v, k)]
                    for k in range(1, min(cc, 3) + 1)) and \
                (not hasattr(t, "depth") or t.depth(h) == plain.depth(v)) and \
                (not hasattr(t, "subtree_size") or t.subtree_size(h) == plain.subtree_size(v))
            if not ok:
                fail("path N: %s disagrees with PlainTree at node %d" % (cls.__name__, v))
        say("path N: %s: parent, children_count, child_select, child_rank%s at %d nodes "
            "equal PlainTree's (%.2f s)" % (cls.__name__, "".join(
                ", " + op for op in ("depth", "subtree_size") if hasattr(t, op)),
                TREE_SAMPLE, time.time() - t0))


SUCCINCT_PARTS = {"sequences": succinct_sequences, "csa": succinct_csa,
                  "hashing": succinct_hashing, "mapper": succinct_mapper,
                  "codes": succinct_codes, "trees": succinct_trees}
# path N's processes, each a few of the parts, beside path O and phase 6
SUCCINCT_PROCS = (("sequences",), ("csa", "hashing", "mapper"), ("codes", "trees"))


NCBI_HOSTS = ("ftp.ncbi.nlm.nih.gov", "ftp.ncbi.nih.gov")   # cfr-download's two hosts


def write_mirror(m, genomes, db_dir):
    """A local copy of the NCBI paths cfr-download reads: the refseq
    bacteria assembly summary (a latest Complete Genome row per main DB
    genome, taxid from the smoke's taxonomy, and two rows the filters drop),
    each genome's <name>_genomic.fna.gz, and the taxonomy dump."""
    import gzip
    import tarfile
    with open(os.path.join(db_dir, "ref_seqid.map")) as f:
        taxid = dict(line.split() for line in f)

    def row(i, status, level):
        """(summary line, genome directory, file name stem) of assembly i."""
        acc = "GCF_%09d.1" % (i + 1)
        name = "%s_SynStrain%d" % (acc, i)
        rel = "genomes/all/GCF/%s/%s/%s/%s" % (acc[4:7], acc[7:10], acc[10:13], name)
        tax = taxid.get("SEQ_%06d" % i, "1")
        line = "\t".join([acc, "PRJNA0", "SAMN0", "na", "representative genome", tax, tax,
                          "Synthetic strain %d" % i, "strain=%d" % i, "", status, level,
                          "Full", "Major", "2024/01/01", name, "smoke", "GCA_" + acc[4:],
                          "identical", "https://%s/%s" % (NCBI_HOSTS[0], rel)]) + "\n"
        return line, os.path.join(m, rel), name
    rows = []
    for i, g in enumerate(genomes):
        line, d, name = row(i, "latest", "Complete Genome")
        rows.append(line)
        path = os.path.join(d, name + "_genomic.fna.gz")
        os.makedirs(d)
        write_fasta(path + ".fa", ["SEQ_%06d" % i], [g], "ACGT")
        with open(path + ".fa", "rb") as src, gzip.open(path, "wb", compresslevel=1) as dst:
            shutil.copyfileobj(src, dst, 1 << 24)
        os.remove(path + ".fa")
    # not in the mirror: fetching either fails the path
    rows.append(row(len(genomes), "replaced", "Complete Genome")[0])
    rows.append(row(len(genomes) + 1, "latest", "Contig")[0])
    d = os.path.join(m, "genomes", "refseq", "bacteria")
    os.makedirs(d)
    with open(os.path.join(d, "assembly_summary.txt"), "w") as f:
        f.write("# assembly_accession\tbioproject\tbiosample\t...\n")
        f.writelines(rows)
    os.makedirs(os.path.join(m, "pub", "taxonomy"))
    with tarfile.open(os.path.join(m, "pub", "taxonomy", "taxdump.tar.gz"), "w:gz") as t:
        for name in ("nodes.dmp", "names.dmp"):
            t.add(os.path.join(db_dir, name), name)


def phase_download(genomes, db_dir, reads_dir, log):
    """Path O: cfr-download-torch against a local mirror (its fetch copies
    from the mirror; urllib.request.urlopen raises and fails the path), then
    cfr-build-torch over the first two downloaded genomes with the printed
    map and the downloaded taxonomy, and K0_PAIRS main pairs classified from
    it on the card and with --device cpu."""
    import urllib.parse
    import urllib.request
    from centrifuger_tpu_torch.cli import build_cli, download_cli
    label = "path O"
    d = os.path.join(WORK, "download")
    mirror, base = os.path.join(d, "mirror"), os.path.join(d, "lib")
    t0 = time.time()
    write_mirror(mirror, genomes, db_dir)
    say("%s: mirror of %d genomes (gzip level 1), their assembly summary and taxdump "
        "written in %.1f s" % (label, len(genomes), time.time() - t0))
    fetched, opened = [], []

    def fetch(url, dest=None, retries=3):
        fetched.append(url)
        parts = urllib.parse.urlsplit(url)
        src = os.path.join(mirror, parts.path.lstrip("/"))
        if parts.netloc not in NCBI_HOSTS or not os.path.isfile(src):
            raise RuntimeError("Error downloading %s: not in the mirror" % url)
        if dest is None:
            with open(src, "rb") as f:
                return f.read()
        shutil.copyfile(src, dest)
        return dest

    def urlopen(*a, **k):
        opened.append(a)
        raise OSError("path O: urlopen called")
    saved = download_cli.fetch, urllib.request.urlopen
    download_cli.fetch, urllib.request.urlopen = fetch, urlopen
    runs = {}
    try:
        for what, argv in (("map", ["-o", base, "-P", "4", "-d", "bacteria", "refseq"]),
                           ("file map", ["-o", base, "-P", "4", "-d", "bacteria", "-f",
                                         "refseq"]),
                           ("taxonomy", ["-o", base, "taxonomy"])):
            n0 = len(fetched)
            rc, out, err, secs = run_cli(download_cli.main, argv)
            log.write(err)
            if rc != 0:
                fail("path O: cfr-download-torch %s returned %r" % (" ".join(argv), rc))
            runs[what] = out
            say("%s: cfr-download-torch %s: %.2f s, %d files fetched from the mirror, %d "
                "lines out" % (label, " ".join(argv[2:]), secs, len(fetched) - n0,
                               out.count("\n")))
    finally:
        download_cli.fetch, urllib.request.urlopen = saved
    if opened:
        fail("path O: urllib.request.urlopen was called %d times" % len(opened))
    with open(os.path.join(db_dir, "ref_seqid.map")) as f:
        if runs["map"] != f.read():
            fail("path O: the printed seqid-to-taxid map differs from the main DB's table")
    files = [line.split("\t") for line in runs["file map"].splitlines()]
    if len(files) != len(genomes) or any(not os.path.isfile(p) for p, _ in files):
        fail("path O: -f printed %d files for %d genomes" % (len(files), len(genomes)))
    for name in ("nodes.dmp", "names.dmp"):
        with open(os.path.join(base, name), "rb") as a, \
                open(os.path.join(db_dir, name), "rb") as b:
            if a.read() != b.read():
                fail("path O: the downloaded %s differs from the smoke's" % name)
    say("%s: the printed map equals the main DB's conversion table; -f names the %d "
        "downloaded files; nodes.dmp and names.dmp equal the smoke's; urlopen never called"
        % (label, len(files)))
    map_path = os.path.join(d, "seqid.map")
    with open(map_path, "w") as f:
        f.write(runs["map"])
    prefix = os.path.join(d, "db")
    t0 = time.time()
    with contextlib.redirect_stderr(log):
        rc = build_cli.main(["-r", files[0][0], "-r", files[1][0],
                             "--taxonomy-tree", os.path.join(base, "nodes.dmp"),
                             "--name-table", os.path.join(base, "names.dmp"),
                             "--conversion-table", map_path, "-o", prefix])
    if rc != 0:
        fail("path O: cfr-build-torch over the downloaded genomes returned %r" % rc)
    say("%s: cfr-build-torch of the first two downloaded genomes (%d symbols) in %.1f s"
        % (label, sum(len(g) for g in genomes[:2]), time.time() - t0))
    tsv, _ = run_path("downloaded genomes", label, prefix, reads_dir, [], K0_PAIRS,
                      ["chain_search:plain", "finalize_units:plain"], log)
    t0 = time.time()
    cpu_tsv, _ = classify(prefix, reads_dir, ["--device", "cpu",
                                              "--batch-size", str(BATCH_PAIRS)], log)
    if cpu_tsv != tsv:
        fail("path O: the card's TSV differs from the --device cpu run's")
    say("%s: %d pairs: TSV (%d lines, %d pairs classified) identical on cuda and cpu "
        "(cpu run %.1f s)" % (label, K0_PAIRS, tsv.count("\n"),
                              K0_PAIRS - tsv.count("\tunclassified\t"), time.time() - t0))


def engine_rates(label, eng, bq, n_pairs, profile_name):
    """Steady-state engine rate (second pass), then the device's busy time and
    idle share in one profiled pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    from centrifuger_tpu_torch import kernels

    def one_pass():
        if hasattr(eng, "query_pipelined_packed"):
            for packed, fb, queries in eng.query_pipelined_packed(iter(bq)):
                eng.format_tsv_batch(packed, fb, queries, ["r"] * len(queries))
        else:   # the non-fused engine: result objects, as the CLI's query_batch
            for queries in bq:
                eng.query_batch(queries)
        torch.cuda.synchronize()
    fm = eng.dev
    say("%s: %s layout: rank tables %.1f MB of %.1f MB index buffers on the card"
        % ((label, fm.layout) + tuple(b / 1e6 for b in index_bytes(fm))))
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        one_pass()
        rate = n_pairs / (time.time() - t0)
    before = collections.Counter(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # past a process's first profiled pass the profiler can miss the
        # pass's first launches: a spin kernel and a pause go first (the spin
        # is left out of the busy time), and the count check below says
        # where the profiler still missed some
        torch.cuda._sleep(SPIN_CYCLES // 10)
        torch.cuda.synchronize()
        time.sleep(0.2)
        t0 = time.time()
        one_pass()
        wall_ms = (time.time() - t0) * 1e3
    ka = prof.key_averages()
    # kernels and copies only: an aten op's own device time repeats theirs
    busy_ms = sum(k.self_device_time_total for k in ka
                  if k.device_type == DeviceType.CUDA and "spin_kernel" not in k.key) / 1e3
    with open(os.path.join(OUT, profile_name), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=30))
    # the busy time holds only if the profiler kept every launch of the
    # port's kernels that the wrappers counted in the pass
    launched, kept = collections.Counter(), collections.Counter()
    for name, n in (kernels.LAUNCHES - before).items():
        launched[name.split(":")[0]] += n
    for k in ka:
        m = re.search(r"::(\w+)_kernel<", k.key)
        if k.device_type == DeviceType.CUDA and m:
            kept[m.group(1)] += k.count
    lost = ["%s %d of %d" % (name, kept[name], n)
            for name, n in sorted(launched.items()) if kept[name] != n]
    busy = ("device busy %.2f ms, idle share %.4f" % (busy_ms, 1 - busy_ms / wall_ms)
            if not lost else "device busy and idle share not measured (the profiler "
            "kept %s launches)" % ", ".join(lost))
    say("%s: steady-state engine rate (reads parsed beforehand, TSV formatted): %.0f "
        "read pairs/s; profiled pass: wall %.1f ms, %s (table in chiprun_out/%s)"
        % (label, rate, wall_ms, busy, profile_name))


def check_cpu_head(label, kind, prefix, reads_dir, tsv, extra, log, paired=True):
    """The head of the path's reads on the CPU (plain versions) must give the
    head of the card's TSV."""
    n = CPU_PAIRS[kind]
    head = os.path.join(WORK, "head_" + kind)
    head_pairs(reads_dir, n, head, paired)
    t0 = time.time()
    cpu_tsv, _ = classify(prefix, head, extra + ["--device", "cpu"], log, paired)
    if not tsv.startswith(cpu_tsv) or cpu_tsv.count("\n") < n:
        fail("%s: the first %d %s differ between cuda and cpu"
             % (label, n, "pairs" if paired else "reads"))
    say("%s: first %d %s identical on cpu and cuda (cpu run %.1f s)"
        % (label, n, "pairs" if paired else "reads", time.time() - t0))


class Records:
    """The per-kernel records of phase 6."""

    def __init__(self, fm, launches, path):
        self.fm, self.launches, self.path, self.recs = fm, launches, path, []

    def bound(self, table_bytes, io_bytes):
        """(least ms, what bounds it): each input byte read and each output
        byte written once, and the integer work on the table words read."""
        t_bytes = (table_bytes + io_bytes) / HBM_BYTES_PER_MS
        t_ops = OPS_PER_TABLE_BYTE * table_bytes / OPS_PER_MS
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def traffic(self, fn):
        """(fn(), the index-table bytes the plain version counted, its ms by
        CUDA events)."""
        import torch
        self.fm.traffic = 0
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        e.synchronize()
        t, self.fm.traffic = self.fm.traffic, None
        return out, t, s.elapsed_time(e)

    def add(self, name, replaces, kernel, plain, io_bytes, library=None,
            same=None, reps=20, plain_reps=3):
        """Hold kernel() to plain() (tuples of tensors), time both, and record
        them under the launch count `name`, with the kernel's device time and,
        where `library` (one PyTorch call of the same function) is given, its
        event and device times.  plain_reps=0 times the plain version's one
        comparison call (for a twin that takes minutes)."""
        library_ms = library_device_ms = None
        if library is not None:
            library_ms, library_device_ms = cuda_ms(library, 20), device_ms(library, 20)
        got = kernel()
        want, table_bytes, plain_once = self.traffic(plain)
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        if same is not None:
            err = max(err, max(max_abs_err(g, w) for g, w in zip(got, same)))
        ms = cuda_ms(kernel, reps)
        dev_ms = device_ms(kernel, min(reps, 5))
        plain_ms = cuda_ms(plain, plain_reps) if plain_reps else plain_once
        bound_ms, bound_by = self.bound(table_bytes, io_bytes + nbytes(*got))
        self.recs.append(dict(
            name=name, path=self.path, route="cuda", source=CSRC % name.split(":")[0],
            replaces=replaces, launches=self.launches.get(name, 0), max_abs_err=err,
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, library_device_ms=library_device_ms))
        say("phase 6: %-32s err %d  kernel %.4f ms (device %s)  plain %.4f ms  bound %.4f ms "
            "(%s)%s  launches %d"
            % (name, err, ms, ms_text(dev_ms), plain_ms, bound_ms, bound_by,
               "" if library_ms is None else "  library %.4f ms (device %s)"
               % (library_ms, ms_text(library_device_ms)),
               self.launches.get(name, 0)))
        if err or not self.launches.get(name):
            fail("%s: disagrees with its plain twin, or never launched on its path"
                 % name)
        return got


@contextlib.contextmanager
def spying(module, names):
    """Yields {wrapper: its arguments after the index} for the first call of
    each wrapper in `names` that `module` makes meanwhile."""
    handed, orig = {}, {n: getattr(module, n) for n in names}

    def spy(name, fn):
        def call(fm_, *args):
            handed.setdefault(name, args)
            return fn(fm_, *args)
        return call
    for n in names:
        setattr(module, n, spy(n, orig[n]))
    try:
        yield handed
    finally:
        for n in names:
            setattr(module, n, orig[n])


def phase_kernels(label, eng, batches, launches, replaces, ref_hits=None,
                  finalize_lf=False):
    """Every kernel a path launched against its plain twin at the path's
    shapes.  `replaces` maps the kernels to the JAX programs they replace;
    finalize_lf also holds finalize_units with the rowmap off (its LF-walk
    resolve, as --no-rowmap runs it) to its twin and times it."""
    import torch
    from centrifuger_tpu_torch import kernels
    from centrifuger_tpu_torch.classify import engine_unfused as engine_mod
    from centrifuger_tpu_torch.classify import device_engine as de
    from centrifuger_tpu_torch.fm import device as fd

    fm = eng.dev
    rec = Records(fm, launches, label.replace("phase 6 ", ""))

    def inst(kernel, *variant):
        return kernels.instantiation(kernel, fm, variant)
    queries = batches[0]
    mhl = eng.param.min_hit_len
    me = eng.param.max_result * eng.param.max_result_per_hit_factor
    if eng.protein:
        # K13 builds the code lanes from the mates' bytes, as the engine does
        flat, starts, nr, L = eng._pack_reads_protein_flat(queries)
        f, st = (torch.from_numpy(x).cuda() for x in (flat, starts))
        tab = eng._frame_table
        reads = rec.add("translate_frames", replaces["translate_frames"],
                        lambda: de.translate_lanes(f, st, L, tab),
                        lambda: de.translate_lanes_plain(f, st, L, tab), nbytes(f, st, tab))
        say("%s: translate_frames: %d mates (%d bytes) to %d lanes x %d codes"
            % (label, len(starts) - 1, len(flat), len(reads[1]), L))
        chain, chain_plain = fd.chain_search_lanes, fd.chain_search_lanes_plain
    else:
        (pack2, vmask), lengths, nr, L = eng._pack_reads(queries)
        reads = tuple(torch.from_numpy(x).cuda() for x in (pack2, vmask, lengths))
        chain, chain_plain = de.chain_search, de.chain_search_plain
    H = L // (mhl + 1) + 1
    variant = fd.chain_variant(fm, lanes=eng.protein)
    hits, nhits = rec.add(
        inst("chain_search", *variant), replaces["chain_search"],
        lambda: chain(fm, *reads, mhl, H), lambda: chain_plain(fm, *reads, mhl, H),
        nbytes(*reads), same=ref_hits)
    say("%s: %d lanes x %d codes, %d hits, H=%d"
        % (label, len(nhits), L, int(nhits.sum()), H))
    if "finalize_units" in replaces:
        packed, = rec.add(
            inst("finalize_units", *("protein",) * eng.protein),
            replaces["finalize_units"],
            lambda: de.finalize_units(fm, hits, nhits, nr, mhl, me, eng.K_OUT, eng.protein),
            lambda: de.finalize_units_plain(fm, hits, nhits, nr, mhl, me, eng.K_OUT,
                                            eng.protein),
            nbytes(hits, nhits))
        flagged = int(((packed[:, 4] != 0) | (packed[:, 3] > eng.K_OUT)).sum())
        say("%s: %d units, %d flagged" % (label, len(packed), flagged))
    if finalize_lf:
        rowmap = fm.rowmap
        fm.rowmap = None
        try:
            def fin():
                return de.finalize_units(fm, hits, nhits, nr, mhl, me, eng.K_OUT)

            def fin_plain():
                return de.finalize_units_plain(fm, hits, nhits, nr, mhl, me, eng.K_OUT)
            got = fin()
            want, tr, _ = rec.traffic(fin_plain)
            if max_abs_err(got, want) or not torch.equal(got, packed):
                fail("%s: finalize_units (LF walk) disagrees with its plain twin or with "
                     "the rowmap's result" % label)
            say("%s: finalize_units LF-walk branch (--no-rowmap): err 0  kernel %.4f ms "
                "(device %s)  plain %.4f ms  bound %.4f ms (%s)"
                % ((label, cuda_ms(fin, 20), ms_text(device_ms(fin, 5)), cuda_ms(fin_plain, 3))
                   + rec.bound(tr, nbytes(hits, nhits, got))))
        finally:
            fm.rowmap = rowmap

    # K5 and K2 on the tensors the host finish stage hands their wrappers
    # when the batches run as on the path: the first call of each
    wanted = [k for k in ("prefix_search", "resolve_rows") if k in replaces]
    with spying(engine_mod, wanted) as handed:
        for qs in batches if wanted else []:
            eng.finish_packed(eng._dispatch_fused(qs))
            if all(k in handed for k in wanted):
                break
    if any(k not in handed for k in wanted):
        fail("%s: the batches never called %s" % (label, wanted))
    if "prefix_search" in wanted:
        codes, ms = handed["prefix_search"]
        say("%s: the finish stage hands prefix_search %d lanes x %d codes (ms %d-%d, "
            "%d lanes with ms < %d)"
            % (label, codes.shape[0], codes.shape[1], int(ms.min()), int(ms.max()),
               int((ms < codes.shape[1]).sum()), codes.shape[1]))
        rec.add(inst("prefix_search"), replaces["prefix_search"],
                lambda: fd.prefix_search(fm, codes, ms),
                lambda: fd.prefix_search_plain(fm, codes, ms), nbytes(codes, ms))
    if "resolve_rows" in wanted:
        rows, valid = handed["resolve_rows"]
        say("%s: the finish stage hands resolve_rows %d rows" % (label, len(rows)))
        rowmap, whole = fm.rowmap, whole_rowmap(fm)
        rec.add(inst("resolve_rows"), replaces["resolve_rows"],
                lambda: fd.resolve_rows(fm, rows, valid),
                lambda: fd.resolve_rows_plain(fm, rows, valid), nbytes(rows, valid),
                lambda: torch.index_select(whole, 0, rows))
        del whole
        fm.rowmap = None
        try:
            got = fd.resolve_rows(fm, rows, valid)
            want, tr, _ = rec.traffic(lambda: fd.resolve_rows_plain(fm, rows, valid))
            if max_abs_err(got, want):
                fail("%s: resolve_rows (LF walk) disagrees with its plain twin" % label)

            def walk():
                return fd.resolve_rows(fm, rows, valid)
            say("%s: resolve_rows LF-walk branch: err 0  kernel %.4f ms (device %s)  "
                "plain %.4f ms  bound %.4f ms (%s)  %d LF steps over the %d rows"
                % ((label, cuda_ms(walk, 20),
                    ms_text(device_ms(walk, 5)),
                    cuda_ms(lambda: fd.resolve_rows_plain(fm, rows, valid), 3))
                   + rec.bound(tr, nbytes(rows, valid, got)) + (lf_steps(fm, rows, valid),
                                                                 len(rows))))
        finally:
            fm.rowmap = rowmap

    if "rank_probe" in replaces:
        probe = probe_tensors(fm, len(nhits))
        rank_probe_record(rec, fm, probe, replaces["rank_probe"])
    return rec.recs, (hits, nhits)


def probe_tensors(fm, M, seed=5):
    """(c, sp, ep) [M] in the index type on the card: seeded random symbols
    and rows, half of the ranges one row wide."""
    import torch
    rng = np.random.default_rng(seed)
    sp = rng.integers(0, fm.n, M)
    ep = np.minimum(sp + rng.integers(0, 64, M), fm.n - 1)
    ep[::2] = sp[::2]
    c = rng.integers(0, fm.sigma, M)
    return tuple(torch.from_numpy(a).to("cuda", fm.idtype) for a in (c, sp, ep))


def rank_probe_record(rec, fm, probe, replaces):
    """rank_probe: one rank + symbol of M random rows is the record; one
    BackwardExtend and one LF are held to their twins and timed beside it."""
    from centrifuger_tpu_torch import kernels
    from centrifuger_tpu_torch.fm import device as fd
    c, sp, ep = probe
    name = kernels.instantiation("rank_probe", fm)

    def ints(ts):
        return tuple(t.to(fm.idtype) for t in ts)
    for what, kernel, plain in (
            ("extend", lambda: fd.backward_extend(fm, c, sp, ep),
             lambda: fm.backward_extend(c.long(), sp.long(), ep.long())),
            ("lf", lambda: (fd.lf(fm, sp),), lambda: (fm.lf(sp.long()),))):
        if any(max_abs_err(g, w) for g, w in zip(kernel(), ints(plain()))):
            fail("%s %s disagrees with its plain twin" % (name, what))
        say("phase 6: %s %s of %d rows: err 0  kernel %.4f ms  plain %.4f ms"
            % (name, what, len(c), cuda_ms(kernel, 20), cuda_ms(plain, 3)))
    rec.add(name, replaces, lambda: fd.rank_sym(fm, c, sp),
            lambda: ints(fm.rank_sym(c.long(), sp.long())), nbytes(c, sp))
    say("phase 6: %s one rank of %d random rows: %.4f ms" % (name, MANY_ROWS, many_ranks_ms(fm)))
    group_rank_check(fm, name)


def group_rank_check(fm, name):
    """rank_probe's group modes (BackwardExtend and LF through Lanes<Layout>,
    a warp a query: what every kernel of a lane runs) on MANY_ROWS random
    queries, held to the twins and to the one-thread modes, and timed beside
    them."""
    from centrifuger_tpu_torch.fm import device as fd
    c, sp, ep = probe_tensors(fm, MANY_ROWS, seed=9)
    for what, group, solo, plain in (
            ("extend", lambda: fd.backward_extend(fm, c, sp, ep, group=True),
             lambda: fd.backward_extend(fm, c, sp, ep),
             lambda: fm.backward_extend(c.long(), sp.long(), ep.long())),
            ("lf", lambda: (fd.lf(fm, sp, group=True),), lambda: (fd.lf(fm, sp),),
             lambda: (fm.lf(sp.long()),))):
        got = group()
        err = max(max(max_abs_err(g, w.to(fm.idtype)) for g, w in zip(got, plain())),
                  max(max_abs_err(g, w) for g, w in zip(got, solo())))
        if err:
            fail("%s group %s disagrees with its plain twin or the one-thread mode"
                 % (name, what))
        say("phase 6: %s group %s of %d queries: err 0  kernel %.4f ms (device %s)  "
            "one-thread %.4f ms (device %s)"
            % (name, what, MANY_ROWS, cuda_ms(group, 20), ms_text(device_ms(group, 5)),
               cuda_ms(solo, 20), ms_text(device_ms(solo, 5))))


def offset_rows_check(label, fm):
    """The 40-bit occ on the card (path D): one rank of MANY_ROWS random rows
    over the offset rows (every occ + OFFSET, split into the lo word and the
    WIDE_HI byte), held to its twin and to the original rank plus OFFSET."""
    from centrifuger_tpu_torch.fm import device as fd
    off = fd.offset_rows_view(fm, OFFSET)
    c, sp, _ = probe_tensors(fm, MANY_ROWS, seed=8)
    got = fd.rank_sym(off, c, sp)
    twin = off.rank_sym(c.long(), sp.long())
    base = fd.rank_sym(fm, c, sp)
    err = max(max_abs_err(g, w) for g, w in zip(got, twin))
    err_o = max(max_abs_err(got[0], base[0] + OFFSET), max_abs_err(got[1], base[1]))
    if err or err_o:
        fail("%s: offset-rows rank: err %d against the twin, %d against rank + O"
             % (label, err, err_o))
    say("%s: offset-rows rank of %d random rows (O = %d): equal to its twin and to the "
        "original rank + O (largest rank %d); kernel %.4f ms"
        % (label, MANY_ROWS, OFFSET, int(got[0].max()),
           cuda_ms(lambda: fd.rank_sym(off, c, sp), 20)))


def unfused_records(label, eng, queries, launches, replaces):
    """The non-fused engine's kernels on the very tensors it hands their
    wrappers for one batch of a path of E (the first call of each, as the
    engine runs it): chain_search_lanes on the batch's strand lanes,
    prefix_search on the exact path's boundary searches, and resolve_rows on
    every SA row of the batch's fast units.  A run of many long lanes takes
    the kernel hundreds of ms and its twin minutes, so those are timed on
    fewer repeats."""
    import torch
    from centrifuger_tpu_torch import kernels
    from centrifuger_tpu_torch.classify import engine_unfused as engine_mod
    from centrifuger_tpu_torch.fm import device as fd
    names = ("chain_search_lanes", "prefix_search", "resolve_rows")
    with spying(engine_mod, names) as handed:
        eng.query_batch(queries)
    fm = eng.dev
    rec = Records(fm, launches, label.replace("phase 6 ", ""))
    codes, lengths, mhl, H = handed["chain_search_lanes"]
    long_lanes = codes.shape[1] > 1024
    say("%s: the engine hands chain_search_lanes %d lanes x %d codes (H=%d)"
        % (label, codes.shape[0], codes.shape[1], H))
    rec.add(kernels.instantiation("chain_search", fm, ("lanes",)), replaces["chain_search"],
            lambda: fd.chain_search_lanes(fm, codes, lengths, mhl, H),
            lambda: fd.chain_search_lanes_plain(fm, codes, lengths, mhl, H),
            nbytes(codes, lengths), reps=5 if long_lanes else 20,
            plain_reps=0 if long_lanes else 3)
    if "prefix_search" in handed:
        codes, ms = handed["prefix_search"]
        say("%s: the exact path hands prefix_search %d lanes x %d codes (ms %d-%d)"
            % (label, codes.shape[0], codes.shape[1], int(ms.min()), int(ms.max())))
        rec.add(kernels.instantiation("prefix_search", fm), replaces["prefix_search"],
                lambda: fd.prefix_search(fm, codes, ms),
                lambda: fd.prefix_search_plain(fm, codes, ms), nbytes(codes, ms))
    elif launches.get(kernels.instantiation("prefix_search", fm)):
        fail("%s: prefix_search launched on the path but not on its first batch" % label)
    rows, valid = handed["resolve_rows"]
    say("%s: the engine hands resolve_rows %d rows" % (label, len(rows)))
    whole = whole_rowmap(fm)
    rec.add(kernels.instantiation("resolve_rows", fm), replaces["resolve_rows"],
            lambda: fd.resolve_rows(fm, rows, valid),
            lambda: fd.resolve_rows_plain(fm, rows, valid), nbytes(rows, valid),
            lambda: torch.index_select(whole, 0, rows))
    del whole
    return rec.recs


def check_split_views(eng, queries):
    """The sharded index's split of a batch over several cards, on one card:
    with two views of cuda:0 standing for two cards, over_devices runs each
    half of the units on its view and gathers the outputs, which must equal
    the one-view program's."""
    import torch
    sh = eng.dev
    want = eng._dispatch_fused(queries)["out"]
    views, sh.views = sh.views, [sh, sh]
    try:
        got = eng._dispatch_fused(queries)["out"]
    finally:
        sh.views = views
    torch.cuda.synchronize()
    keys = ("packed", "hits", "nhits", "host_blob")
    if any(not torch.equal(got[k], want[k]) for k in keys):
        fail("path F: the batch split over two views of cuda:0 differs from one view's")
    say("path F: a batch of %d pairs split over two views of cuda:0 (over_devices' split "
        "and gather) equals the one-view program's %s" % (len(queries), "/".join(keys)))


def phase_dp_step(eng, queries):
    """K11: classify_dp_step on one batch's strand lanes (the non-fused
    engine's code lanes: 4 a pair) over [cuda:0] and over [cuda:0, cuda:0],
    with the launch counts set to 0 just before the two-part run and read
    just after; both runs equal each other and the plain versions (the chain
    and the start-row resolve twins), and total_hits the sum of nhits."""
    import torch
    from centrifuger_tpu_torch import kernels
    from centrifuger_tpu_torch.fm import device as fd
    from centrifuger_tpu_torch.parallel.mesh import classify_dp_step
    fm = eng.dev
    raws = [q[0] for q in queries] + [q[1] for q in queries if q[1] is not None]
    codes, lengths = (torch.from_numpy(a).cuda() for a in eng._encode_lanes(raws))
    mhl = eng.param.min_hit_len
    H = codes.shape[1] // (mhl + 1) + 1
    one = classify_dp_step(fm, ["cuda:0"], mhl, H)
    two = classify_dp_step(fm, ["cuda:0", "cuda:0"], mhl, H)
    kernels.reset_launches()
    got = two(codes, lengths)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want_one = one(codes, lengths)
    # an index on the host: the step keeps its own replica of it on the card
    host = fd.TorchFM(fd.fm_arrays(eng.fm), "cpu")
    moved = classify_dp_step(host, ["cuda:0"], mhl, H)(codes, lengths)
    if host.device.type != "cpu" or any(
            max_abs_err(moved[k], want_one[k]) for k in want_one):
        fail("classify_dp_step: the replica of a host index on cuda:0 disagrees with "
             "the index on the card, or moved the host index")
    del host, moved

    def plain():
        hits, nh = fd.chain_search_lanes_plain(fm, codes, lengths, mhl, H)
        has_hit = torch.arange(H, device="cuda")[None, :] < nh[:, None]
        rows = torch.where(has_hit, hits[:, :, 0], torch.zeros_like(hits[:, :, 0]))
        seqids = fd.resolve_rows_plain(fm, rows.reshape(-1), has_hit.reshape(-1))
        return dict(nhits=nh, sp=hits[:, :, 0], ep=hits[:, :, 1], l=hits[:, :, 2],
                    off=hits[:, :, 3], seqids=seqids.reshape(-1, H),
                    total_hits=nh.sum(dtype=torch.int64))
    rec = Records(fm, launches, "K11")
    want, table_bytes, _ = rec.traffic(plain)
    err = max(max(max_abs_err(got[k], want[k]), max_abs_err(got[k], want_one[k]))
              for k in want)
    if err or int(got["total_hits"]) != int(got["nhits"].sum()):
        fail("classify_dp_step: the parts disagree with one part or the plain versions, "
             "or total_hits is not the sum of nhits")
    ms, ms_one = cuda_ms(lambda: two(codes, lengths), 20), cuda_ms(lambda: one(codes, lengths), 20)
    dev_ms = device_ms(lambda: two(codes, lengths), 5)
    outs = [v for v in got.values()]
    bound_ms, bound_by = rec.bound(table_bytes, nbytes(codes, lengths) + nbytes(*outs))
    n_launch = sum(launches.values())
    r = dict(name="classify_dp_step", path="K11", route="cuda",
             source="centrifuger_tpu_torch/parallel/mesh.py", replaces=
             "centrifuger_tpu/parallel/mesh.py:31", kernels=sorted(launches),
             launches=n_launch, max_abs_err=err, ms=ms, device_ms=dev_ms,
             plain_ms=cuda_ms(plain, 3), bound_ms=bound_ms, bound_by=bound_by,
             library_ms=None, library_device_ms=None)
    say("phase 6: classify_dp_step (K11) [%d lanes x %d codes, %d hits, total_hits %d]: "
        "err 0 (a host index's replica on cuda:0 too)  two parts on cuda:0 %.4f ms (device "
        "%s; one part %.4f ms)  plain %.4f ms  bound %.4f ms (%s)  launches %s"
        % (codes.shape[0], codes.shape[1], int(got["nhits"].sum()), int(got["total_hits"]),
           ms, ms_text(dev_ms), ms_one, r["plain_ms"], bound_ms, bound_by, launches))
    if launches != {kernels.instantiation("chain_search", fm, ("lanes",)): 2,
                    kernels.instantiation("resolve_rows", fm): 2}:
        fail("classify_dp_step: want 2 chain and 2 resolve launches, got %s" % launches)
    return r


def phase_dep_gather(seed):
    """K12: the microbenchmark's driver with the launch counts set to 0 just
    before and read just after, then its kernel against its twin on the
    probe's inputs."""
    import torch
    from centrifuger_tpu_torch import kernels
    from centrifuger_tpu_torch.tools import micro_gather as mg
    kernels.reset_launches()
    got, want, ms, _ = mg.run("cuda", seed)
    launches = kernels.LAUNCHES.get("dep_gather", 0)
    if not launches or max_abs_err(got, want):
        fail("dep_gather: never launched by its driver, or disagrees with its twin")
    table, idx = mg.make_inputs(seed, "cuda")

    def kernel():
        return mg.dep_gather(table, idx)

    def plain():
        return mg.dep_gather_plain(table, idx)
    err = max_abs_err(kernel(), plain())
    torch.cuda.synchronize()
    io_bytes = nbytes(table, idx) + idx.numel() * 4
    # per lane and step: two loads, xor, modulo, the row address
    ops = 6 * mg.NITER * idx.numel()
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_MS, ops / OPS_PER_MS
    rec = dict(name="dep_gather", path="K12", route="cuda", source=CSRC % "dep_gather",
               replaces="tools/micro_gather.py:110", launches=launches, max_abs_err=err,
               ms=cuda_ms(kernel, 20), device_ms=device_ms(kernel, 5),
               plain_ms=cuda_ms(plain, 3), bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
               library_device_ms=None)
    if err:
        fail("dep_gather disagrees with its plain twin")
    say("path K12: dep_gather [%d lanes x %d dependent fetches, table %d x %d u32, %.2f MB, "
        "L2-resident]: err 0  kernel %.4f ms (device %s)  plain %.4f ms  bound %.6f ms (%s)  "
        "launches %d"
        % (idx.numel(), mg.NITER, table.shape[0], table.shape[1], nbytes(table) / 1e6,
           rec["ms"], ms_text(rec["device_ms"]), rec["plain_ms"], rec["bound_ms"],
           rec["bound_by"], launches))
    return rec


def many_ranks_ms(fm):
    """Kernel ms of one rank of MANY_ROWS random rows: enough work a launch for
    the layouts to be told apart (a batch's lane count is near the launch
    cost)."""
    from centrifuger_tpu_torch.fm import device as fd
    c, sp, _ = probe_tensors(fm, MANY_ROWS, seed=6)
    return cuda_ms(lambda: fd.rank_sym(fm, c, sp), 20)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--db-nt", type=int, default=64_000_000,
                    help="synthetic nucleotide DB size (the repo's big DB is 300000000)")
    ap.add_argument("--db-aa", type=int, default=32_000_000,
                    help="synthetic protein DB size in amino acids")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(REPO, "centrifuger_tpu_torch")):
        fail("centrifuger_tpu_torch is not beside this script; run it from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    from centrifuger_tpu_torch import kernels

    t_start = time.time()
    os.makedirs(OUT, exist_ok=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    log = open(os.path.join(OUT, "smoke_log.txt"), "w")
    sys.stdout = tee = Tee(sys.stdout, os.path.join(OUT, "smoke_stdout.txt"))
    db_procs = {}
    succinct_procs = []
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        say("phase 1: %s" % smi)
        # the three databases and path L's chunked build of the main one:
        # data and host index build, one process each, beside the kernel
        # build and the goldens
        mp = multiprocessing.get_context("spawn")
        for kind, size in (("main", args.db_nt), ("protein", args.db_aa),
                           ("ftab12", args.db_nt), ("chunked", args.db_nt)):
            db_procs[kind] = mp.Process(target=make_database,
                                        args=(kind, size, args.seed))
            db_procs[kind].start()
        secs = kernels.build_all()
        say("phase 2: kernels built in %.1f s" % secs)
        t0 = time.time()
        from centrifuger_tpu_torch import native
        native.load("fastqpack")
        say("phase 2: native FASTQ packer built in %.1f s" % (time.time() - t0))
        for k, text in kernels.BUILD_LOG.items():
            log.write("---- nvcc %s\n%s\n" % (k, text))

        phase_goldens(log)

        dirs = {k: os.path.join(WORK, k) for k in db_procs}
        prefixes = {k: os.path.join(d, "db") for k, d in dirs.items()}
        for kind, proc in db_procs.items():
            proc.join()
            if proc.exitcode != 0:
                fail("building the %s database failed (chiprun_out/build_%s.txt)"
                     % (kind, kind))
            with open(os.path.join(dirs[kind], "times.json")) as f:
                times = json.load(f)
            say("phase 2: %s database: data written in %.1f s, index built in %.1f s "
                "(rowmap: %s; peak RSS %s after the data, %s after the build, sampled "
                "every 20 ms), %.1f s after the start"
                % (kind, times["data_s"], times["build_s"],
                   os.path.exists(prefixes[kind] + ".rowmap.npz"),
                   mb_text(times["rss_data_mb"]), mb_text(times["rss_peak_mb"]),
                   time.time() - t_start))
            if kind == "chunked":
                with open(os.path.join(OUT, "build_chunked.txt")) as f:
                    build_log = f.read()
                plan = re.search(r"chunk plan: (\d+) chunks", build_log)
                ckpts = build_log.count("] checkpoint at chunk ")
                if not plan or not ckpts or "cfr_write_s" not in times:
                    fail("path L: the chunked build wrote no chunk plan, state checkpoint "
                         "or .cfr files (chiprun_out/build_chunked.txt)")
                say("phase 2: path L: %s (%s): %s chunks, %d state checkpoints; "
                    ".cfr written in %.2f s" % (" ".join(CHUNKED_BUILD), re.search(
                        r"build-mem \d+: using bmax=\d+.*", build_log).group(0),
                        plan.group(1), ckpts, times["cfr_write_s"]))
                growth = None if times["rss_build_peak_mb"] is None else \
                    times["rss_build_peak_mb"] - times["rss_start_mb"]
                rowmap = os.path.exists(prefixes[kind] + ".rowmap.npz")
                say("phase 2: path L: peak RSS growth over the build's start %s (RSS %s at "
                    "the start, peak %s; the process's peak after its data %s) against "
                    "--build-mem %d MB; bmax %s; rowmap captured: %s; build %.1f s (.cfr "
                    "write included in the RSS, not in the seconds)"
                    % (mb_text(growth), mb_text(times["rss_start_mb"]),
                       mb_text(times["rss_build_peak_mb"]), mb_text(times["rss_data_mb"]),
                       CHUNKED_BUDGET_MB, re.search(r"using bmax=(\d+)", build_log).group(1),
                       rowmap, times["build_s"]))
                if growth is None or growth > CHUNKED_BUDGET_MB or not rowmap:
                    fail("path L: the chunked build's peak RSS growth %s is over --build-mem "
                         "%d MB, or not measured, or it captured no rowmap"
                         % (mb_text(growth), CHUNKED_BUDGET_MB))
                if times.get("resume_stopped") != "interrupted" or \
                        not times["resume_interrupted"] or len(times["resume_fresh"]) != 1 \
                        or not times["resume_equal"]:
                    fail("path L: the resume check under another --bmax failed: %r"
                         % {k: v for k, v in times.items() if k.startswith("resume")})
                say("phase 2: path L: resume check on the first two genomes (%d nt): SA-IS "
                    "build %.2f s; chunked --checkpoint --bmax %d stopped after its first "
                    "state checkpoint (%s) in %.2f s; rerun at --bmax %d: \"%s\", %.2f s; "
                    ".fm.npz and .rowmap.npz arrays equal the SA-IS build's"
                    % (times["resume_nt"], times["resume_sais_s"], RESUME_BMAX[0],
                       times["resume_interrupted"][0], times["resume_interrupted_s"],
                       RESUME_BMAX[1], times["resume_fresh"][0], times["resume_resumed_s"]))
        say("sizes: main %d nt; protein %d aa; ftab12 %d nt (ftab %d entries); %d / %d / "
            "%d read pairs" % (args.db_nt, args.db_aa,
                               args.db_nt // N_GENOMES * FTAB12_GENOMES, 4 ** 12,
                               N_PAIRS, N_PAIRS, FTAB12_PAIRS))

        def keys(layout, *kernel_names):
            return ["%s:%s" % (k, layout) for k in kernel_names]
        fused = ("chain_search", "finalize_units", "prefix_search", "resolve_rows",
                 "rank_probe")
        tsv, launches = {}, {}
        tsv["main"], launches["main"] = run_path(
            "main", "phase 4", prefixes["main"], dirs["main"], [], N_PAIRS,
            keys("plain", *fused), log)
        tsv["no_rowmap"], _ = run_path(
            "no_rowmap", "phase 5", prefixes["main"], dirs["main"], ["--no-rowmap"],
            N_PAIRS, keys("plain", "chain_search", "finalize_units"), log)
        if tsv["no_rowmap"] != tsv["main"]:
            fail("--no-rowmap TSV differs from the rowmap TSV")
        say("phase 5: --no-rowmap TSV identical (%d lines)" % tsv["main"].count("\n"))
        tsv["runblock"], launches["runblock"] = run_path(
            "runblock", "path B", prefixes["main"], dirs["main"],
            ["--serve-layout", "runblock"], N_PAIRS, keys("runblock", *fused), log)
        tsv["runblock_lf"], _ = run_path(
            "runblock --no-rowmap", "path B", prefixes["main"], dirs["main"],
            ["--serve-layout", "runblock", "--no-rowmap"], N_PAIRS,
            keys("runblock", "chain_search", "finalize_units"), log)
        if tsv["runblock"] != tsv["main"] or tsv["runblock_lf"] != tsv["main"]:
            fail("--serve-layout runblock TSV differs from the plain layout's")
        say("path B: --serve-layout runblock TSV identical to the plain layout's, with "
            "and without --no-rowmap")
        tsv["protein"], launches["protein"] = run_path(
            "protein", "path A", prefixes["protein"], dirs["protein"], [], N_PAIRS,
            ["translate_frames", "chain_search:generic:lanes",
             "finalize_units:generic:protein", "resolve_rows:generic",
             "rank_probe:generic"], log)
        say("path A: %d of %d pairs classified"
            % (N_PAIRS - tsv["protein"].count("\tunclassified\t"), N_PAIRS))
        tsv["ftab12"], launches["ftab12"] = run_path(
            "ftab12", "path C", prefixes["ftab12"], dirs["ftab12"], [], FTAB12_PAIRS,
            ["chain_search:plain:wideftab", "finalize_units:plain", "rank_probe:plain"],
            log)

        # path D: the main index as an int64 index (K9), no rebuild
        tsv["i64"], launches["i64"] = run_path(
            "int64", "path D", prefixes["main"], dirs["main"], [], N_PAIRS,
            keys("plain:i64", *fused), log, force_idtype="int64")
        tsv["i64_lf"], _ = run_path(
            "int64 --no-rowmap", "path D", prefixes["main"], dirs["main"], ["--no-rowmap"],
            N_PAIRS, keys("plain:i64", "chain_search", "finalize_units"), log,
            force_idtype="int64")
        tsv["i64_generic"], launches["i64_generic"] = run_path(
            "int64 runblock (generic)", "path D", prefixes["main"], dirs["main"],
            ["--serve-layout", "runblock"], N_PAIRS, keys("generic:i64", *fused), log,
            force_idtype="int64")
        if any(tsv[k] != tsv["main"] for k in ("i64", "i64_lf", "i64_generic")):
            fail("an int64 TSV differs from the main path's")
        say("path D: int64 TSVs (plain, plain --no-rowmap, runblock served as generic) "
            "identical to the main path's")

        # path E: the non-fused engine, long reads, -k 0
        unfused = ["chain_search:plain:lanes", "resolve_rows:plain"]
        tsv["jax"], launches["jax"] = run_path(
            "--engine jax", "path E", prefixes["main"], dirs["main"], ["--engine", "jax"],
            N_PAIRS, unfused, log)
        if tsv["jax"] != tsv["main"]:
            fail("the --engine jax TSV differs from the main path's")
        say("path E: --engine jax TSV identical to the main path's")
        dirs["long"], dirs["k0"] = os.path.join(dirs["main"], "long"), os.path.join(WORK, "k0")
        tsv["long"], launches["long"] = run_path(
            "long reads", "path E", prefixes["main"], dirs["long"], [], N_LONG, unfused, log,
            paired=False)
        head_pairs(dirs["main"], K0_PAIRS, dirs["k0"])
        tsv["k0"], launches["k0"] = run_path(
            "-k 0", "path E", prefixes["main"], dirs["k0"], ["-k", "0"], K0_PAIRS, unfused, log)
        say("path E: long reads: %d of %d classified; -k 0: %d TSV lines for %d pairs"
            % (N_LONG - tsv["long"].count("\tunclassified\t"), N_LONG,
               tsv["k0"].count("\n") - 1, K0_PAIRS))

        # path F: the main index served sharded (K10), no rebuild; one batch
        # covers the first 8,192 pairs, the head of the main path's reads
        t_f = time.time()
        tsv["shards2"], launches["shards2"] = run_path(
            "--shards 2", "path F", prefixes["main"], dirs["main"], ["--shards", "2"], N_PAIRS,
            keys("plain_sharded", *fused), log)
        tsv["shards4_lf"], launches["shards4_lf"] = run_path(
            "--shards 4 --no-rowmap", "path F", prefixes["main"], dirs["k0"],
            ["--shards", "4", "--no-rowmap"], K0_PAIRS,
            keys("plain_sharded", "chain_search", "finalize_units"), log)
        tsv["shards_i64"], launches["shards_i64"] = run_path(
            "int64 --shards 2", "path F", prefixes["main"], dirs["k0"], ["--shards", "2"],
            K0_PAIRS, keys("plain_sharded:i64", *fused), log, force_idtype="int64")
        tsv["shards_jax"], launches["shards_jax"] = run_path(
            "--engine jax --shards 2", "path F", prefixes["main"], dirs["k0"],
            ["--engine", "jax", "--shards", "2"], K0_PAIRS,
            ["chain_search:plain_sharded:lanes", "resolve_rows:plain_sharded"], log)
        if tsv["shards2"] != tsv["main"]:
            fail("the --shards 2 TSV differs from the main path's")
        for k in ("shards4_lf", "shards_i64", "shards_jax"):
            if not tsv["main"].startswith(tsv[k]) or tsv[k].count("\n") != K0_PAIRS + 1:
                fail("path F: the %s TSV is not the head of the main path's" % k)
        say("path F: --shards 2 TSV identical to the main path's; --shards 4 --no-rowmap, "
            "int64 --shards 2 and --engine jax --shards 2 identical to its first %d pairs; "
            "every launch a plain_sharded instantiation" % K0_PAIRS)
        if torch.cuda.device_count() > 1:
            tsv["shards_2cards"], _ = run_path(
                "--shards 2 over cuda:0 and cuda:1", "path F", prefixes["main"], dirs["k0"],
                ["--shards", "2"], K0_PAIRS, keys("plain_sharded", "chain_search"), log,
                shard_devices=["cuda:0", "cuda:1"])
            if not tsv["main"].startswith(tsv["shards_2cards"]):
                fail("path F: the TSV over two cards is not the head of the main path's")
            say("path F: --shards 2 over two cards (peer access) identical to the head of "
                "the main path's TSV")
        else:
            say("path F: one CUDA device (torch.cuda.device_count() == 1): the run of "
                "--shards 2 over two cards with peer access was not possible here")
        say("path F: runs took %.1f s" % (time.time() - t_f))

        # paths G-J: the bulk FASTQ route and the wide-row cache, the
        # read-prep flags, multi-host striping, a reference-built index
        t_g = time.time()
        tsv["bulk"] = phase_bulk(prefixes["main"], dirs["main"], log)
        phase_read_prep(prefixes["main"], dirs["k0"], log, args.seed + 3)
        phase_multihost(prefixes["main"], dirs["main"],
                        {"paired": tsv["main"], "bulk": tsv["bulk"]}, log)
        phase_cfr(log, prefixes["protein"])
        say("paths G-J took %.1f s" % (time.time() - t_g))

        # paths L and M: the chunked build and its .cfr; the downstream CLIs
        t_l = time.time()
        launches["cfr_chunked"] = phase_chunked(prefixes, dirs["k0"], tsv["main"], log)
        say("path L took %.1f s" % (time.time() - t_l))
        t_m = time.time()
        phase_downstream(prefixes["main"], tsv["main"])
        say("path M took %.1f s" % (time.time() - t_m))

        # path N: the card's oracle, then the succinct library (host code)
        # in a process of its own beside path O and phase 6
        succinct = os.path.join(WORK, "succinct")
        os.makedirs(succinct)
        t_n = time.time()
        succinct_oracle(prefixes["main"], args.seed + 4, os.path.join(succinct, "oracle.npz"))
        ctx = dict(prefix=prefixes["main"], db_nt=args.db_nt, seed=args.seed,
                   map_path=os.path.join(dirs["main"], "ref_seqid.map"),
                   oracle_path=os.path.join(succinct, "oracle.npz"))
        for i, parts in enumerate(SUCCINCT_PROCS):
            succinct_procs.append(mp.Process(target=succinct_process, args=(
                os.path.join(succinct, "lines_%d.txt" % i), parts, ctx)))
            succinct_procs[-1].start()
        # path O: cfr-download-torch from a local mirror, then build and classify
        t_o = time.time()
        phase_download(make_genomes(args.db_nt, args.seed), dirs["main"], dirs["k0"], log)
        say("path O took %.1f s" % (time.time() - t_o))
        gc.collect()
        recs_k12 = phase_dep_gather(args.seed)

        # rates, device busy and idle share, kernel records: one engine a path.
        # A record names the JAX program its kernel replaces: on paths A and B
        # the rank layout under the four kernels (K7 :372, K8 :521)
        jax_fm, jax_de = "centrifuger_tpu/fm/device.py:", \
            "centrifuger_tpu/classify/device_engine.py:"
        recs = []
        bq = read_batches(dirs["main"])
        eng = make_engine(prefixes["main"])
        engine_rates("phase 4", eng, bq, N_PAIRS, "profile.txt")
        r, ref_hits = phase_kernels("phase 6 main", eng, bq, launches["main"], {
            "chain_search": jax_fm + "852 + " + jax_de + "145",
            "finalize_units": jax_de + "164", "prefix_search": jax_fm + "1147",
            "resolve_rows": jax_fm + "707", "rank_probe": jax_fm + "450"}, finalize_lf=True)
        recs += r
        eng._finish_pool().shutdown()
        del eng

        eng = make_engine(prefixes["main"], "runblock")
        engine_rates("path B", eng, bq, N_PAIRS, "profile_runblock.txt")
        r, _ = phase_kernels("phase 6 path B", eng, bq, launches["runblock"], {
            k: jax_fm + "521" for k in fused}, ref_hits=ref_hits, finalize_lf=True)
        recs += r
        eng._finish_pool().shutdown()
        del eng, bq

        bq = read_batches(dirs["protein"])
        eng = make_engine(prefixes["protein"])
        engine_rates("path A", eng, bq, N_PAIRS, "profile_protein.txt")
        r, _ = phase_kernels("phase 6 path A", eng, bq, launches["protein"], {
            "translate_frames": "none (the host's _pack_reads_protein)",
            "chain_search": jax_fm + "372", "finalize_units": jax_de + "185",
            "resolve_rows": jax_fm + "372", "rank_probe": jax_fm + "372"})
        recs += r
        eng._finish_pool().shutdown()
        del eng, bq

        bq = read_batches(dirs["ftab12"])
        eng = make_engine(prefixes["ftab12"])
        engine_rates("path C", eng, bq, FTAB12_PAIRS, "profile_ftab12.txt")
        r, _ = phase_kernels("phase 6 path C", eng, bq, launches["ftab12"],
                             {"chain_search": jax_fm + "1000"})
        recs += r
        eng._finish_pool().shutdown()
        del eng, bq

        # path D's int64 instantiations (K9: the idtype switch :215, int64
        # ftab2 :282, 40-bit _wide_occ :487, int64 occ / cum :141)
        bq = read_batches(dirs["main"])
        eng = make_engine(prefixes["main"], force_idtype="int64")
        engine_rates("path D", eng, bq, N_PAIRS, "profile_int64.txt")
        r, _ = phase_kernels("phase 6 path D", eng, bq, launches["i64"], {
            "chain_search": jax_fm + "852 + 282", "finalize_units": jax_de + "164",
            "prefix_search": jax_fm + "1147", "resolve_rows": jax_fm + "707",
            "rank_probe": jax_fm + "487"}, ref_hits=ref_hits)
        recs += r
        offset_rows_check("path D", eng.dev)
        eng._finish_pool().shutdown()
        del eng
        eng = make_engine(prefixes["main"], "runblock", force_idtype="int64")
        engine_rates("path D runblock (generic)", eng, bq, N_PAIRS,
                     "profile_int64_generic.txt")
        r, _ = phase_kernels("phase 6 path D generic", eng, bq, launches["i64_generic"], {
            k: jax_fm + "141 + 372" for k in fused}, ref_hits=ref_hits, finalize_lf=True)
        recs += r
        eng._finish_pool().shutdown()
        del eng

        # path E: the non-fused engine's rate, then its kernels on each run's
        # first batch, through the engine the CLI made for that run
        from centrifuger_tpu_torch.classify.params import ClassifierParam
        eng = make_engine(prefixes["main"], unfused=True)
        engine_rates("path E", eng, bq, N_PAIRS, "profile_unfused.txt")
        unfused_jax = {"chain_search": jax_fm + "852", "prefix_search": jax_fm + "1147",
                       "resolve_rows": jax_fm + "707"}
        recs += unfused_records("phase 6 path E --engine jax", eng, bq[0], launches["jax"],
                                unfused_jax)
        recs += unfused_records("phase 6 path E long reads", make_engine(
            prefixes["main"], dev=eng.dev), read_batches(dirs["long"], paired=False)[0],
            launches["long"], unfused_jax)
        recs += unfused_records("phase 6 path E -k 0", make_engine(
            prefixes["main"], dev=eng.dev, param=ClassifierParam(max_result=0)), bq[0],
            launches["k0"], unfused_jax)
        del eng

        # path F: the plain_sharded instantiations (K10) at the path's shapes,
        # each beside the unsharded kernel's time of this run; then K11
        t_f = time.time()
        # each sharded record's unsharded counterpart: the same kernel on the
        # same shapes, on the path that runs it unsharded
        twin_path = {"path F": "main", "path F int64": "path D",
                     "path F --engine jax": "path E --engine jax"}
        unsharded = {(r["path"], r["name"]): r["ms"] for r in recs}
        jax_sh = "centrifuger_tpu/parallel/sharded.py:36 + "
        sharded_jax = {
            "chain_search": jax_sh + jax_fm + "852", "finalize_units": jax_sh + jax_de + "164",
            "prefix_search": jax_sh + jax_fm + "1147", "resolve_rows": jax_sh + jax_fm + "707",
            "rank_probe": jax_sh + jax_fm + "450"}
        eng = make_engine(prefixes["main"], shards=2)
        say("path F: per_shard_bytes %s, per_device_bytes %s, replicated_bytes %d"
            % (eng.dev.per_shard_bytes(), eng.dev.per_device_bytes(),
               eng.dev.replicated_bytes()))
        engine_rates("path F", eng, bq, N_PAIRS, "profile_sharded.txt")
        r, _ = phase_kernels("phase 6 path F", eng, bq, launches["shards2"], sharded_jax,
                             ref_hits=ref_hits)
        recs += r
        check_split_views(eng, bq[0])
        eng._finish_pool().shutdown()
        recs += unfused_records("phase 6 path F --engine jax", make_engine(
            prefixes["main"], dev=eng.dev, unfused=True), bq[0], launches["shards_jax"],
            {k: sharded_jax[k] for k in ("chain_search", "prefix_search", "resolve_rows")})
        del eng
        eng = make_engine(prefixes["main"], force_idtype="int64", shards=2)
        r, _ = phase_kernels("phase 6 path F int64", eng, bq, launches["shards_i64"],
                             sharded_jax, ref_hits=ref_hits)
        recs += r
        eng._finish_pool().shutdown()
        del eng
        for r in recs:
            base = (twin_path.get(r["path"]), r["name"].replace("plain_sharded", "plain"))
            if base in unsharded:
                say("path F: %-36s %.4f ms; %s on %s %.4f ms in this run: %.3fx"
                    % (r["name"], r["ms"], base[1], base[0], unsharded[base],
                       r["ms"] / unsharded[base]))
        eng = make_engine(prefixes["main"])
        recs.append(phase_dp_step(eng, bq[0]))
        eng._finish_pool().shutdown()
        say("phase 6 path F and K11 took %.1f s" % (time.time() - t_f))
        recs.append(recs_k12)
        del eng, bq, ref_hits
        torch.cuda.empty_cache()

        # the head of each path's reads on the CPU (plain versions)
        check_cpu_head("phase 6 main", "main", prefixes["main"], dirs["main"],
                       tsv["main"], [], log)
        check_cpu_head("path A", "protein", prefixes["protein"], dirs["protein"],
                       tsv["protein"], [], log)
        check_cpu_head("path C", "ftab12", prefixes["ftab12"], dirs["ftab12"],
                       tsv["ftab12"], [], log)
        check_cpu_head("path E", "long", prefixes["main"], dirs["long"], tsv["long"], [],
                       log, paired=False)
        check_cpu_head("path E", "k0", prefixes["main"], dirs["k0"], tsv["k0"], ["-k", "0"],
                       log)

        for i, proc in enumerate(succinct_procs):
            proc.join()
            with open(os.path.join(succinct, "lines_%d.txt" % i)) as f:
                sys.stdout.write(f.read())
            if proc.exitcode != 0:
                fail("path N: the process of %s failed (exit code %r)"
                     % (", ".join(SUCCINCT_PROCS[i]), proc.exitcode))
        say("path N: its %d processes joined %.1f s after its oracle ran"
            % (len(succinct_procs), time.time() - t_n))

        say("total %.1f s" % (time.time() - t_start))
        print(smi)
        print(json.dumps({"kernels": recs}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    finally:
        for proc in [*db_procs.values(), *succinct_procs]:
            if proc.is_alive():
                proc.terminate()
            proc.join()
        log.close()
        sys.stdout = tee.stream
        tee.file.close()
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
