#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives centrifuger_tpu_torch's main path (paired-end nucleotide cfr-classify,
fused engine, plain serving layout, int32 index, one device) through the
kernels built from this checkout, and holds every kernel to its plain
PyTorch twin.  Phases (any failure exits non-zero and prints no result):

  1. the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels (one nvcc per source, in parallel)
  3. goldens on the card: the tests/fixtures indexes built by the port,
     classified by the port's CLI on cuda, byte-identical to the goldens
  4. the main path at size: a seeded synthetic DB (default 64 Mnt: 20
     genomes, every odd one a 3% mutant of the one before, with inverted
     repeats), built with the port's builder (rowmap included), and 65,536
     paired 100 bp reads classified through the CLI in batches of 8,192 pairs;
     every kernel must have launched during this run
  5. the same run with --no-rowmap (the LF-walk resolve): the same TSV
  6. each kernel against its plain twin on the same CUDA tensors at the main
     path's shapes, with CUDA-event timings: chain_search and finalize_units
     on one batch of 8,192 pairs (32,768 strand lanes), prefix_search and
     resolve_rows on the very tensors the host finish stage hands them for
     a batch; and the first batch's TSV against a device="cpu" run

The second-to-last stdout line is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.  Logs go to chiprun_out/.

  python3 chip_smoke.py [--db-nt N] [--seed S]
"""

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

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


def fail(msg):
    sys.stderr.write("chip_smoke FAILED: %s\n" % msg)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


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


def write_db(genomes, d):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(os.path.join(d, "ref.fa"), "wb") as f:
        for i, g in enumerate(genomes):
            f.write(b">SEQ_%06d\n" % i)
            s = acgt[g]
            pad = (-len(s)) % 70
            rows = np.concatenate([s, np.zeros(pad, np.uint8)]).reshape(-1, 70)
            out = np.concatenate([rows, np.full((len(rows), 1), 10, np.uint8)], 1)
            out = out.reshape(-1)
            f.write(out[out != 0].tobytes())
    nodes, names, seq_taxids = make_taxonomy(len(genomes))
    with open(os.path.join(d, "ref_seqid.map"), "w") as f:
        f.writelines("SEQ_%06d\t%d\n" % (i, t) for i, t in enumerate(seq_taxids))
    with open(os.path.join(d, "nodes.dmp"), "w") as f:
        f.writelines("%d\t|\t%d\t|\t%s\t|\n" % (t, *nodes[t]) for t in sorted(nodes))
    with open(os.path.join(d, "names.dmp"), "w") as f:
        f.writelines("%d\t|\t%s\t|\t\t|\tscientific name\t|\n" % (t, names[t])
                     for t in sorted(names))


def write_reads(genomes, n_pairs, seed, d):
    """Paired 100 bp reads from 200-400 bp fragments, half of them reverse
    complemented, with 0.5% substitutions."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    qual = b"I" * READ_LEN
    with open(os.path.join(d, "reads_1.fq"), "wb") as f1, \
            open(os.path.join(d, "reads_2.fq"), "wb") as f2:
        for i in range(n_pairs):
            g = genomes[rng.integers(0, len(genomes))]
            fl = int(rng.integers(200, 400))
            p = int(rng.integers(0, len(g) - fl))
            frag = g[p:p + fl]
            if rng.random() < 0.5:
                frag = 3 - frag[::-1]
            mates = [frag[:READ_LEN].copy(), (3 - frag[-READ_LEN:][::-1]).copy()]
            for m, f in zip(mates, (f1, f2)):
                err = rng.random(READ_LEN) < 0.005
                m[err] = rng.integers(0, 4, int(err.sum()), dtype=np.uint8)
                f.write(b"@p%07d\n%s\n+\n%s\n" % (i, acgt[m].tobytes(), qual))


def head_pairs(d, n_pairs, out):
    os.makedirs(out, exist_ok=True)
    for name in ("reads_1.fq", "reads_2.fq"):
        with open(os.path.join(d, name), "rb") as f, \
                open(os.path.join(out, name), "wb") as g:
            for _ in range(4 * n_pairs):
                g.write(f.readline())


# ----------------------------------------------------------------- runners

def build(fx_dir, prefix, log):
    from centrifuger_tpu_torch.build import build_index
    with contextlib.redirect_stderr(log):
        build_index([os.path.join(fx_dir, "ref.fa")],
                    os.path.join(fx_dir, "nodes.dmp"),
                    os.path.join(fx_dir, "names.dmp"),
                    os.path.join(fx_dir, "ref_seqid.map"),
                    conversion_at_file_level=False, output_prefix=prefix)


def classify(prefix, reads_dir, extra, log, paired=True):
    """The port's CLI entry in-process; returns (TSV text, (fast units,
    fallback units))."""
    from centrifuger_tpu_torch.cli import classify_cli
    rargs = (["-1", os.path.join(reads_dir, "reads_1.fq"),
              "-2", os.path.join(reads_dir, "reads_2.fq")] if paired
             else ["-u", os.path.join(reads_dir, "reads_1.fq")])
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = classify_cli.main(["-x", prefix] + rargs + extra)
    log.write(err.getvalue())
    if rc != 0:
        fail("classify_cli returned %r" % rc)
    m = re.search(r"Device units: (\d+) fast, (\d+) fallback", err.getvalue())
    return buf.getvalue(), (tuple(map(int, m.groups())) if m else None)


def read_batches(reads_dir):
    """The paired reads as the CLI batches them: engine queries per batch of
    BATCH_PAIRS pairs."""
    from centrifuger_tpu_torch.cli.classify_cli import _batch_queries
    from centrifuger_tpu_torch.io.readers import ReadFiles
    r1, r2 = ReadFiles(), ReadFiles()
    r1.add_read_file(os.path.join(reads_dir, "reads_1.fq"))
    r2.add_read_file(os.path.join(reads_dir, "reads_2.fq"))
    pairs = list(zip(r1, r2))
    return [_batch_queries(pairs[i:i + BATCH_PAIRS])
            for i in range(0, len(pairs), BATCH_PAIRS)]


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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(a, b):
    if a.shape != b.shape:
        fail("shape mismatch %s vs %s" % (tuple(a.shape), tuple(b.shape)))
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# ------------------------------------------------------------------ phases

def phase_goldens(log):
    fixtures = os.path.join(REPO, "tests", "fixtures")
    for fx, paired in (("tiny", True), ("tiny_single", False), ("small", True)):
        prefix = os.path.join(WORK, "fx_" + fx)
        build(os.path.join(fixtures, fx), prefix, log)
        for tag, extra in (("k1", []), ("k2", ["-k", "2"]), ("k5", ["-k", "5"])):
            got, _ = classify(prefix, os.path.join(fixtures, fx), extra, log, paired)
            with open(os.path.join(fixtures, fx, "golden_class_%s.tsv" % tag)) as f:
                if got != f.read():
                    fail("golden %s %s differs on the card" % (fx, tag))
        say("phase 3: goldens %s k1/k2/k5 byte-identical on cuda" % fx)


def phase_kernels(prefix, reads_dir, launches):
    """Each kernel against its plain twin at the main path's shapes."""
    import torch
    from centrifuger_tpu_torch.build import load_index
    from centrifuger_tpu_torch.classify import engine as engine_mod
    from centrifuger_tpu_torch.classify import device_engine as de
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    from centrifuger_tpu_torch.fm import device as fd

    fm_host, tax, _, _ = load_index(prefix)
    eng = engine_mod.ClassifierTorch(fm_host, tax, ClassifierParam(), device="cuda")
    fm = eng.dev
    batches = read_batches(reads_dir)
    queries = batches[0]
    (pack2, vmask), lengths, nr, L = eng._pack_reads(queries)
    pack2, vmask, lengths = (torch.from_numpy(x).cuda() for x in (pack2, vmask, lengths))
    mhl = eng.param.min_hit_len
    H = L // (mhl + 1) + 1
    me = eng.param.max_result * eng.param.max_result_per_hit_factor
    recs = []

    def bound(table_bytes, io_bytes):
        """(least ms, what bounds it): each input byte read and each output
        byte written once, and the integer work on the table words read."""
        t_bytes = (table_bytes + io_bytes) / HBM_BYTES_PER_MS
        t_ops = OPS_PER_TABLE_BYTE * table_bytes / OPS_PER_MS
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def record(name, replaces, err, ms, plain_ms, table_bytes, io_bytes,
               library_ms=None):
        bound_ms, bound_by = bound(table_bytes, io_bytes)
        recs.append(dict(
            name=name, route="cuda",
            source="centrifuger_tpu_torch/kernels/csrc/%s.cu" % name,
            replaces=replaces, launches=launches[name], max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))
        say("phase 6: %-15s err %d  kernel %.4f ms  plain %.4f ms  bound %.4f ms (%s)%s"
            % (name, err, ms, plain_ms, bound_ms, bound_by,
               "" if library_ms is None else "  library %.4f ms" % library_ms))

    def traffic(fn):
        fm.traffic = 0
        out = fn()
        torch.cuda.synchronize()
        t, fm.traffic = fm.traffic, None
        return out, t

    # K1 + K4
    hits, nhits = de.chain_search(fm, pack2, vmask, lengths, mhl, H)
    (phits, pnh), tr = traffic(lambda: de.chain_search_plain(fm, pack2, vmask, lengths, mhl, H))
    err = max(max_abs_err(hits, phits), max_abs_err(nhits, pnh))
    record("chain_search",
           "centrifuger_tpu/fm/device.py:852 + centrifuger_tpu/classify/device_engine.py:145",
           err, cuda_ms(lambda: de.chain_search(fm, pack2, vmask, lengths, mhl, H), 20),
           cuda_ms(lambda: de.chain_search_plain(fm, pack2, vmask, lengths, mhl, H), 3),
           tr, nbytes(pack2, vmask, lengths, hits, nhits))
    say("phase 6: %d lanes, %d hits, H=%d" % (len(nhits), int(nhits.sum()), H))

    # K3 (with the inline resolve)
    packed = de.finalize_units(fm, hits, nhits, nr, mhl, me, eng.K_OUT)
    ppacked, tr = traffic(lambda: de.finalize_units_plain(fm, hits, nhits, nr, mhl, me,
                                                          eng.K_OUT))
    record("finalize_units", "centrifuger_tpu/classify/device_engine.py:164",
           max_abs_err(packed, ppacked),
           cuda_ms(lambda: de.finalize_units(fm, hits, nhits, nr, mhl, me, eng.K_OUT), 20),
           cuda_ms(lambda: de.finalize_units_plain(fm, hits, nhits, nr, mhl, me,
                                                   eng.K_OUT), 3),
           tr, nbytes(hits, nhits, packed))
    flagged = int(((packed[:, 4] != 0) | (packed[:, 3] > eng.K_OUT)).sum())
    say("phase 6: %d units, %d flagged" % (len(packed), flagged))

    # K5 and K2 on the tensors the host finish stage hands their wrappers
    # when the batches run as on the main path: the first call of each
    handed = {}

    def spy(name, fn):
        def call(fm_, *args):
            handed.setdefault(name, args)
            return fn(fm_, *args)
        return call

    engine_mod.prefix_search = spy("prefix_search", fd.prefix_search)
    engine_mod.resolve_rows = spy("resolve_rows", fd.resolve_rows)
    try:
        for qs in batches:
            eng.finish_packed(eng._dispatch_fused(qs))
            if len(handed) == 2:
                break
    finally:
        engine_mod.prefix_search = fd.prefix_search
        engine_mod.resolve_rows = fd.resolve_rows
    if len(handed) != 2:
        fail("the batches never called prefix_search and resolve_rows")
    codes, ms = handed["prefix_search"]
    rows, valid = handed["resolve_rows"]
    say("phase 6: the finish stage hands prefix_search %d lanes x %d codes (ms "
        "%d-%d, %d lanes with ms < %d) and resolve_rows %d rows"
        % (codes.shape[0], codes.shape[1], int(ms.min()), int(ms.max()),
           int((ms < codes.shape[1]).sum()), codes.shape[1], len(rows)))

    l, sp, ep = fd.prefix_search(fm, codes, ms)
    (pl, psp, pep), tr = traffic(lambda: fd.prefix_search_plain(fm, codes, ms))
    record("prefix_search", "centrifuger_tpu/fm/device.py:1147",
           max(max_abs_err(l, pl), max_abs_err(sp, psp), max_abs_err(ep, pep)),
           cuda_ms(lambda: fd.prefix_search(fm, codes, ms), 20),
           cuda_ms(lambda: fd.prefix_search_plain(fm, codes, ms), 3),
           tr, nbytes(codes, ms) + 3 * nbytes(ms))

    rowmap = fm.rowmap
    for branch in ("rowmap", "lf_walk"):
        fm.rowmap = rowmap if branch == "rowmap" else None
        got = fd.resolve_rows(fm, rows, valid)
        want, tr = traffic(lambda: fd.resolve_rows_plain(fm, rows, valid))
        lib = None
        if branch == "rowmap":
            lib = cuda_ms(lambda: torch.index_select(rowmap, 0, rows), 20)
        rec_err = max_abs_err(got, want)
        ms = cuda_ms(lambda: fd.resolve_rows(fm, rows, valid), 20)
        pms = cuda_ms(lambda: fd.resolve_rows_plain(fm, rows, valid), 3)
        if branch == "rowmap":
            record("resolve_rows", "centrifuger_tpu/fm/device.py:707", rec_err, ms, pms,
                   tr, nbytes(rows, valid, got), lib)
        else:
            if rec_err:
                fail("resolve_rows (LF walk) disagrees with its plain twin")
            say("phase 6: resolve_rows LF-walk branch: err 0  kernel %.4f ms  plain "
                "%.4f ms  bound %.4f ms (%s)"
                % ((ms, pms) + bound(tr, nbytes(rows, valid, got))))
    fm.rowmap = rowmap
    if any(r["max_abs_err"] for r in recs):
        fail("a kernel disagrees with its plain twin: %s" % recs)
    return recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--db-nt", type=int, default=64_000_000,
                    help="synthetic DB size (the repo's big DB is 300000000)")
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
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        say("phase 1: %s" % smi)
        secs = kernels.build_all()
        say("phase 2: kernels built in %.1f s" % secs)
        for k, text in kernels.BUILD_LOG.items():
            log.write("---- nvcc %s\n%s\n" % (k, text))

        phase_goldens(log)

        t0 = time.time()
        genomes = make_genomes(args.db_nt, args.seed)
        write_db(genomes, WORK)
        write_reads(genomes, N_PAIRS, args.seed + 1, WORK)
        del genomes
        say("phase 4: %d nt DB and %d pairs written in %.1f s"
            % (args.db_nt, N_PAIRS, time.time() - t0))
        t0 = time.time()
        prefix = os.path.join(WORK, "db")
        build(WORK, prefix, log)
        say("phase 4: index built in %.1f s (rowmap: %s)"
            % (time.time() - t0, os.path.exists(prefix + ".rowmap.npz")))

        runs = {}
        for name, extra in (("main", []), ("no_rowmap", ["--no-rowmap"])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.time()
            tsv, units = classify(prefix, WORK, extra + ["--batch-size", str(BATCH_PAIRS)],
                                  log)
            wall = time.time() - t0
            launches = dict(kernels.LAUNCHES)
            runs[name] = (tsv, launches)
            say("phase %s: %s: %d pairs in %.2f s through the CLI (index load "
                "included): %.0f read pairs/s; units fast %d fallback %d; launches "
                "%s; peak device memory %.1f MB"
                % ("4" if name == "main" else "5", name, N_PAIRS, wall,
                   N_PAIRS / wall, units[0], units[1], launches,
                   torch.cuda.max_memory_allocated() / 1e6))
            missing = [k for k, v in launches.items() if v == 0]
            if name == "main" and missing:
                fail("kernels never launched on the main path: %s" % missing)
            if launches["chain_search"] == 0 or launches["finalize_units"] == 0:
                fail("%s run did not go through the kernels" % name)
        if runs["no_rowmap"][0] != runs["main"][0]:
            fail("--no-rowmap TSV differs from the rowmap TSV")
        say("phase 5: --no-rowmap TSV identical (%d lines)"
            % runs["main"][0].count("\n"))

        # steady-state serving rate: the engine on the loaded index, 2nd pass
        from centrifuger_tpu_torch.build import load_index
        from centrifuger_tpu_torch.classify.engine import ClassifierTorch
        from centrifuger_tpu_torch.classify.params import ClassifierParam
        fm_host, tax, _, _ = load_index(prefix)
        eng = ClassifierTorch(fm_host, tax, ClassifierParam(), device="cuda")
        bq = read_batches(WORK)
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            for packed, fb, queries in eng.query_pipelined_packed(iter(bq)):
                eng.format_tsv_batch(packed, fb, queries, ["r"] * len(queries))
            rate = N_PAIRS / (time.time() - t0)
        say("phase 4: steady-state engine rate (reads parsed beforehand, TSV "
            "formatted): %.0f read pairs/s" % rate)
        # device busy share of one more pass, from a profiler trace
        from torch.autograd import DeviceType
        from torch.profiler import profile, ProfilerActivity
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for packed, fb, queries in eng.query_pipelined_packed(iter(bq)):
                eng.format_tsv_batch(packed, fb, queries, ["r"] * len(queries))
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        ka = prof.key_averages()
        # kernels and copies only: an aten op's own device time repeats theirs
        busy_ms = sum(k.self_device_time_total for k in ka
                      if k.device_type == DeviceType.CUDA) / 1e3
        with open(os.path.join(OUT, "profile.txt"), "w") as f:
            f.write(ka.table(sort_by="self_device_time_total", row_limit=30))
        say("phase 4: profiled pass: wall %.1f ms, device busy %.2f ms, idle share "
            "%.4f (table in chiprun_out/profile.txt)"
            % (wall_ms, busy_ms, 1 - busy_ms / wall_ms))
        eng._finish_pool().shutdown()
        del eng

        # first batch on the CPU (plain versions) must equal the card's TSV
        head = os.path.join(WORK, "head")
        head_pairs(WORK, BATCH_PAIRS, head)
        cpu_tsv, _ = classify(prefix, head, ["--device", "cpu"], log)
        if not runs["main"][0].startswith(cpu_tsv):
            fail("the first %d pairs differ between cuda and cpu" % BATCH_PAIRS)
        say("phase 6: first %d pairs identical on cpu and cuda" % BATCH_PAIRS)

        recs = phase_kernels(prefix, WORK, runs["main"][1])
        say("total %.1f s" % (time.time() - t_start))
        print(smi)
        print(json.dumps({"kernels": recs}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    finally:
        log.close()
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
