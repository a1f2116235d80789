"""cfr-classify-torch: read classification CLI on the PyTorch/CUDA port.

Port of centrifuger_tpu.cli.classify_cli: the same flags (flag-compatible
with `centrifuger`, reference CentrifugerClass.cpp:20-64) and routes, plus
--device.  Input routes, as there:

  bulk      single-end plain or gzip FASTQ files, default TSV columns: a
            producer thread parses and 2-bit packs each batch in one native C
            pass (io/fastq_fast.py, native/fastqpack.cpp), the serving thread
            uploads and dispatches, finish workers format the TSV
  packed    other default-column runs: ReadFiles objects on a reader thread,
            packed device results straight to TSV lines
  results   barcodes, UMIs, --expand-taxid, --un / --cl, sample sheets: one
            result object a read (query_pipelined) through ResultWriter

--trace-out PATH keeps a record of the engine's spans (spans.py) and writes
them as a Chrome trace at the end; the last log line gives the engine's
stage seconds per read with or without it.

--shards N serves through a sharded index (parallel/sharded.py): N shards
round-robin over the CUDA devices, all on one card where there is one.
--n-ranks P / --rank r classify batches r, r + P, ... of the input; the
--rank-index sidecars let cfr-merge-shards-torch rebuild one TSV.  A prefix
with <prefix>.1.cfr and no <prefix>.fm.npz loads as a reference-built index.

  python -m centrifuger_tpu_torch.cli.classify_cli -x IDX -1 r1.fq -2 r2.fq
"""

import argparse
import gzip
import os
import queue
import sys
import threading
import time
from collections import deque

import numpy as np

from .. import spans
from ..build import load_index, is_protein_index
from ..classify.params import ClassifierParam
from ..io.barcode import BarcodeCorrector, BarcodeTranslator
from ..io.fastq_fast import iter_fastq_batches
from ..io.formatter import ReadFormatter
from ..io.pairmerge import ReadPairMerger
from ..io.readers import ReadFiles, SAMPLE_SHEET_SEPARATOR_READ_ID
from ..io.writer import ResultWriter


def log(msg):
    sys.stderr.write("[%s] %s\n" % (time.strftime("%a %b %d %H:%M:%S %Y"), msg))


def make_classifier(fm, tax, param, protein, engine, device="cuda",
                    no_rowmap=False, serve_layout="plain", force_idtype=None,
                    shards=0, shard_devices=None):
    """The engine the CLI runs.  shards > 1 serves a nucleotide index through
    a ShardedIndex of that many shards, round-robin over shard_devices
    (default: the first min(shards, device count) CUDA devices; on the CPU,
    the CPU); a protein index ignores it, as the JAX CLI does."""
    if engine == "numpy":
        from ..classify.engine_np import ClassifierNP
        return ClassifierNP(fm, tax, param, protein=protein)
    if no_rowmap:
        fm.rowmap = None
    dev = None
    if shards > 1 and not protein:
        from ..fm.device import TorchFM, fm_arrays, resolve_device
        from ..parallel.sharded import ShardedIndex
        if shard_devices is None and resolve_device(device).type == "cpu":
            shard_devices = ["cpu"]
        # made on the host and cut there; ShardedIndex refuses a layout but plain
        with spans.span("load.device_index"):
            host = TorchFM(fm_arrays(fm), "cpu", serve_layout, force_idtype)
            dev = ShardedIndex(host, shards, shard_devices)
    if engine == "jax":
        from ..classify.engine_unfused import ClassifierTorchUnfused
        return ClassifierTorchUnfused(fm, tax, param, protein=protein, dev=dev,
                                      device=device, serve_layout=serve_layout,
                                      force_idtype=force_idtype)
    from ..classify.engine import ClassifierTorch
    return ClassifierTorch(fm, tax, param, protein=protein, dev=dev, device=device,
                           serve_layout=serve_layout, force_idtype=force_idtype)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cfr-classify-torch",
                                 description="Classify reads against a centrifuger index "
                                             "on the PyTorch/CUDA port.")
    ap.add_argument("-x", dest="index", required=True, help="index prefix")
    ap.add_argument("-1", dest="read1", action="append", default=[])
    ap.add_argument("-2", dest="read2", action="append", default=[])
    ap.add_argument("-u", dest="unpaired", action="append", default=[])
    ap.add_argument("-i", dest="interleaved", action="append", default=[])
    ap.add_argument("-t", dest="threads", type=int, default=1)
    ap.add_argument("-k", dest="max_result", type=int, default=1)
    ap.add_argument("-o", dest="output_prefix", default="centrifuger")
    ap.add_argument("--sample-sheet")
    ap.add_argument("--un", dest="un_prefix", default="")
    ap.add_argument("--cl", dest="cl_prefix", default="")
    ap.add_argument("--min-hitlen", type=int, default=0)
    ap.add_argument("--hitk-factor", type=int, default=40)
    ap.add_argument("--merge-readpair", action="store_true")
    ap.add_argument("--expand-taxid", action="store_true")
    ap.add_argument("--read-format", default=None)
    ap.add_argument("--barcode", action="append", default=[])
    ap.add_argument("--UMI", dest="umi", action="append", default=[])
    ap.add_argument("--barcode-whitelist", default=None)
    ap.add_argument("--barcode-translate", default=None)
    ap.add_argument("--engine", choices=["numpy", "jax", "fused"], default="fused",
                    help="compute engine (extension over the reference CLI): fused "
                         "(one device program a batch), jax (the non-fused device "
                         "engine: chain search on the device, finalize on the host) "
                         "or numpy (the host engine)")
    ap.add_argument("--serve-layout", choices=["plain", "runblock"], default="plain",
                    help="device rank tables of a nucleotide index: plain "
                         "(512-byte wide rows, decoded from the run-block BWT at "
                         "the first load and cached in <prefix>.serve_plain_w.npz) "
                         "or runblock (the 84-byte-row mega-table of the "
                         "run-block BWT, leaner in device memory); a load-time "
                         "choice that never changes results")
    ap.add_argument("--no-rowmap", action="store_true",
                    help="ignore the rowmap resolve accelerator even if the "
                         "index carries one (SA resolve walks LF instead)")
    ap.add_argument("--shards", type=int, default=0,
                    help="row-shard the index's big tables into N shards, round-robin "
                         "over the CUDA devices (all on one card where there is one); "
                         "needs the plain serving layout; ignored for a protein index")
    ap.add_argument("--batch-size", type=int, default=0,
                    help="reads per device batch (0 = auto)")
    ap.add_argument("--n-ranks", type=int, default=1,
                    help="multi-host serving: total serving processes; this "
                         "rank handles read batches i with i %% n_ranks == "
                         "rank")
    ap.add_argument("--rank", type=int, default=0,
                    help="this process's rank in [0, n_ranks)")
    ap.add_argument("--rank-index", default=None,
                    help="sidecar file recording TSV rows per processed "
                         "batch, consumed by cfr-merge-shards-torch to rebuild "
                         "the global read order")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index and kernels: cuda (the "
                         "default; raises without a card) or cpu (the plain "
                         "PyTorch versions)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the engine's spans (index load, each batch's "
                         "stages on the serving thread and the finish workers) "
                         "and write them to PATH as a Chrome trace at the end "
                         "(extension over the reference CLI)")
    args = ap.parse_args(argv)
    if args.n_ranks > 1:
        if not (0 <= args.rank < args.n_ranks):
            ap.error("--rank must be in [0, n_ranks)")
        if args.sample_sheet or args.un_prefix or args.cl_prefix:
            ap.error("--n-ranks is incompatible with --sample-sheet/--un/--cl")

    log("Centrifuger(torch) starts.")
    if args.trace_out:
        spans.enable()
    cfr = not os.path.exists(args.index + ".fm.npz") and \
        os.path.exists(args.index + ".1.cfr")
    if cfr:
        # a reference-built index, through the .cfr reader
        from ..interop.cfr import load_cfr_meta
        protein = load_cfr_meta(args.index).get("sequence_type") == "amino_acid"
    else:
        protein = is_protein_index(args.index)
    if args.shards > 1 and not protein and args.engine != "numpy" and \
            args.serve_layout != "plain":
        ap.error("--shards needs the plain serving layout (its wide rank rows are "
                 "what is sharded): drop --serve-layout runblock")
    if cfr:
        from ..interop.cfr import load_cfr_index
        fm, tax, seq_length, meta = load_cfr_index(args.index)
    else:
        fm, tax, seq_length, meta = load_index(args.index)
    log("Finishes loading index.")

    param = ClassifierParam(max_result=args.max_result,
                            min_hit_len=args.min_hitlen,
                            max_result_per_hit_factor=args.hitk_factor,
                            output_expanded_result=args.expand_taxid)

    formatter = ReadFormatter(args.read_format) if args.read_format else None
    corrector = BarcodeCorrector(args.barcode_whitelist) if args.barcode_whitelist else None
    translator = BarcodeTranslator(args.barcode_translate) if args.barcode_translate else None

    reads = ReadFiles()
    mate_reads = ReadFiles()
    barcode_file = ReadFiles()
    umi_file = ReadFiles()
    has_mate = False
    sample_outputs = []
    for f in args.unpaired:
        reads.add_read_file(f)
    for f in args.read1:
        reads.add_read_file(f)
        has_mate = True
    for f in args.read2:
        mate_reads.add_read_file(f)
    for f in args.interleaved:
        reads.add_read_file(f, interleaved=True)
        has_mate = True
    for f in args.barcode:
        barcode_file.add_read_file(f)
    for f in args.umi:
        umi_file.add_read_file(f)
    has_barcode = bool(args.barcode)
    has_umi = bool(args.umi)

    if args.sample_sheet:
        with open(args.sample_sheet) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                r1, r2, bc, um, outf = (parts + ["."] * 5)[:5]
                reads.add_read_file(r1)
                if r2 != ".":
                    mate_reads.add_read_file(r2)
                    has_mate = True
                if bc != ".":
                    has_barcode = True
                    barcode_file.add_read_file(bc)
                if um != ".":
                    has_umi = True
                    umi_file.add_read_file(um)
                sample_outputs.append(outf)
        for rf in (reads, mate_reads, barcode_file, umi_file):
            rf.set_special_read_to_mark_file_end(SAMPLE_SHEET_SEPARATOR_READ_ID)

    if formatter is not None:
        if not has_barcode and formatter.segment_count("bc") > 0:
            has_barcode = True
        if not has_umi and formatter.segment_count("um") > 0:
            has_umi = True

    if corrector is not None and has_barcode:
        corrector.collect_background(barcode_file, formatter)

    classifier = make_classifier(fm, tax, param, protein, args.engine,
                                 device=args.device, no_rowmap=args.no_rowmap,
                                 serve_layout=args.serve_layout, shards=args.shards)
    if getattr(classifier, "dev", None) is not None and \
            classifier.dev.layout == "plain_sharded":
        log(classifier.dev.placement_text())
    log("Inferred --min-hitlen: %d" % classifier.param.min_hit_len)

    writer = ResultWriter()
    writer.has_barcode = has_barcode
    writer.has_umi = has_umi
    writer.output_expanded = args.expand_taxid
    if args.un_prefix:
        writer.set_output_reads(args.un_prefix, has_mate, has_barcode, has_umi, 0)
    if args.cl_prefix:
        writer.set_output_reads(args.cl_prefix, has_mate, has_barcode, has_umi, 1)
    if sample_outputs:
        writer.set_multi_output_file_list(sample_outputs)
    if args.rank == 0:
        writer.output_header()
    rank_counts = []   # TSV rows of each of this rank's batches, in order

    def mine(i):
        """Multi-host input sharding: batch i is this rank's."""
        return i % args.n_ranks == args.rank

    merger = ReadPairMerger() if args.merge_readpair else None
    batch_size = args.batch_size or 1024 * max(args.threads, 8)
    if args.shards > 1:
        # as the JAX CLI, which shards the read lanes over the mesh axis too
        batch_size = -(-batch_size // args.shards) * args.shards

    def iter_units():
        """(r1, r2, barcode read, UMI read) a unit."""
        it1 = iter(reads)
        if reads.interleaved:
            for r1 in it1:
                if args.sample_sheet and r1.id == SAMPLE_SHEET_SEPARATOR_READ_ID:
                    yield r1, None, None, None
                    continue
                yield r1, next(it1, None), None, None
            return
        it2 = iter(mate_reads) if has_mate else None
        itb = iter(barcode_file) if barcode_file.file_count else None
        itu = iter(umi_file) if umi_file.file_count else None
        for r1 in it1:
            yield (r1, next(it2) if it2 is not None else None,
                   next(itb, None) if itb is not None else None,
                   next(itu, None) if itu is not None else None)

    def formatted_units():
        """(r1, r2, barcode, umi) a unit, the read format, barcode correction
        and translation applied."""
        for r1, r2, rb, ru in iter_units():
            if args.sample_sheet and r1.id == SAMPLE_SHEET_SEPARATOR_READ_ID:
                yield r1, r2, None, None
                continue
            barcode = umi = None
            if formatter is not None:
                r1.seq, r1.qual = formatter.extract_seq_qual(r1.seq, r1.qual, "r1")
                if r2 is not None:
                    r2.seq, r2.qual = formatter.extract_seq_qual(r2.seq, r2.qual, "r2")
            if has_barcode:
                src = rb if rb is not None else r1
                if formatter is not None and formatter.is_in_comment("bc"):
                    barcode = formatter.extract_from_comment(src.comment, "bc")
                elif formatter is not None and formatter.segment_count("bc"):
                    barcode, _ = formatter.extract_seq_qual(src.seq, src.qual, "bc")
                else:
                    barcode = src.seq
                ok = 0
                if corrector is not None:
                    barcode, ok = corrector.correct(barcode, src.qual)
                if ok < 0:
                    barcode = "N"
                elif translator is not None:
                    barcode = translator.translate(barcode)
            if has_umi:
                src = ru if ru is not None else r1
                if formatter is not None and formatter.is_in_comment("um"):
                    umi = formatter.extract_from_comment(src.comment, "um")
                elif formatter is not None and formatter.segment_count("um"):
                    umi, _ = formatter.extract_seq_qual(src.seq, src.qual, "um")
                else:
                    umi = src.seq
            yield r1, r2, barcode, umi

    # default TSV columns: packed device results straight to TSV lines
    fast_tsv = (hasattr(classifier, "query_pipelined_packed")
                and not has_barcode and not has_umi and not args.expand_taxid
                and not args.un_prefix and not args.cl_prefix
                and not sample_outputs)
    bulk_fastq = (fast_tsv and not has_mate and not args.sample_sheet
                  and formatter is None and merger is None
                  and _all_plain_fastq(reads.file_names))
    if bulk_fastq:
        _serve_bulk(classifier, reads.file_names, batch_size, mine, writer, rank_counts)
    else:
        # a reader thread parses the next batch while the device classifies
        # the current one (role of the reference's input thread)
        batch_q = queue.Queue(maxsize=2)

        def producer():
            batch = []
            i = 0
            for unit in formatted_units():
                batch.append(unit)
                if len(batch) >= batch_size:
                    if mine(i):
                        batch_q.put(batch)
                    batch, i = [], i + 1
            if batch and mine(i):
                batch_q.put(batch)
            batch_q.put(None)

        def batches():
            for b in iter(batch_q.get, None):
                pending.append(b)
                yield b
        pending = deque()   # batches in flight, each paired with its result
        t = threading.Thread(target=producer, daemon=True)
        t.start()
        if fast_tsv:
            for packed, fb, queries in classifier.query_pipelined_packed(
                    _batch_queries(b, merger) for b in batches()):
                batch = pending.popleft()
                lines, ncls = classifier.format_tsv_batch(
                    packed, fb, queries, [u[0].id for u in batch])
                _write_lines(writer, lines, len(batch), ncls, rank_counts)
        elif hasattr(classifier, "query_pipelined"):
            for results in classifier.query_pipelined(
                    _batch_queries(b, merger) for b in batches()):
                r0 = writer.rows_out
                _write_batch(pending.popleft(), results, writer)
                rank_counts.append(writer.rows_out - r0)
        else:
            for batch in batches():
                r0 = writer.rows_out
                _write_batch(pending.popleft(),
                             classifier.query_batch(_batch_queries(batch, merger)), writer)
                rank_counts.append(writer.rows_out - r0)
        t.join()

    if args.rank_index:
        with open(args.rank_index, "w") as f:
            f.write("".join("%d\n" % c for c in rank_counts))
    writer.finalize()
    if hasattr(classifier, "stats"):
        log(_units_line(classifier.stats) + _parse_share(spans.totals()))
    if args.trace_out:
        spans.write_chrome_trace(args.trace_out)
        spans.enable(False)
    log("Centrifuger(torch) finishes.")
    return 0


def _units_line(st):
    """The device units, then the batches and each engine stage's seconds
    per unit (a read or pair) in microseconds: the serving thread's
    engine.*, the finish workers' finish.* (classify/engine.py STAGES)."""
    from ..classify.engine import STAGES
    fallback = st.get("fallback_units", 0) + st.get("slow_units", 0)
    line = "Device units: %d fast, %d fallback to the exact host path" % (
        st["fast_units"], fallback)
    units = st["fast_units"] + fallback
    stages = [name for name in STAGES if name + "_s" in st]
    if units and stages:
        line += " in %d batches; us a read: %s" % (st["batches"], ", ".join(
            "%s %.2f" % (name, st[name + "_s"] / units * 1e6) for name in stages))
    return line


def _parse_share(totals):
    """The share of ReadFiles' reads that its native pass gave, against its
    line parser's (the counters of io/readers.py); "" where it gave none."""
    native = totals.get("io.native_reads", (0.0, 0))[1]
    lines = totals.get("io.line_reads", (0.0, 0))[1]
    if not native + lines:
        return ""
    return "; reads parsed natively: %.1f%% (%d of %d)" % (
        100.0 * native / (native + lines), native, native + lines)


def _serve_bulk(classifier, paths, batch_size, mine, writer, rank_counts):
    """The bulk single-end FASTQ route: a producer thread parses (and, on a
    nucleotide index, 2-bit packs in one native pass) batch_size reads at a
    time, file by file; the serving thread dispatches and writes.  Batch i
    counts over all files, as the JAX CLI's stripe does; only this rank's
    batches are queued."""
    prepacked = not classifier.protein
    bq = queue.Queue(maxsize=4)

    def producer():
        try:
            i = 0
            for path in paths:
                it = classifier.iter_prepacked(path, batch_size) if prepacked \
                    else iter_fastq_batches(path, batch_size)
                for item in it:
                    if mine(i):
                        bq.put(item)
                    i += 1
            bq.put(None)
        except Exception as e:     # a failed native build, an unreadable file
            bq.put(e)

    def items():
        for item in iter(bq.get, None):
            if isinstance(item, Exception):
                raise item
            yield item

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    if prepacked:
        for lines, ncls, nq in classifier.serve_tsv_prepacked(items()):
            _write_lines(writer, lines, nq, ncls, rank_counts)
    else:
        ids = deque()   # read-id lists of the batches in flight

        def batches():
            for rids, queries in items():
                ids.append(rids)
                yield queries
        for packed, fb, queries in classifier.query_pipelined_packed(batches()):
            lines, ncls = classifier.format_tsv_batch(packed, fb, queries, ids.popleft())
            _write_lines(writer, lines, len(queries), ncls, rank_counts)
    t.join()


def _write_lines(writer, lines, n_reads, ncls, rank_counts):
    if lines:
        writer.fp.write("\n".join(lines) + "\n")
    writer.total_cnt += n_reads
    writer.classified_cnt += ncls
    rank_counts.append(len(lines))


def _all_plain_fastq(paths):
    """True when every input is a regular FASTQ file (plain or gzip) the bulk
    parser can take (first byte '@'; stdin excluded)."""
    for p in paths:
        if p == "-" or not os.path.isfile(p):
            return False
        try:
            with (gzip.open if p.endswith(".gz") else open)(p, "rb") as f:
                if f.read(1) != b"@":
                    return False
        except OSError:
            return False
    return True


def _batch_queries(batch, merger=None):
    """Engine queries (raw r1, raw r2 or None) of a batch of units whose
    first two items are the ReadFiles reads r1, r2; with a merger, a pair
    that overlaps becomes one read."""
    queries = []
    for r1, r2, *_ in batch:
        raw1 = np.frombuffer(r1.seq.encode(), dtype=np.uint8)
        raw2 = np.frombuffer(r2.seq.encode(), dtype=np.uint8) if r2 is not None else None
        if merger is not None and raw2 is not None:
            merged, _, ok = merger.merge(r1.seq, r1.qual, r2.seq, r2.qual)
            if ok:
                raw1 = np.frombuffer(merged.encode(), dtype=np.uint8)
                raw2 = None
        queries.append((raw1, raw2))
    return queries


def _write_batch(batch, results, writer):
    for (r1, r2, barcode, umi), res in zip(batch, results):
        writer.output(r1.id, r1.seq, r1.qual,
                      r2.seq if r2 is not None else None,
                      r2.qual if r2 is not None else None,
                      barcode, umi, res)


if __name__ == "__main__":
    sys.exit(main())
