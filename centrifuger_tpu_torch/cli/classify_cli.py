"""cfr-classify-torch: read classification CLI on the PyTorch/CUDA port.

Port of centrifuger_tpu.cli.classify_cli: the same flags (flag-compatible
with `centrifuger`, reference CentrifugerClass.cpp:20-64) plus --device.
The flags whose modules are not ported yet exit with an error that names the
ROADMAP item that brings them.  --shards N serves through a sharded index
(parallel/sharded.py): N shards round-robin over the CUDA devices, all on one
card where there is one.

  python -m centrifuger_tpu_torch.cli.classify_cli -x IDX -1 r1.fq -2 r2.fq
"""

import argparse
import os
import queue
import sys
import threading
import time

import numpy as np

from ..build import load_index, is_protein_index
from ..classify.params import ClassifierParam
from ..io.readers import ReadFiles
from ..io.writer import ResultWriter

# flag -> (is it set?, the ROADMAP item that ports it)
_NOT_PORTED = [
    ("--read-format", lambda a: a.read_format,
     "the read formatter (ROADMAP: CLI read-prep features)"),
    ("--barcode/--UMI/--barcode-whitelist/--barcode-translate",
     lambda a: a.barcode or a.umi or a.barcode_whitelist or a.barcode_translate,
     "barcode/UMI handling (ROADMAP: CLI read-prep features)"),
    ("--merge-readpair", lambda a: a.merge_readpair,
     "read-pair merging (ROADMAP: CLI read-prep features)"),
    ("--un/--cl", lambda a: a.un_prefix or a.cl_prefix,
     "read dumps (ROADMAP: CLI read-prep features)"),
    ("--sample-sheet", lambda a: a.sample_sheet,
     "sample sheets (ROADMAP: CLI read-prep features)"),
]


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
                         "load) or runblock (the 84-byte-row mega-table of the "
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
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index and kernels: cuda (the "
                         "default; raises without a card) or cpu (the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    for flag, is_set, item in _NOT_PORTED:
        if is_set(args):
            ap.error("%s is not ported yet to centrifuger_tpu_torch: it comes "
                     "with %s" % (flag, item))

    log("Centrifuger(torch) starts.")
    if not os.path.exists(args.index + ".fm.npz") and \
            os.path.exists(args.index + ".1.cfr"):
        ap.error("reference-built .cfr indexes are not ported yet to "
                 "centrifuger_tpu_torch (ROADMAP: interop); build with cfr-build-torch")
    protein = is_protein_index(args.index)
    if args.shards > 1 and not protein and args.engine != "numpy" and \
            args.serve_layout != "plain":
        ap.error("--shards needs the plain serving layout (its wide rank rows are "
                 "what is sharded): drop --serve-layout runblock")
    fm, tax, seq_length, meta = load_index(args.index)
    log("Finishes loading index.")

    param = ClassifierParam(max_result=args.max_result,
                            min_hit_len=args.min_hitlen,
                            max_result_per_hit_factor=args.hitk_factor,
                            output_expanded_result=args.expand_taxid)

    reads = ReadFiles()
    mate_reads = ReadFiles()
    has_mate = False
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

    classifier = make_classifier(fm, tax, param, protein, args.engine,
                                 device=args.device, no_rowmap=args.no_rowmap,
                                 serve_layout=args.serve_layout, shards=args.shards)
    if getattr(classifier, "dev", None) is not None and \
            classifier.dev.layout == "plain_sharded":
        log(classifier.dev.placement_text())
    log("Inferred --min-hitlen: %d" % classifier.param.min_hit_len)

    writer = ResultWriter()
    writer.output_expanded = args.expand_taxid
    writer.output_header()
    batch_size = args.batch_size or 1024 * max(args.threads, 8)
    if args.shards > 1:
        # as the JAX CLI, which shards the read lanes over the mesh axis too
        batch_size = -(-batch_size // args.shards) * args.shards

    def iter_units():
        it1 = iter(reads)
        if reads.interleaved:
            for r1 in it1:
                yield r1, next(it1, None)
            return
        it2 = iter(mate_reads) if has_mate else None
        for r1 in it1:
            yield r1, (next(it2) if it2 is not None else None)

    # a reader thread parses the next batch while the device classifies the
    # current one (role of the reference's input thread)
    batch_q = queue.Queue(maxsize=2)

    def producer():
        batch = []
        for unit in iter_units():
            batch.append(unit)
            if len(batch) >= batch_size:
                batch_q.put(batch)
                batch = []
        if batch:
            batch_q.put(batch)
        batch_q.put(None)

    def batches():
        while True:
            b = batch_q.get()
            if b is None:
                return
            yield b

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    if hasattr(classifier, "query_pipelined_packed") and not args.expand_taxid:
        # array-level path: packed device results -> TSV lines directly
        pending = []
        for packed, fb, queries in classifier.query_pipelined_packed(
                _batch_queries(b) for b in _tee_batches(pending, batches())):
            batch = pending.pop(0)
            lines, ncls = classifier.format_tsv_batch(
                packed, fb, queries, [r1.id for r1, _ in batch])
            if lines:
                writer.fp.write("\n".join(lines) + "\n")
            writer.total_cnt += len(batch)
            writer.classified_cnt += ncls
    else:
        for batch in batches():
            results = classifier.query_batch(_batch_queries(batch))
            for (r1, r2), res in zip(batch, results):
                writer.output(r1.id, r1.seq, r1.qual,
                              r2.seq if r2 is not None else None,
                              r2.qual if r2 is not None else None,
                              None, None, res)
    t.join()
    writer.finalize()
    if hasattr(classifier, "stats"):
        st = classifier.stats
        log("Device units: %d fast, %d fallback to the exact host path"
            % (st["fast_units"], st.get("fallback_units", 0) + st.get("slow_units", 0)))
    log("Centrifuger(torch) finishes.")
    return 0


def _tee_batches(pending, it):
    """Yield batches while appending them to `pending`, so each finished
    result can be paired with its source batch (FIFO)."""
    for b in it:
        pending.append(b)
        yield b


def _batch_queries(batch):
    return [(np.frombuffer(r1.seq.encode(), dtype=np.uint8),
             np.frombuffer(r2.seq.encode(), dtype=np.uint8) if r2 is not None else None)
            for r1, r2 in batch]


if __name__ == "__main__":
    sys.exit(main())
