"""One run of one cell: set-up, the measured window, the check, the result.

  python3 cfr_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up: the configuration's database and the port's index of it (made and
built once a checkout, cfr_bench/_cache/), the CLI module's own load_index
and make_classifier with the configuration's serve flags, the read
generator's processes (feed.py; on two cores of their own where there are
four or more, the program on the rest), and one warm-up batch at the
cell's shapes through the same route.  The window: the CLI's serving loop (serve.py) over the
generator's FIFOs, closed loop, until --seconds have passed and the
batches in flight have drained.  Then the memory readings, the program's
state freed, the check against the plain reference (check.py), and one
JSON line on standard output.  With --trace 1 the window runs under
torch.profiler and the line carries the per-layer metrics instead.

--device cpu runs the port's plain PyTorch versions on the CPU, for the
tests: no device metric is printed.
"""

import argparse
import gc
import json
import multiprocessing
import os
import resource
import shutil
import sys
import tempfile
import threading
import time
import types

from . import check, feed, serve, spec, store
from .gen.db import Database
from .gen.reads import ReadGen

FORBIDDEN = ("jax", "jaxlib", "flax", "centrifuger_tpu")
pc = time.perf_counter
T_IMPORT = pc()


def log(msg):
    sys.stderr.write("[cfr_bench %.1fs] %s\n" % (pc() - T_IMPORT, msg))
    sys.stderr.flush()


def log_rss(stage):
    log("peak RSS after %s: %.2f GiB" % (
        stage, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20))


def route_of(cell):
    """The CLI's rule: single-end plain FASTQ with the default columns takes
    the bulk route; the generator's FIFOs stand for plain FASTQ files."""
    return "object" if cell.traffic["pairing"] == "paired" else "bulk"


def parse(argv):
    ap = argparse.ArgumentParser(prog="cfr_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def card_check(cell, device):
    import torch
    if device == "cpu":
        return None
    if not torch.cuda.is_available():
        raise SystemExit("cfr_bench: torch.cuda.is_available() is false: no card, no result")
    if torch.cuda.device_count() < cell.chips:
        raise SystemExit("cfr_bench: %d CUDA devices, the cell needs %d"
                         % (torch.cuda.device_count(), cell.chips))
    return torch.cuda.get_device_name(0)


def warm_file(db, cell, seed, tmp, batch_size):
    """One batch of reads no window sees (stream 1), as FASTQ files."""
    gen = ReadGen(db, cell.traffic, seed, stream=1)
    paths = [os.path.join(tmp, "warm_%d.fq" % m) for m in (1, 2)][:2 if gen.paired else 1]
    blocks = [gen.block(b) for b in range(-(-batch_size // gen.block_reads))]
    for m, p in enumerate(paths):
        with open(p, "wb") as f:
            for blk in blocks:
                f.write(blk.fastq(m + 1))
    return paths


def run_route(route, classifier, paths, batch_size, out, spans, failed):
    from centrifuger_tpu_torch.io.readers import ReadFiles
    if route == "bulk":
        serve.serve_bulk(classifier, paths, batch_size, out, spans, failed)
        return
    rf = ReadFiles()
    rf.add_read_file(paths[0])
    mf = None
    if len(paths) > 1:
        mf = ReadFiles()
        mf.add_read_file(paths[1])
    serve.serve_object(classifier, rf, mf, batch_size, out, spans, failed)


def split_cores():
    """(the program's cores, the generator's): the generator gets the last
    two where there are four or more, the program the rest, so that
    neither takes time from the other; else both share all."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return cores, cores
    return cores[:-2], cores[-2:]


def main(argv=None, t0=None, root=spec.ROOT):
    """One run; `root` is the checkout whose BENCHMARK.json and cfr_bench/
    data files name the cell (the tests give one of their own)."""
    t0 = pc() if t0 is None else t0
    args = parse(argv)
    cell = spec.Cell(args.workload, root)
    all_cores = sorted(os.sched_getaffinity(0))
    own_cores, gen_cores = split_cores()
    os.sched_setaffinity(0, own_cores)
    try:
        return _main(args, cell, t0, gen_cores)
    finally:
        os.sched_setaffinity(0, all_cores)


def _main(args, cell, t0, gen_cores):
    kind = card_check(cell, args.device)
    import torch
    from centrifuger_tpu_torch import kernels
    from centrifuger_tpu_torch.build import is_protein_index, load_index
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    from centrifuger_tpu_torch.cli.classify_cli import make_classifier

    cfg, traffic = cell.config, cell.traffic
    batch_size = int(traffic["batch_size"])
    route = route_of(cell)
    db_dir = store.database(cell, log)
    db = Database.load(db_dir)
    tmp = tempfile.mkdtemp(prefix="cfr_bench_")
    ctx = multiprocessing.get_context("spawn")
    stop, paths_q = ctx.Event(), ctx.Queue()
    report_r, report_w = ctx.Pipe(duplex=False)
    fifos = []
    if route == "object":
        fifos = [os.path.join(tmp, "r%d.fq" % (m + 1))
                 for m in range(2 if traffic["pairing"] == "paired" else 1)]
        for p in fifos:
            os.mkfifo(p)
    if route == "object":
        procs = [ctx.Process(target=feed.main, daemon=True,
                             args=(db_dir, traffic, args.seed, tmp, stop, report_w, gen_cores))]
    else:
        nproc = max(1, min(len(gen_cores), 4))
        procs = [ctx.Process(target=feed.bulk, daemon=True,
                             args=(db_dir, traffic, args.seed, tmp, batch_size, stop, paths_q,
                                   k, nproc, gen_cores)) for k in range(nproc)]
    for proc in procs:
        proc.start()
    chunks = feed.Chunks(paths_q, procs)
    try:
        prefix = store.index(cell, db_dir, log)
        log_rss("imports and the card")
        fm, tax, _, _ = load_index(prefix)
        s = cfg["serve"]
        param = ClassifierParam(max_result=s["k"], min_hit_len=s["min_hitlen"],
                                max_result_per_hit_factor=s["hitk_factor"])
        classifier = make_classifier(fm, tax, param, is_protein_index(prefix), s["engine"],
                                     device=args.device, no_rowmap=s["no_rowmap"],
                                     serve_layout=s["serve_layout"])
        del fm
        log_rss("index and classifier")
        failed = []
        with open(os.devnull, "w") as null:
            run_route(route, classifier, warm_file(db, cell, args.seed, tmp, batch_size),
                      batch_size, serve.TsvOut(null), serve.Spans(False), failed)
        if failed:
            raise failed[0]
        if args.device != "cpu":
            torch.cuda.synchronize()
        log_rss("warm-up batch")
        stats0 = dict(getattr(classifier, "stats", {}))
        launches0 = dict(kernels.LAUNCHES)
        spans = serve.Spans(bool(args.trace))
        tsv_path = os.path.join(tmp, "window.tsv")
        device_trace = None
        if args.trace and args.device != "cpu":
            from .trace import DeviceTrace
            device_trace = DeviceTrace()
        inputs = fifos if route == "object" else spans.feed(chunks)
        with open(tsv_path, "w", buffering=1 << 20) as fp:
            out = serve.TsvOut(fp)
            if device_trace is not None:
                device_trace.mark()
            w0 = pc()
            setup_s = w0 - t0
            log("set-up %.1f s; the window starts" % setup_s)
            at_stop = []

            def deadline():
                stop.set()
                at_stop.append(out.reads)
            timer = threading.Timer(args.seconds, deadline)
            timer.daemon = True
            timer.start()
            run_route(route, classifier, inputs, batch_size, out, spans, failed)
            timer.cancel()
            if args.device != "cpu":
                torch.cuda.synchronize()
            w1 = pc()
        if device_trace is not None:
            device_trace.stop()
        stop.set()
        if failed:
            raise failed[0]
        if route == "object":
            rep = report_r.recv() if report_r.poll(60) else None
        else:
            rep = chunks.report() if len(chunks.reports) == len(procs) else None
        for proc in procs:
            proc.join(30)
        if rep is None:
            raise RuntimeError("the read generator sent no report")
        rec = types.SimpleNamespace(
            cell=cell, route=route, window_s=w1 - w0, reads=out.reads, setup_s=setup_s,
            spans=spans, stats0=stats0, stats1=dict(getattr(classifier, "stats", {})),
            host_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
            device_mem_gib=None, memory_peak=0, busy_s=None, kernel_s=None,
            feed_wait_s=rep["fifo_s"])
        device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
        if args.device != "cpu":
            rec.memory_peak = torch.cuda.max_memory_allocated()
            rec.device_mem_gib = rec.memory_peak / 2 ** 30
            device = {"platform": "gpu", "kind": kind, "count": cell.chips,
                      "memory_peak_bytes": rec.memory_peak}
        breakdown = None
        if device_trace is not None:
            launched = {k: v - launches0.get(k, 0) for k, v in kernels.LAUNCHES.items()
                        if v - launches0.get(k, 0)}
            busy, kern, ops, gaps = device_trace.reduce(w0, w1, launched, spans.serving)
            rec.busy_s, rec.kernel_s = busy, kern
            device.update(busy_s=busy, window_s=w1 - w0)
            breakdown = {"device_ops": [[n, v] for n, v in ops],
                         "idle_gaps": [[n, v] for n, v in gaps]}
            del device_trace
        rate = out.reads / rec.window_s
        log("generator: %d reads written, made at %.0f reads/s of its own time (%.1fx the "
            "window's %.0f reads/s); ahead of the program by %d reads at the deadline"
            % (rep["reads"], rep["reads"] / max(rep["made_s"], 1e-9),
               rep["reads"] / max(rep["made_s"], 1e-9) / max(rate, 1e-9), rate,
               rep["reads"] - (at_stop[0] if at_stop else out.reads)))
        log("generator on cores %s, pipes of %d bytes: a writer had nothing made for %.3f s "
            "of the window; the reader waited %.3f s for the next file; its reads of the "
            "chunk files took at most %.3f s of waiting on the generator"
            % (",".join(map(str, gen_cores)), rep["pipe_bytes"], rep["starved_s"],
               spans.feed_s, rep["fifo_s"]))
        log("window %.2f s for --seconds %g; peak RSS %.2f GiB" % (
            rec.window_s, args.seconds, rec.host_rss_gib))
        # the program's state goes before the reference runs
        del classifier
        gc.collect()
        if args.device != "cpu":
            torch.cuda.empty_cache()
        t_check = pc()
        numbers, sampled = check.check(cell, db, db_dir, store.reference_dir(cell), args.seed,
                                       tsv_path, rep["reads"], args.device)
        log("check: %.1f s" % (pc() - t_check))
    finally:
        stop.set()
        for proc in procs:
            proc.join(10)
            if proc.is_alive():
                proc.terminate()
                proc.join()
        shutil.rmtree(tmp, ignore_errors=True)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        log("the run's process holds %s: no result" % ", ".join(found))
        return 3
    metrics = {}
    wanted = cell.per_layer() if args.trace else cell.end_to_end()
    for m in wanted:
        v = spec.metric_reader(m["name"], cell.bench_dir).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = check.verdict(numbers)
    log("checked %d sampled reads of %d written" % (sampled, out.reads))
    result = {"correct": correct, "attempted": rep["reads"],
              "failed": max(rep["reads"] - out.reads, 0), "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        sys.stderr.write("%s %d limit %d\n" % (k, v, lim))
    sys.stderr.flush()
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0

