"""The chain (K1), resolve (K2), prefix (K5) and finalize (K3) kernels of
several checkouts on one card, on the plain, the run-block (K8) and the
generic (K7, K9) layouts.

Makes chip_smoke.py's main database (a seeded synthetic nucleotide DB, 64 Mnt
by default, indexed with the port's builder), its 65,536 read pairs and its
1,024 long reads, and its path A protein database (32 M amino acids by
default, 65,536 read pairs back-translated from it), once, the two in
processes of their own side by side; then runs each checkout in the order
given (for example parent, change, change, parent) in a process of its own
that imports only that checkout.  Each run builds its kernels, loads the
indexes on the card and times, by CUDA events around the wrapper call (host
enqueue included; chip_smoke.cuda_ms, median of 20, 3 for the long lanes)
and by device time (chip_smoke.device_ms, median of 5, 2 for the long lanes):

  chain            chain_search on the first batch (8,192 pairs: 32,768
                   strand lanes of 100 codes), as phase 6 of chip_smoke.py
  chain_i64        the same on the index loaded as an int64 index (K9)
  chain_long       chain_search_lanes on the long reads' strand lanes
                   (2,048 x 20,032 codes), as the non-fused engine hands them
  resolve          resolve_rows on the rows the finish stage hands it for the
                   first batch (the rowmap branch)
  index_select     torch.index_select of the rowmap at those rows
  resolve_lf       resolve_rows on the same rows with the rowmap off (the LF
                   walk)
  prefix           prefix_search on the lanes the finish stage hands it for
                   the first batch
  prefix_long      prefix_search on the long reads' boundary searches, the
                   lanes the non-fused engine hands it
  finalize         finalize_units on the first batch's chains (the rowmap
                   resolve)
  finalize_lf      the same with the rowmap off (the LF-walk resolve of
                   --no-rowmap)
  chain_runblock, prefix_runblock, resolve_lf_runblock, finalize_lf_runblock
                   chain, prefix, resolve_lf and finalize_lf on the main
                   index loaded with --serve-layout runblock (the mega-table)
  chain_generic_i64, prefix_generic_i64
                   chain and prefix on the main index loaded as an int64
                   index with --serve-layout runblock (served as generic)
  chain_protein    chain_search_lanes on the protein database's first batch
                   (8,192 pairs: 98,304 amino-acid lanes), as path A of
                   chip_smoke.py hands it

Then resolve and index_select call by call, 400 pairs in turns of order, by
events around each call (the medians, and how many pairs resolve was no
slower in), and the host's enqueue of each call alone (microseconds a call
over 1,000 calls).  Every run times with this checkout's chip_smoke.py.

Each run writes its numbers and a digest of the outputs to
OUT/ab_kernels_<n>.json; the digests must agree.  A table of every run
closes the output.

  python3 centrifuger_tpu_torch/tools/ab_kernels.py TREE [TREE ...] [--db-nt N]
      [--db-aa N] [--seed S] [--out DIR]

Each TREE is a checkout holding chip_smoke.py and centrifuger_tpu_torch/.  The
data is made under this checkout's .smoke_work/ and removed at the end.
"""

import argparse
import hashlib
import importlib.util
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MEASURES = ("chain", "chain_i64", "chain_long", "resolve", "index_select", "resolve_lf",
            "prefix", "prefix_long", "finalize", "finalize_lf", "chain_runblock",
            "prefix_runblock", "resolve_lf_runblock", "finalize_lf_runblock",
            "chain_generic_i64", "prefix_generic_i64", "chain_protein")
PAIRS = 400


def yardstick():
    """This checkout's chip_smoke.py, loaded under a name of its own: every
    run times with its cuda_ms and device_ms, whichever checkout it drives."""
    spec = importlib.util.spec_from_file_location("ab_yardstick",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def paired(resolve, select, pairs):
    """resolve against select, call by call: CUDA events around each call
    (host enqueue included), the two calls of a pair back to back in turns
    of order; and the host's enqueue alone, microseconds a call over 1,000
    calls with no synchronisation."""
    import numpy as np
    import torch
    ev = lambda: torch.cuda.Event(enable_timing=True)
    t = {"resolve": [], "index_select": []}
    fns = (("resolve", resolve), ("index_select", select))
    for i in range(pairs):
        for name, fn in fns if i % 2 == 0 else fns[::-1]:
            s, e = ev(), ev()
            s.record()
            fn()
            e.record()
            e.synchronize()
            t[name].append(s.elapsed_time(e))
    host = {}
    for name, fn in fns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    r, x = np.array(t["resolve"]), np.array(t["index_select"])
    return dict(pairs=pairs, resolve_median_ms=float(np.median(r)),
                index_select_median_ms=float(np.median(x)),
                resolve_no_slower=int((r <= x).sum()),
                host_us=dict(resolve=host["resolve"], index_select=host["index_select"]))


def child(tree, work, out, label):
    """One run's measurements on the shared index."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    yard = yardstick()
    from centrifuger_tpu_torch import kernels
    from centrifuger_tpu_torch.classify import device_engine as de
    from centrifuger_tpu_torch.classify import engine_unfused as engine_mod
    from centrifuger_tpu_torch.fm import device as fd
    cs.OUT = out
    kernels.build_all()
    prefix, reads = os.path.join(work, "main", "db"), os.path.join(work, "main")
    eng = cs.make_engine(prefix)
    fm = eng.dev
    fm64 = cs.make_engine(prefix, force_idtype="int64").dev
    bq = cs.read_batches(reads)
    (pack2, vmask), lengths, nr, L = eng._pack_reads(bq[0])
    packed = tuple(torch.from_numpy(x).cuda() for x in (pack2, vmask, lengths))
    mhl = eng.param.min_hit_len
    H = L // (mhl + 1) + 1
    finish = ["resolve_rows", "prefix_search"]
    with cs.spying(engine_mod, finish) as handed:
        for qs in bq:
            eng.finish_packed(eng._dispatch_fused(qs))
            if all(k in handed for k in finish):
                break
    rows, valid = handed["resolve_rows"]
    pcodes, pms = handed["prefix_search"]
    unfused = cs.make_engine(prefix, unfused=True, dev=fm)
    with cs.spying(engine_mod, ["chain_search_lanes", "prefix_search"]) as handed:
        unfused.query_batch(cs.read_batches(os.path.join(reads, "long"), paired=False)[0])
    codes, clen, lmhl, lH = handed["chain_search_lanes"]
    lcodes, lms = handed["prefix_search"]
    hits, nhits = de.chain_search(fm, *packed, mhl, H)
    me = eng.param.max_result * eng.param.max_result_per_hit_factor
    rb = cs.make_engine(prefix, "runblock").dev
    g64 = cs.make_engine(prefix, "runblock", force_idtype="int64").dev
    prot = cs.make_engine(os.path.join(work, "protein", "db"))
    acodes, alen, _, aL = prot._pack_reads_protein(
        cs.read_batches(os.path.join(work, "protein"))[0])
    acodes, alen = torch.from_numpy(acodes).cuda(), torch.from_numpy(alen).cuda()
    amhl = prot.param.min_hit_len
    aH = aL // (amhl + 1) + 1
    rowmap = fm.rowmap

    def fin(index):
        return lambda: de.finalize_units(index, hits, nhits, nr, mhl, me, eng.K_OUT)
    # name: (call, event reps, device reps, the index whose rowmap is off meanwhile)
    calls = dict(
        chain=(lambda: de.chain_search(fm, *packed, mhl, H), 20, 5, None),
        chain_i64=(lambda: de.chain_search(fm64, *packed, mhl, H), 20, 5, None),
        chain_long=(lambda: fd.chain_search_lanes(fm, codes, clen, lmhl, lH), 3, 2, None),
        resolve=(lambda: fd.resolve_rows(fm, rows, valid), 20, 5, None),
        index_select=(lambda: torch.index_select(rowmap, 0, rows), 20, 5, None),
        resolve_lf=(lambda: fd.resolve_rows(fm, rows, valid), 20, 5, fm),
        prefix=(lambda: fd.prefix_search(fm, pcodes, pms), 20, 5, None),
        prefix_long=(lambda: fd.prefix_search(fm, lcodes, lms), 20, 5, None),
        finalize=(fin(fm), 20, 5, None),
        finalize_lf=(fin(fm), 20, 5, fm),
        chain_runblock=(lambda: de.chain_search(rb, *packed, mhl, H), 20, 5, None),
        prefix_runblock=(lambda: fd.prefix_search(rb, pcodes, pms), 20, 5, None),
        resolve_lf_runblock=(lambda: fd.resolve_rows(rb, rows, valid), 20, 5, rb),
        finalize_lf_runblock=(fin(rb), 20, 5, rb),
        chain_generic_i64=(lambda: de.chain_search(g64, *packed, mhl, H), 20, 5, None),
        prefix_generic_i64=(lambda: fd.prefix_search(g64, pcodes, pms), 20, 5, None),
        chain_protein=(lambda: fd.chain_search_lanes(prot.dev, acodes, alen, amhl, aH), 20, 5,
                       None))
    digest = hashlib.sha1()
    res = dict(label=label, tree=tree, device=torch.cuda.get_device_name(0),
               shapes=dict(chain=list(packed[0].shape), chain_long=list(codes.shape),
                           resolve_rows=len(rows), prefix=list(pcodes.shape),
                           prefix_long=list(lcodes.shape), finalize=list(hits.shape),
                           chain_protein=list(acodes.shape)))
    for name in MEASURES:
        fn, reps, dev_reps, off = calls[name]
        saved = None if off is None else off.rowmap
        if off is not None:
            off.rowmap = None   # once, so that no call rebuilds the index's view
        try:
            outs = fn()
            for t in outs if isinstance(outs, tuple) else (outs,):
                digest.update(t.cpu().numpy().tobytes())
            res[name] = dict(event_ms=yard.cuda_ms(fn, reps),
                             device_ms=yard.device_ms(fn, dev_reps))
        finally:
            if off is not None:
                off.rowmap = saved
        cs.say("%s: %-20s event %.4f ms, device %.4f ms"
               % (label, name, res[name]["event_ms"], res[name]["device_ms"]))
    res["paired"] = pr = paired(calls["resolve"][0], calls["index_select"][0], PAIRS)
    cs.say("%s: paired events (%d): resolve median %.4f ms, index_select %.4f ms, resolve no "
           "slower in %d; host enqueue a call: resolve %.2f us, index_select %.2f us"
           % (label, PAIRS, pr["resolve_median_ms"], pr["index_select_median_ms"],
              pr["resolve_no_slower"], pr["host_us"]["resolve"], pr["host_us"]["index_select"]))
    res["digest"] = digest.hexdigest()[:16]
    cs.say("%s: outputs sha1 %s" % (label, res["digest"]))
    with open(os.path.join(out, "ab_kernels_%s.json" % label.split()[1]), "w") as f:
        json.dump(res, f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--db-nt", type=int, default=64_000_000)
    ap.add_argument("--db-aa", type=int, default=32_000_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    ap.add_argument("--child", nargs=2, metavar=("WORK", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.out = os.path.abspath(args.out)
    if args.child:
        return child(os.path.abspath(args.trees[0]), args.child[0], args.out, args.child[1])

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    work = os.path.join(REPO, ".smoke_work", "ab_kernels")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(args.out, exist_ok=True)
    cs.WORK, cs.OUT = work, args.out
    try:
        t0 = time.time()
        # forked, so that each process keeps this one's WORK and OUT
        fork = multiprocessing.get_context("fork")
        procs = [fork.Process(target=cs.make_database, args=(kind, size, args.seed))
                 for kind, size in (("main", args.db_nt), ("protein", args.db_aa))]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
            if p.exitcode:
                cs.fail("making a database failed (%s/build_*.txt)" % args.out)
        cs.say("main database of %d nt (its reads and long reads) and protein database of "
               "%d aa (its reads) made and indexed in %.1f s"
               % (args.db_nt, args.db_aa, time.time() - t0))
        results = []
        for i, tree in enumerate(map(os.path.abspath, args.trees)):
            label = "run %d %s" % (i + 1, os.path.basename(tree))
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), tree,
                                 "--out", args.out, "--child", work, label],
                                cwd=tree).returncode
            if rc:
                cs.fail("%s exited with %d" % (label, rc))
            with open(os.path.join(args.out, "ab_kernels_%d.json" % (i + 1))) as f:
                results.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if len({r["digest"] for r in results}) != 1:
        cs.fail("the runs' outputs differ: %s" % [r["digest"] for r in results])
    cs.say("%-20s %s" % ("ms event/device", "  ".join("%-21s" % r["label"] for r in results)))
    for name in MEASURES:
        cs.say("%-20s %s" % (name, "  ".join("%-21s" % (
            "%.4f / %.4f" % (r[name]["event_ms"], r[name]["device_ms"])) for r in results)))
    cs.say("%-20s %s" % ("resolve <= sel", "  ".join("%-21s" % (
        "%d / %d" % (r["paired"]["resolve_no_slower"], PAIRS)) for r in results)))
    cs.say("%-20s %s" % ("host us res/sel", "  ".join("%-21s" % (
        "%.2f / %.2f" % (r["paired"]["host_us"]["resolve"],
                         r["paired"]["host_us"]["index_select"])) for r in results)))
    cs.say("every run's outputs agree (sha1 %s); %s" % (results[0]["digest"],
                                                         results[0]["device"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
