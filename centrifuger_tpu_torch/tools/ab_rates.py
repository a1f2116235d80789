"""The main path's rates of several checkouts of the repo on one card.

Makes chip_smoke.py's main database (a seeded synthetic nucleotide DB, 64 Mnt
by default, indexed with the port's builder) and its 65,536 read pairs once,
then, for each checkout in the order given (for example parent, change,
change, parent), in a process of its own that imports only that checkout:
builds its kernels, classifies the reads through its CLI (pairs/s, index load
included), then their read 1 single-end through its CLI (reads/s: the bulk
FASTQ route where the checkout has one), and runs its chip_smoke.engine_rates
(the steady-state engine rate, device busy time and idle share of one
profiled pass) on the same index.  The TSVs' digests show that every checkout
gave the same output.  The card's name and power limit are printed first.

  python3 centrifuger_tpu_torch/tools/ab_rates.py TREE [TREE ...] [--db-nt N]
      [--seed S] [--out DIR]

Each TREE is a checkout holding chip_smoke.py and centrifuger_tpu_torch/.  The
data is made under this checkout's .smoke_work/ and removed at the end.
"""

import argparse
import hashlib
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def child(tree, work, out, label):
    """One checkout's CLI run and engine rates on the shared index."""
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from centrifuger_tpu_torch import kernels
    cs.OUT = out
    kernels.build_all()
    prefix, reads = os.path.join(work, "main", "db"), os.path.join(work, "main")
    with open(os.devnull, "w") as log:
        for paired, unit in ((True, "read pairs"), (False, "single-end reads")):
            t0 = time.time()
            tsv, _ = cs.classify(prefix, reads, ["--batch-size", str(cs.BATCH_PAIRS)], log,
                                 paired)
            wall = time.time() - t0
            cs.say("%s: %d %s in %.2f s through the CLI (index load included): %.0f "
                   "%s/s; TSV sha1 %s"
                   % (label, cs.N_PAIRS, unit, wall, cs.N_PAIRS / wall, unit,
                      hashlib.sha1(tsv.encode()).hexdigest()[:16]))
    eng = cs.make_engine(prefix)
    cs.engine_rates(label, eng, cs.read_batches(reads), cs.N_PAIRS,
                    "profile_%s.txt" % label.replace(" ", "_"))
    eng._finish_pool().shutdown()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--db-nt", type=int, default=64_000_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    ap.add_argument("--child", nargs=2, metavar=("WORK", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.out = os.path.abspath(args.out)
    if args.child:
        return child(os.path.abspath(args.trees[0]), args.child[0], args.out, args.child[1])

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    work = os.path.join(REPO, ".smoke_work", "ab_rates")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(args.out, exist_ok=True)
    cs.WORK, cs.OUT = work, args.out
    try:
        cs.say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip())
        t0 = time.time()
        cs.make_database("main", args.db_nt, args.seed)
        cs.say("main database of %d nt and its reads made and indexed in %.1f s"
               % (args.db_nt, time.time() - t0))
        for i, tree in enumerate(map(os.path.abspath, args.trees)):
            label = "run %d %s" % (i + 1, os.path.basename(tree))
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), tree,
                                 "--out", args.out, "--child", work, label],
                                cwd=tree).returncode
            if rc:
                cs.fail("%s exited with %d" % (label, rc))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
