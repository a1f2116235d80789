"""The control of the correctness check: the plain reference put in the
program's place with its scores held in float16, the step below the int32
scores the configurations state.  It must come out as not correct.

  python3 -m cfr_bench.control --workload CELL --seeds 1,2,3 [--reads N]

For each seed the control writes a window's TSV of N reads, as the
program would: the control's rows for the reads a run of the cell would
check (check_reads of them, the longest in it), and a placeholder row for
each read the check does not sample.  That TSV goes through the run's own
check (check.check: the TSV parse, the sample, the comparison with the
exact reference) and its verdict.  The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from . import check, spec, store
from .gen.db import Database
from .gen.reads import ReadGen


def write_tsv(path, n, rows):
    """A window's TSV of reads 0..n-1: `rows` {read number: its rows}, a
    placeholder row for every other read."""
    with open(path, "w") as f:
        for i in range(n):
            got = rows.get(i)
            f.write("\n".join(got) + "\n" if got else
                    "r%010d\tunclassified\t0\t0\t0\t0\t0\t1\n" % i)


def readings(cell, seeds, n_reads, device, log=lambda m: None):
    """{seed: (the check's numbers {name: (value, limit)}, correct)} of the
    control in the program's place."""
    db_dir = store.database(cell, log)
    db = Database.load(db_dir)
    ref_dir = store.reference_dir(cell)
    ref = check.reference(cell, db_dir, ref_dir, device)
    ctl = check.reference(cell, db_dir, ref_dir, device, score_dtype=np.float16)
    out = {}
    with tempfile.TemporaryDirectory(prefix="cfr_bench_control_") as tmp:
        for seed in seeds:
            gen = ReadGen(db, cell.traffic, seed)
            picks = check.sample(gen, seed, n_reads, int(cell.traffic["check_reads"]))
            reads = gen.reads(picks)
            got = ctl.rows([reads[i] for i in picks])
            tsv = os.path.join(tmp, "window.tsv")
            write_tsv(tsv, n_reads, {i: got[reads[i][0]] for i in picks})
            numbers, _ = check.check(cell, db, db_dir, ref_dir, seed, tsv, n_reads, device,
                                     ref=ref)
            out[seed] = (numbers, check.verdict(numbers))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cfr_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--reads", type=int, default=0,
                    help="reads a window writes (default 50 x check_reads)")
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    n = args.reads or 50 * int(cell.traffic["check_reads"])
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    res = readings(cell, [int(s) for s in args.seeds.split(",")], n, device,
                   lambda m: sys.stderr.write(m + "\n"))
    for seed, (numbers, correct) in res.items():
        sys.stderr.write("control seed %d: %s; correct %s\n" % (
            seed, ", ".join("%s %d limit %d" % (k, v, lim) for k, (v, lim) in numbers.items()),
            correct))
    print(json.dumps({"workload": args.workload, "reads": n,
                      "correct": {str(k): c for k, (_, c) in res.items()},
                      "checks": {str(k): {name: {"value": v, "limit": lim}
                                          for name, (v, lim) in nums.items()}
                                 for k, (nums, _) in res.items()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
