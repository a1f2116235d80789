# Port copy of centrifuger_tpu.cli.merge_cli (host code, no accelerator).
"""cfr-merge-shards-torch: interleave per-rank TSV shards back into the
global read order (multi-host serving).

Each rank r of a `cfr-classify-torch --n-ranks P --rank r` run processes read
batches r, r+P, r+2P, ... (SURVEY 2.6-P2 input sharding over the reference's
single-process 3-stage pipeline, CentrifugerClass.cpp:555-564) and records
its TSV rows-per-batch in the `--rank-index` sidecar.  This tool round-robins
the shard files batch-by-batch so the merged TSV is byte-identical to a
single-process run (tested in tests/test_torch_cli_features.py).
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="cfr-merge-shards-torch",
        description="Merge per-rank classification TSV shards in global "
                    "read order.")
    ap.add_argument("-o", dest="out", required=True, help="merged TSV path")
    ap.add_argument("--shard", nargs=2, action="append", required=True,
                    metavar=("TSV", "IDX"),
                    help="a rank's shard TSV and its --rank-index sidecar; "
                         "repeat in rank order")
    args = ap.parse_args(argv)

    shards = []
    for tsv, idx in args.shard:
        with open(idx) as f:
            counts = [int(x) for x in f.read().split()]
        shards.append((open(tsv), counts))
    try:
        with open(args.out, "w") as out:
            out.write(shards[0][0].readline())   # header lives in rank 0
            k = 0
            while True:
                hit = False
                for f, counts in shards:
                    if k < len(counts):
                        hit = True
                        for _ in range(counts[k]):
                            out.write(f.readline())
                if not hit:
                    break
                k += 1
    finally:
        for f, _ in shards:
            f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
