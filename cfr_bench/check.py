"""Whether the window's TSV is correct.

Two numbers, each with the limit 0:

  order_faults   reads the generator wrote that the TSV does not hold, in
                 order, once each (rows of read r0..r{N-1} in turn): a read
                 dropped, repeated or moved counts
  rows_differ    reads of a sample, drawn from the seed among the reads the
                 window wrote (the longest of them in it), whose TSV
                 rows differ from the plain reference's rows for the same
                 read, made again from the seed

The reference (cfr_bench/reference/) works its index out from the
configuration's FASTA and takes nothing the port made.
"""

import numpy as np

from .gen.reads import ReadGen
from .reference.classify import RefClassifier
from .reference.index import build_state
from .reference.taxonomy import Taxonomy


class Tsv:
    """The window's TSV: each line's read number (-1 where the line does
    not start with r<10 digits><tab>), in file order."""

    def __init__(self, path):
        with open(path, "rb") as f:
            self.data = f.read()
        buf = np.frombuffer(self.data, np.uint8)
        ends = np.flatnonzero(buf == 10)
        self.starts = np.concatenate([[0], ends[:-1] + 1]) if len(ends) else ends
        self.ends = ends
        ok = (self.ends - self.starts > 11) & (buf[np.minimum(self.starts, len(buf) - 1)] == ord("r"))
        ok[ok] &= buf[self.starts[ok] + 11] == 9
        num = np.zeros(len(self.starts), np.int64)
        for d in range(1, 11):
            digit = buf[np.minimum(self.starts + d, len(buf) - 1)].astype(np.int64) - 48
            ok &= (digit >= 0) & (digit <= 9)
            num = num * 10 + digit
        self.read_no = np.where(ok, num, -1)

    def reads(self):
        """The read numbers in file order, a read's consecutive rows once."""
        r = self.read_no
        return r[np.concatenate([[True], r[1:] != r[:-1]])] if len(r) else r

    def rows(self, numbers):
        """{read number: its rows} of the numbers asked for."""
        order = np.argsort(self.read_no, kind="stable")
        srt = self.read_no[order]
        out = {}
        for i in numbers:
            lo, hi = np.searchsorted(srt, i), np.searchsorted(srt, i, side="right")
            out[i] = [self.data[self.starts[k]:self.ends[k]].decode() for k in order[lo:hi]]
        return out


def order_faults(reads, n_written):
    """Reads written and not held once each, in order, by the TSV."""
    m = min(len(reads), n_written)
    return abs(len(reads) - n_written) + int((reads[:m] != np.arange(m)).sum())


def sample(gen, seed, n, size):
    """Read indices to check, drawn from the seed: `size` reads of four
    times as many whole blocks among the n reads written (a block's reads
    are independent draws), and the longest read of the n."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFFFFFFFFFF, 0x636865636b]))
    if not n:
        return []
    B = gen.block_reads
    nb = -(-n // B)
    blocks = rng.choice(nb, min(nb, -(-4 * size // B)), replace=False)
    pool = np.concatenate([np.arange(b * B, min((b + 1) * B, n)) for b in blocks])
    picked = set(rng.choice(pool, min(size, len(pool)), replace=False).tolist())
    if "read_len" not in gen.t:          # reads of many lengths: the longest too
        lens = np.concatenate([gen.block_lengths(b) for b in range(nb)])[:n]
        picked.add(int(np.argmax(lens)))
    return sorted(picked)


def reference(cell, db_dir, ref_dir, device, score_dtype=None):
    cfg = cell.config
    tax = Taxonomy(db_dir + "/nodes.dmp", db_dir + "/names.dmp", db_dir + "/ref_seqid.map")
    ix = build_state(db_dir + "/ref.fa", tax, cfg["kind"] == "protein", cfg["ftab_width"],
                     cfg["sa_sample_rate"], ref_dir, device)
    s = cfg["serve"]
    return RefClassifier(ix, tax, k=s["k"], hitk_factor=s["hitk_factor"],
                         min_hit_len=s["min_hitlen"], score_dtype=score_dtype)


def check(cell, db, db_dir, ref_dir, seed, tsv_path, n_written, device, ref=None):
    """{name: (value, limit)} and the number of reads sampled; `ref` is the
    exact reference where the caller has one made."""
    tsv = Tsv(tsv_path)
    reads = tsv.reads()
    faults = order_faults(reads, n_written)
    gen = ReadGen(db, cell.traffic, seed)
    picks = sample(gen, seed, min(len(reads), n_written), int(cell.traffic["check_reads"]))
    made = gen.reads(picks)
    if ref is None:
        ref = reference(cell, db_dir, ref_dir, device)
    want = ref.rows([made[i] for i in picks])
    got = tsv.rows(picks)
    differ = sum(got[i] != want[made[i][0]] for i in picks)
    return {"order_faults": (faults, 0), "rows_differ": (differ, 0)}, len(picks)


def verdict(numbers):
    """`correct`: every number at or under its limit."""
    return all(v <= lim for v, lim in numbers.values())
