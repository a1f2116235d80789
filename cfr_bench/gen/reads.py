"""Reads from a seed, block by block, for a traffic mix.

Rewritten from the port's GPU smoke test (write_pair, write_reads,
write_protein_reads, write_long_reads, codon_table) to make whole blocks in
a few numpy calls and to stream them.  Read i lies in block i // block_reads,
and a block is made from (seed, stream, block) alone, so any read can be
made again without the ones before it.  Imports numpy only.

A read is a fragment of the database (share composition["database"]), of a
diverged variant of it that the database does not hold (share
composition["variant"]: the fragment carries variant_divergence
substitutions), or random sequence (the rest).  Genomes are drawn by a
log-normal abundance profile fixed by the traffic's own seed, fragments are
reverse-complemented with probability revcomp_share, and each read carries
error_rate substitutions.  Paired reads are the fragment's two ends, as
Illumina sequences them; single-end reads are read 1 alone, or the whole
fragment where the mix has no read_len (long reads: every block holds the
same set of lengths, drawn once from the mix's length seed, in an order of
its own).  On a protein database
the fragments are back-translated from the proteins with a random codon of
each residue.
"""

import numpy as np

from .db import AA_LETTERS

ACGT = np.frombuffer(b"ACGT", np.uint8)

# the standard genetic code, by codon
_CODE = dict(zip(
    [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"],
    "FFLLSSSSYY__CC_WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"))


def codon_table():
    """(codons [21, 6, 3] nucleotide codes, count [21]) of the standard code,
    by amino-acid code 1..20."""
    codons = np.zeros((21, 6, 3), np.uint8)
    count = np.zeros(21, np.int64)
    for codon, aa in sorted(_CODE.items()):
        if aa == "_":
            continue
        a = AA_LETTERS.index(aa) + 1
        codons[a, count[a]] = ["ACGT".index(c) for c in codon]
        count[a] += 1
    return codons, count


def _seed_words(seed):
    """SeedSequence entropy for any whole number, negative ones too."""
    seed = int(seed)
    return [seed & 0xFFFFFFFFFFFFFFFF, (seed >> 64) & 0xFFFFFFFF, 1 if seed < 0 else 0]


def _spans(starts, lengths):
    """(offsets [B + 1], index [total]): segment i of the result is
    starts[i], starts[i] + 1, ..., starts[i] + lengths[i] - 1."""
    offs = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offs[1:])
    return offs, np.arange(offs[-1]) + np.repeat(starts - offs[:-1], lengths)


def _substitute(rng, codes, rate, alphabet=4, base=0, among=None):
    """Replace each symbol of `codes` (a flat view) with probability `rate`
    by another of the alphabet, in place: a binomial count of positions,
    drawn uniformly (among the positions `among` where given)."""
    space = len(codes) if among is None else len(among)
    k = int(rng.binomial(space, rate)) if space else 0
    if not k:
        return
    pos = rng.integers(0, space, k)
    if among is not None:
        pos = among[pos]
    shift = rng.integers(1, alphabet, k, dtype=np.int64)
    codes[pos] = ((codes[pos].astype(np.int64) - base + shift) % alphabet + base).astype(np.uint8)


class Block:
    """Reads [first, first + n) of a stream: ids, and each mate as one flat
    ASCII array cut by its offsets (mate 2 is None for single-end mixes)."""

    def __init__(self, first, r1, offs1, r2, offs2, kinds):
        self.first = first
        self.r1, self.offs1 = r1, offs1
        self.r2, self.offs2 = r2, offs2
        self.kinds = kinds       # 0 database, 1 variant, 2 random

    @property
    def n(self):
        return len(self.offs1) - 1

    def read_id(self, j):
        return "r%010d" % (self.first + j)

    def mate(self, which, j):
        flat, offs = (self.r1, self.offs1) if which == 1 else (self.r2, self.offs2)
        return flat[offs[j]:offs[j + 1]]

    def fastq(self, which):
        """FASTQ bytes of one mate stream of the block."""
        flat, offs = (self.r1, self.offs1) if which == 1 else (self.r2, self.offs2)
        L = int(offs[1] - offs[0]) if self.n else 0
        if self.n and len(flat) == L * self.n:       # one length: a record a row
            rec = np.empty((self.n, 17 + 2 * L), np.uint8)
            rec[:, 0:2] = np.frombuffer(b"@r", np.uint8)
            num = self.first + np.arange(self.n, dtype=np.int64)
            for d in range(10):
                rec[:, 11 - d] = 48 + num // 10 ** d % 10
            rec[:, 12] = 10
            rec[:, 13:13 + L] = flat.reshape(self.n, L)
            rec[:, 13 + L:16 + L] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, 16 + L:16 + 2 * L] = ord("I")
            rec[:, -1] = 10
            return rec.tobytes()
        seq = flat.tobytes()
        quals = {}
        out = []
        for j in range(self.n):
            a, b = int(offs[j]), int(offs[j + 1])
            q = quals.get(b - a)
            if q is None:
                q = quals[b - a] = b"I" * (b - a)
            out.append(b"@r%010d\n%s\n+\n%s\n" % (self.first + j, seq[a:b], q))
        return b"".join(out)


class ReadGen:
    """The reads of one traffic mix over one database from one seed.
    stream 0 is the measured window's; other streams (the warm-up batch)
    share no read with it."""

    def __init__(self, db, traffic, seed, stream=0):
        self.db = db
        self.t = traffic
        self.seed = seed
        self.stream = stream
        self.block_reads = int(traffic["block_reads"])
        self.paired = traffic["pairing"] == "paired"
        ab = traffic["abundance"]
        w = np.random.default_rng(int(ab["seed"])).lognormal(
            ab["mu"], ab["sigma"], db.n_genomes)
        self.weights = w / w.sum()
        comp = traffic["composition"]
        self.cum_kind = np.cumsum([comp["database"], comp["variant"]])
        if "length" in traffic:
            # one set of read lengths, drawn once from the mix's own seed; each
            # block holds it in another order, so every seed does the same work
            ln = traffic["length"]
            fl = np.random.default_rng(int(ln["seed"])).lognormal(
                np.log(ln["median"]), ln["sigma"], self.block_reads)
            self.length_set = np.clip(np.rint(fl).astype(np.int64), int(ln["min"]),
                                      min(int(ln["max"]), int(np.diff(db.starts).min())))
        if db.protein:
            self.codons, self.ncodon = codon_table()
            self.first_prot = np.searchsorted(db.taxa, np.arange(db.n_genomes + 1))
            lens = np.diff(db.starts)
            self.max_frag = 3 * (int(lens.min()) - 2)
        else:
            self.max_frag = int(np.diff(db.starts).min())

    def _rng(self, b):
        return np.random.default_rng(np.random.SeedSequence(
            _seed_words(self.seed) + [self.stream, int(b)]))

    def _lengths(self, rng, n):
        """Fragment lengths: the first draw of a block's generator."""
        t = self.t
        if "fragment" in t:
            f = t["fragment"]
            fl = np.rint(rng.normal(f["mean"], f["sd"], n)).astype(np.int64)
            hi = min(2 * int(f["mean"]), self.max_frag)
            return np.clip(fl, int(t["read_len"]), hi)
        return rng.permutation(self.length_set)

    def block_lengths(self, b):
        """The lengths of block b's reads (read 1's, for a paired mix)."""
        fl = self._lengths(self._rng(b), self.block_reads)
        return np.minimum(fl, int(self.t["read_len"])) if "read_len" in self.t else fl

    def block(self, b):
        rng = self._rng(b)
        n = self.block_reads
        fl = self._lengths(rng, n)
        kinds = np.searchsorted(self.cum_kind, rng.random(n), side="right")
        genome = rng.choice(self.db.n_genomes, n, p=self.weights)
        flip = rng.random(n) < self.t["revcomp_share"]
        if "read_len" in self.t:
            m1, m2 = self._ends(rng, fl, kinds, genome, flip)
            L = m1.shape[1]
            offs1 = np.arange(n + 1, dtype=np.int64) * L
            m1 = m1.reshape(-1)
            m2 = m2.reshape(-1) if self.paired else None
        else:
            m1, m2 = self._whole(rng, fl, kinds, genome, flip), None
            offs1 = np.zeros(n + 1, np.int64)
            np.cumsum(fl, out=offs1[1:])
        err = self.t["error_rate"]
        _substitute(rng, m1, err)
        if m2 is not None:
            _substitute(rng, m2, err)
        return Block(b * n, ACGT[m1], offs1,
                     None if m2 is None else ACGT[m2], None if m2 is None else offs1,
                     kinds)

    def _fragments(self, rng, fl, kinds, genome):
        """The fragments, one flat array, forward strand, before any read
        error: (codes, offsets)."""
        db = self.db
        if db.protein:
            frag, offs = self._back_translate(rng, genome, fl, kinds)
        else:
            glen = db.starts[genome + 1] - db.starts[genome]
            start = db.starts[genome] + (rng.random(len(fl)) * (glen - fl + 1)).astype(np.int64)
            offs = np.zeros(len(fl) + 1, np.int64)
            np.cumsum(fl, out=offs[1:])
            frag = np.concatenate([db.codes[a:a + m] for a, m in zip(start, fl)])
            var = np.flatnonzero(kinds == 1)
            if len(var):
                _substitute(rng, frag, self.t["variant_divergence"],
                            among=_spans(offs[var], fl[var])[1])
        rnd = np.flatnonzero(kinds == 2)
        if len(rnd):
            frag[_spans(offs[rnd], fl[rnd])[1]] = rng.integers(0, 4, int(fl[rnd].sum()),
                                                                dtype=np.uint8)
        return frag, offs

    def _ends(self, rng, fl, kinds, genome, flip):
        """Illumina's two ends of each fragment, [n, read_len] each: read 1
        is the molecule's first bases, read 2 the reverse complement of its
        last; a reverse-complemented molecule swaps them.  On a nucleotide
        database only the two ends are gathered, and a variant's
        substitutions are placed in fragment coordinates, so that bases
        both reads cover agree."""
        L = int(self.t["read_len"])
        j = np.arange(L)
        if self.db.protein:
            frag, offs = self._fragments(rng, fl, kinds, genome)
            head = frag[offs[:-1, None] + j]
            tail = 3 - frag[(offs[1:] - 1)[:, None] - j]
        else:
            db = self.db
            glen = db.starts[genome + 1] - db.starts[genome]
            start = db.starts[genome] + (rng.random(len(fl)) * (glen - fl + 1)).astype(np.int64)
            rows = np.lib.stride_tricks.sliding_window_view(db.codes, L)   # row i: codes[i:i + L]
            var = np.flatnonzero(kinds == 1)
            k = int(rng.binomial(int(fl[var].sum()), self.t["variant_divergence"]))
            if k:
                ends = np.cumsum(fl[var])
                at = np.unique(rng.integers(0, ends[-1], k))
                shift = rng.integers(1, 4, len(at), dtype=np.int64)
                i = np.searchsorted(ends, at, side="right")
                r, p = var[i], at - (ends[i] - fl[var][i])
                new = ((db.codes[start[r] + p].astype(np.int64) + shift) % 4).astype(np.uint8)
            rnd = np.flatnonzero(kinds == 2)
            if len(rnd):
                roffs, _ = _spans(np.zeros(len(rnd), np.int64), fl[rnd])
                f = rng.integers(0, 4, int(roffs[-1]), dtype=np.uint8)
            if not self.paired:
                # read 1 alone: the one end each molecule is read from
                off = np.where(flip, fl - L, 0)
                m1 = np.array(rows[start + off])
                if k:
                    q = p - off[r]
                    ok = (q >= 0) & (q < L)
                    m1[r[ok], q[ok]] = new[ok]
                if len(rnd):
                    m1[rnd] = f[(roffs[:-1] + off[rnd])[:, None] + j]
                m1[flip] = 3 - m1[flip][:, ::-1]
                return m1, None
            head = np.array(rows[start])
            tail = 3 - np.array(rows[start + fl - L])[:, ::-1]
            if k:
                h = p < L
                head[r[h], p[h]] = new[h]
                t = p >= fl[r] - L
                tail[r[t], (fl[r] - 1 - p)[t]] = 3 - new[t]
            if len(rnd):
                head[rnd] = f[roffs[:-1, None] + j]
                tail[rnd] = 3 - f[(roffs[1:] - 1)[:, None] - j]
        head[flip], tail[flip] = tail[flip], head[flip].copy()
        return head, tail

    def _whole(self, rng, fl, kinds, genome, flip):
        """Whole fragments as single-end reads (long reads)."""
        frag, offs = self._fragments(rng, fl, kinds, genome)
        for r in np.flatnonzero(flip):
            a, b = offs[r], offs[r + 1]
            frag[a:b] = 3 - frag[a:b][::-1]
        return frag

    def _back_translate(self, rng, genome, fl, kinds):
        """Nucleotide fragments of fl bases from proteins of the drawn
        proteomes, a random synonymous codon a residue, a random frame:
        (codes, offsets)."""
        db = self.db
        n = len(fl)
        cnt = self.first_prot[genome + 1] - self.first_prot[genome]
        prot = self.first_prot[genome] + (rng.random(n) * cnt).astype(np.int64)
        plen = db.starts[prot + 1] - db.starts[prot]
        n_res = fl // 3 + 2
        a = db.starts[prot] + (rng.random(n) * (plen - n_res + 1)).astype(np.int64)
        roffs, idx = _spans(a, n_res)
        aa = np.asarray(db.codes[idx], np.uint8)
        var = np.flatnonzero(kinds == 1)
        if len(var):
            _substitute(rng, aa, self.t["variant_divergence"], alphabet=20, base=1,
                        among=_spans(roffs[var], n_res[var])[1])
        pick = (rng.random(len(aa)) * self.ncodon[aa]).astype(np.int64)
        nt = self.codons[aa, pick].reshape(-1)           # 3 codes a residue
        frame = rng.integers(0, 3, n)
        offs, idx = _spans(3 * roffs[:-1] + frame, fl)
        return nt[idx], offs

    def reads(self, indices):
        """{i: (read id, mate 1 ASCII, mate 2 ASCII or None)} of any reads,
        each block made once."""
        out = {}
        indices = np.asarray(sorted(set(int(i) for i in indices)), np.int64)
        for b in np.unique(indices // self.block_reads):
            blk = self.block(b)
            for i in indices[indices // self.block_reads == b]:
                j = int(i - blk.first)
                out[int(i)] = (blk.read_id(j), blk.mate(1, j),
                               blk.mate(2, j) if blk.r2 is not None else None)
        return out
