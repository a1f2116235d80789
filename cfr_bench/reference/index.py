"""The plain reference's own index: a suffix array of the configuration's
sequences and a textbook FM index over it.

Nothing here is read from the port's index.  The text is made from the
genome FASTA as Centrifuger's builder makes it (Builder.hpp:86-265: the
sequence-id map decides each sequence's id, a repeated id is skipped,
letters outside the alphabet are dropped, a protein carries an end marker,
a sequence shorter than the ftab width + 1 is left out), the suffix array
by prefix doubling in plain PyTorch (on the card where there is one), and
every search is a backward search over the BWT with occurrence counts at
every 32nd row.  A row's sequence id is what Centrifuger's sampled suffix
array gives it (FMIndex.hpp:203-231, 513-524; Builder.hpp:27-71): the value
of the stored row with the largest text position at or below the row's,
where the stored rows are every sample_rate-th row, the genome-boundary
rows (nucleotide) or the end-marker rows (protein), and the row of text
position 0.
"""

import json
import os

import numpy as np
import torch

DNA = "ACGT"
PROTEIN = "$ARNDCEQGHILKMFPSTWYV"
CP = 32                      # rows between occurrence checkpoints
STATE = ("sa", "C", "cp", "bwt_pad", "s_pos", "s_val")   # what a search and row_seq_id read


def encode_table(alphabet):
    t = np.full(256, 255, np.uint8)
    for i, c in enumerate(alphabet):
        t[ord(c)] = i
    return t


def read_fasta(path):
    """[(name up to the first blank, sequence bytes)] of a FASTA file."""
    out, name, parts = [], None, []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, b"".join(parts)))
                words = line[1:].split(None, 1)
                name, parts = (words[0].decode() if words else ""), []
            elif name is not None:
                parts.append(line.strip())
    if name is not None:
        out.append((name, b"".join(parts)))
    return out


def sequence_text(fasta, tax, protein, pw):
    """(codes, genome lengths, genome sequence ids) as the builder lays the
    text out."""
    enc = encode_table(PROTEIN if protein else DNA)
    chunks, lens, sids, seen = [], [], [], set()
    for name, seq in read_fasta(fasta):
        sid = tax.seq_id.get(name, len(tax.seq_names))
        if sid in seen:
            continue
        if sid >= tax.seq_cnt:
            sid = tax.add_seq_name(name)
        c = enc[np.frombuffer(seq, np.uint8)]
        c = c[c != 255]
        if protein:
            c = np.concatenate([c, [0]]).astype(np.uint8)
        if len(c) < pw + 1:
            continue
        seen.add(sid)
        chunks.append(c)
        lens.append(len(c))
        sids.append(sid)
    return np.concatenate(chunks), np.asarray(lens, np.int64), np.asarray(sids, np.int64)


def suffix_array(codes, device):
    """Suffix array of codes by prefix doubling (a suffix sorts before every
    suffix it is a prefix of), as int32 numpy."""
    n = len(codes)
    rank = torch.from_numpy(np.asarray(codes, np.int64)).to(device)
    k = 1
    while True:
        nxt = torch.zeros_like(rank)
        if k < n:
            nxt[:n - k] = rank[k:] + 1
        key = rank * (n + 2) + nxt
        del nxt
        sk, sa = torch.sort(key)
        del key
        step = torch.ones_like(sk)
        step[0] = 0
        step[1:] = sk[1:] != sk[:-1]
        del sk
        new = torch.cumsum(step, 0)
        del step
        rank = torch.empty_like(new)
        rank[sa] = new
        if int(new[-1]) == n - 1 or k >= n:
            return sa.to(torch.int32).cpu().numpy()
        del new, sa
        k *= 2


class RefIndex:
    """The reference's text, suffix array and FM index, and the sequence id
    of every row (`row_seq_id`)."""

    def __init__(self, codes, sa, genome_lens, genome_sids, protein, pw, sample_rate):
        self.codes = np.asarray(codes, np.uint8)
        self.sa = sa
        self.n = n = len(codes)
        self.protein = protein
        self.alphabet = PROTEIN if protein else DNA
        self.sigma = len(self.alphabet)
        self.pw = pw
        self.encode = encode_table(self.alphabet)
        before = np.where(sa > 0, sa - 1, n - 1)
        self.bwt = self.codes[before]
        self.bwt[sa == 0] = 255              # the whole text has no preceding symbol
        counts = np.bincount(self.codes, minlength=self.sigma).astype(np.int64)
        last = int(self.codes[-1])
        # rows of the symbol-c suffixes start at C[c]; the last suffix, c
        # alone, sorts first among them and has no row in the BWT's counts
        self.C = np.concatenate([[0], np.cumsum(counts)[:-1]]) + \
            (np.arange(self.sigma) == last)
        pad = (-n) % CP
        blocks = np.concatenate([self.bwt, np.full(pad, 255, np.uint8)]).reshape(-1, CP)
        self.cp = np.zeros((len(blocks) + 1, self.sigma), np.int64)
        for c in range(self.sigma):
            np.cumsum((blocks == c).sum(1), out=self.cp[1:, c])
        self.bwt_pad = np.concatenate([self.bwt, np.full(CP, 255, np.uint8)])
        self._stored(genome_lens, genome_sids, sample_rate)

    @classmethod
    def load(cls, d, protein, pw):
        """The index saved in directory d, its arrays mapped from disk."""
        ix = cls.__new__(cls)
        for k in STATE:
            setattr(ix, k, np.load(os.path.join(d, k + ".npy"), mmap_mode="r"))
        ix.n = len(ix.sa)
        ix.protein = protein
        ix.alphabet = PROTEIN if protein else DNA
        ix.sigma = len(ix.alphabet)
        ix.pw = pw
        ix.encode = encode_table(ix.alphabet)
        return ix

    def save(self, d):
        for k in STATE:
            np.save(os.path.join(d, k + ".npy"), getattr(self, k))

    def _stored(self, lens, sids, rate):
        """The stored rows' text positions (sorted) and sequence ids."""
        n, pw, sa = self.n, self.pw, self.sa
        psum = np.concatenate([[0], np.cumsum(lens)])

        def owner(pos):
            return sids[np.minimum(np.searchsorted(psum, pos, side="right") - 1,
                                   len(sids) - 1)]
        pos = sa[::rate].astype(np.int64)
        if self.protein:
            val = owner(pos)
            rows_x = np.arange(int((self.codes == 0).sum()))   # the end-marker rows
            xpos = sa[rows_x].astype(np.int64)
            xval = owner(xpos + 1)
            first_val = 0
        else:
            val = owner(np.where(pos + pw + 1 < n, pos + pw + 1, pos))
            b = psum[1:-1]
            rows_x = np.flatnonzero(np.isin(sa, b[b >= pw + 1] - pw - 1))
            xpos = sa[rows_x].astype(np.int64)
            xval = owner(xpos + pw + 1)
            first_val = int(sids[0])
        keep = rows_x % rate != 0          # a sampled row keeps its sample's value
        xpos, xval = xpos[keep], xval[keep]
        allpos = np.concatenate([pos, xpos, [0]])
        allval = np.concatenate([val, xval, [first_val]])
        # text position 0 (the row of the whole text) takes first_val over all
        allval[allpos == 0] = first_val
        order = np.argsort(allpos, kind="stable")
        self.s_pos, self.s_val = allpos[order], allval[order]

    def row_seq_id(self, rows):
        pos = self.sa[np.asarray(rows, np.int64)]
        return self.s_val[np.searchsorted(self.s_pos, pos, side="right") - 1]

    def occ(self, c, p):
        """Rows r < p whose BWT symbol is c (vectors)."""
        base = (p // CP) * CP
        window = self.bwt_pad[base[:, None] + np.arange(CP)]
        inside = np.arange(CP) < (p - base)[:, None]
        return self.cp[p // CP, c] + ((window == c[:, None]) & inside).sum(1)

    def extend(self, c, sp, ep):
        """The row range of cP from P's [sp, ep] (empty: sp > ep)."""
        c = c.astype(np.int64)
        return self.C[c] + self.occ(c, sp), self.C[c] + self.occ(c, ep + 1) - 1

    def search(self, flat, start, ms):
        """Centrifuger's BackwardSearch (FMIndex.hpp:388-422, 487-510) of the
        first ms[i] codes of lane i (flat[start[i]:]), all lanes at once:
        (l, sp, ep), with (l, 1, 0) where nothing matched."""
        ms = np.asarray(ms, np.int64)
        start = np.asarray(start, np.int64)
        k = len(ms)
        l = np.zeros(k, np.int64)
        sp = np.zeros(k, np.int64)
        ep = np.full(k, self.n - 1, np.int64)
        live = ms >= self.pw
        empty = np.zeros(k, bool)
        sp[~live], ep[~live] = 1, 0
        s = 0
        while live.any():
            at_end = np.flatnonzero(live & (s >= ms))
            l[at_end] = ms[at_end]
            live[at_end] = False
            idx = np.flatnonzero(live)
            if not len(idx):
                break
            c = flat[start[idx] + ms[idx] - 1 - s]
            bad = c == 255
            stop = idx[bad]
            live[stop] = False
            if s < self.pw:
                l[stop], sp[stop], ep[stop] = s, 1, 0
                fresh = ~bad & ~empty[idx]
                go = idx[fresh]
                nsp, nep = self.extend(c[fresh], sp[go], ep[go])
                sp[go], ep[go] = nsp, nep
                empty[go[nsp > nep]] = True
                if s == self.pw - 1:
                    dead = idx[~bad & empty[idx]]
                    l[dead], sp[dead], ep[dead] = self.pw - 1, 1, 0
                    live[dead] = False
            else:
                l[stop] = s
                go = idx[~bad]
                nsp, nep = self.extend(c[~bad], sp[go], ep[go])
                ok = nsp <= nep
                l[go[~ok]] = s
                live[go[~ok]] = False
                sp[go[ok]], ep[go[ok]] = nsp[ok], nep[ok]
            s += 1
        return l, sp, ep


def build_state(fasta, tax, protein, pw, sample_rate, cache_dir, device):
    """RefIndex of a FASTA.  With a cache_dir, the index is saved there
    (state/: its arrays and the sequence names the map lacked, which join
    `tax` again on a load) so that only the first run sorts and builds."""
    state = os.path.join(cache_dir, "state") if cache_dir else None
    if state and os.path.isdir(state):
        with open(os.path.join(state, "added.json")) as f:
            for name in json.load(f):
                tax.add_seq_name(name)
        return RefIndex.load(state, protein, pw)
    known = len(tax.seq_names)
    codes, lens, sids = sequence_text(fasta, tax, protein, pw)
    ix = RefIndex(codes, suffix_array(codes, device), lens, sids, protein, pw, sample_rate)
    if state:
        tmp = state + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        ix.save(tmp)
        with open(os.path.join(tmp, "added.json"), "w") as f:
            json.dump(tax.seq_names[known:], f)
        os.replace(tmp, state)
    return ix
