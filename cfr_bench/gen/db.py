"""The configurations' databases, made from the seed their file fixes.

Copied from the port's GPU smoke test (make_genomes, make_taxonomy,
make_proteomes, write_fasta) and generalised over a recipe: the genome
count and length, the sister-strain divergence and the inverted repeats
(nucleotide), or the proteome size, the protein lengths and the conserved
share (protein).  Imports numpy only.

A database is the arrays the read generator and the plain reference share
(`codes`: the concatenated genomes or proteins, `starts`: where each
sequence begins, `taxa`: the genome each belongs to) and the FASTA, the
taxonomy dumps and the sequence-id map that the port's builder reads.
"""

import os

import numpy as np

AA_LETTERS = "ARNDCEQGHILKMFPSTWYV"   # amino-acid codes 1..20 in `codes`


def make_taxonomy(n_genomes):
    """root(1) - phylum(10) - genus(100 + i//2) - species(1000 + i) -
    strain(10000 + i): sister strains share a genus."""
    nodes = {1: (1, "no rank"), 10: (1, "phylum")}
    names = {1: "root", 10: "Testphylum"}
    seq_taxids = []
    for i in range(n_genomes):
        genus, species, strain = 100 + i // 2, 1000 + i, 10000 + i
        if genus not in nodes:
            nodes[genus] = (10, "genus")
            names[genus] = "Genus_%d" % genus
        nodes[species] = (genus, "species")
        names[species] = "Species_%d" % species
        nodes[strain] = (species, "strain")
        names[strain] = "Strain_%d" % strain
        seq_taxids.append(strain)
    return nodes, names, seq_taxids


def make_genomes(recipe, seed):
    """recipe["genomes"] code arrays (0..3) of recipe["genome_nt"] bases;
    every odd genome is a point mutant (share recipe["sister_divergence"])
    of the one before, and each new genome carries inverted repeats
    (recipe["inverted_repeat"]-base segments copied reverse-complemented),
    one per recipe["repeat_every"] bases, so that some reads hit both
    strands."""
    rng = np.random.default_rng(seed)
    glen = int(recipe["genome_nt"])
    ir = int(recipe["inverted_repeat"])
    genomes, prev = [], None
    for i in range(int(recipe["genomes"])):
        if i % 2 == 1:
            g = prev.copy()
            pos = rng.integers(0, glen, int(recipe["sister_divergence"] * glen))
            g[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        else:
            g = rng.integers(0, 4, glen, dtype=np.uint8)
            for _ in range(max(1, glen // int(recipe["repeat_every"]))):
                a, b = rng.integers(0, glen - ir, 2)
                g[b:b + ir] = 3 - g[a:a + ir][::-1]
            prev = g
        genomes.append(g)
    return genomes


def make_proteomes(recipe, seed):
    """recipe["genomes"] proteomes as lists of amino-acid code arrays (1..20),
    proteins of recipe["protein_len"] = [lo, hi) residues, about
    recipe["proteome_aa"] residues each.  Every odd proteome is a point
    mutant of the one before; the first recipe["conserved_share"] of every
    even proteome's proteins are those of proteome 0 (conserved proteins)."""
    rng = np.random.default_rng(seed)
    per = int(recipe["proteome_aa"])
    lo, hi = recipe["protein_len"]
    lens = []
    while sum(lens) < per:
        lens.append(int(rng.integers(lo, hi)))
    cuts = np.cumsum(lens)[:-1]
    shared = cuts[max(1, int(len(lens) * recipe["conserved_share"])) - 1]
    proteomes, prev = [], None
    for i in range(int(recipe["genomes"])):
        if i % 2 == 1:
            flat = prev.copy()
            pos = rng.integers(0, len(flat), int(recipe["sister_divergence"] * len(flat)))
            flat[pos] = rng.integers(1, 21, len(pos), dtype=np.uint8)
        else:
            flat = rng.integers(1, 21, sum(lens), dtype=np.uint8)
            if proteomes:
                flat[:shared] = np.concatenate(proteomes[0])[:shared]
            prev = flat
        proteomes.append(np.split(flat, cuts))
    return proteomes


class Database:
    """A configuration's database in memory: the concatenated sequences
    (`codes`, uint8), the start of each and one past the last (`starts`),
    the genome index of each (`taxa`), their names, and the alphabet of
    `codes` ("ACGT" for codes 0..3, or AA_LETTERS for codes 1..20)."""

    def __init__(self, codes, starts, taxa, names, protein):
        self.codes = codes
        self.starts = starts
        self.taxa = taxa
        self.names = names
        self.protein = protein
        self.n_genomes = int(taxa.max()) + 1 if len(taxa) else 0

    @classmethod
    def make(cls, recipe, seed):
        if recipe["kind"] == "protein":
            proteomes = make_proteomes(recipe, seed)
            seqs = [p for ps in proteomes for p in ps]
            names = ["T%02d_P%05d" % (t, j) for t, ps in enumerate(proteomes)
                     for j in range(len(ps))]
            taxa = [t for t, ps in enumerate(proteomes) for _ in ps]
            protein = True
        else:
            seqs = make_genomes(recipe, seed)
            names = ["SEQ_%06d" % i for i in range(len(seqs))]
            taxa = list(range(len(seqs)))
            protein = False
        starts = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=starts[1:])
        return cls(np.concatenate(seqs), starts, np.asarray(taxa, np.int64), names,
                   protein)

    def save(self, d):
        np.save(os.path.join(d, "codes.npy"), self.codes)
        np.savez(os.path.join(d, "layout.npz"), starts=self.starts, taxa=self.taxa,
                 names=np.array(self.names), protein=self.protein)

    @classmethod
    def load(cls, d):
        z = np.load(os.path.join(d, "layout.npz"))
        return cls(np.load(os.path.join(d, "codes.npy"), mmap_mode="r"), z["starts"],
                   z["taxa"], z["names"].tolist(), bool(z["protein"]))

    def sequence(self, i):
        return self.codes[self.starts[i]:self.starts[i + 1]]

    def write_inputs(self, d):
        """ref.fa, nodes.dmp, names.dmp and ref_seqid.map, as the builder
        takes them."""
        letters = AA_LETTERS if self.protein else "ACGT"
        shift = 1 if self.protein else 0
        write_fasta(os.path.join(d, "ref.fa"), self.names,
                    (self.sequence(i) - shift for i in range(len(self.names))), letters)
        nodes, names, taxids = make_taxonomy(self.n_genomes)
        with open(os.path.join(d, "ref_seqid.map"), "w") as f:
            f.writelines("%s\t%d\n" % (s, taxids[t]) for s, t in zip(self.names, self.taxa))
        with open(os.path.join(d, "nodes.dmp"), "w") as f:
            f.writelines("%d\t|\t%d\t|\t%s\t|\n" % (t, *nodes[t]) for t in sorted(nodes))
        with open(os.path.join(d, "names.dmp"), "w") as f:
            f.writelines("%d\t|\t%s\t|\t\t|\tscientific name\t|\n" % (t, names[t])
                         for t in sorted(names))


def write_fasta(path, names, seqs, letters):
    """FASTA of 70-column lines; `seqs` yields code arrays indexing `letters`."""
    table = np.frombuffer(letters.encode(), np.uint8)
    with open(path, "wb") as f:
        for name, g in zip(names, seqs):
            f.write(b">%s\n" % name.encode())
            s = table[g]
            pad = (-len(s)) % 70
            rows = np.concatenate([s, np.zeros(pad, np.uint8)]).reshape(-1, 70)
            out = np.concatenate([rows, np.full((len(rows), 1), 10, np.uint8)], 1)
            out = out.reshape(-1)
            f.write(out[out != 0].tobytes())
