"""cfr-download-torch (centrifuger_tpu_torch/cli/download_cli.py) against
cfr-download on a mirror the test writes: the module-level `fetch` of both
CLIs copies from the mirror, and urllib.request.urlopen raises if anything
calls it, so no test opens a URL.  Each case runs the JAX CLI and then the
port's in the same directory; the return code, stdout, stderr, the URLs
fetched and every file written must be equal."""

import contextlib
import gzip
import io
import os
import shutil
import tarfile
import urllib.parse
import urllib.request

import pytest

from centrifuger_tpu.cli import download_cli as jdl
from centrifuger_tpu_torch.cli import download_cli as pdl

NCBI = "https://ftp.ncbi.nlm.nih.gov"
ACGT = "ACGT"


def fasta_gz(path, records, seed):
    """A gzipped FASTA of `records` (header, length) with seeded bases."""
    import numpy as np
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        for head, n in records:
            seq = "".join(ACGT[c] for c in rng.integers(0, 4, n))
            f.write(">%s\n%s\n" % (head, "\n".join(seq[i:i + 60] for i in range(0, n, 60))))


def summary_row(acc, name, category, taxid, status, level, ftp, extra_col=None):
    cols = ["%s" % acc, "PRJNA1", "SAMN1", "na", category, str(taxid), str(taxid), name,
            "strain=%s" % name, "", status, level, "Full", "Major", "2020/01/01", name,
            "Lab", "GCA_%s" % acc[4:], "identical", ftp]
    if extra_col is not None:
        cols.append(extra_col)
    return "\t".join(cols) + "\n"


# (accession, category, taxid, status, level, path form): path form "https",
# "ftp" (an ftp:// path the CLI rewrites), "col20" (column 19 is "na" and
# column 20 holds the path), "na" (no path: skipped)
GENOMES = [
    ("GCF_000001.1", "reference genome", 562, "latest", "Complete Genome", "https"),
    ("GCF_000002.1", "representative genome", 1280, "latest", "Complete Genome", "ftp"),
    ("GCF_000003.2", "na", 562, "latest", "Chromosome", "https"),
    ("GCF_000004.1", "reference genome", 1280, "latest", "Scaffold", "col20"),
    ("GCF_000005.1", "na", 287, "replaced", "Complete Genome", "https"),
    ("GCF_000006.1", "representative genome", 287, "latest", "Complete Genome", "na"),
    ("GCF_000007.1", "na", 1773, "latest", "Complete Genome", "https"),
]


def genome_path(acc):
    name = "%s_Strain%s" % (acc, acc[4:10])
    return "genomes/all/GCF/%s/%s/%s" % (acc[4:7], acc[7:10], name), name


def write_summary(mirror, rel, genomes, with_short_row=True):
    path = os.path.join(mirror, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("#   See ftp://ftp.ncbi.nlm.nih.gov/genomes/README_assembly_summary.txt\n")
        f.write("# assembly_accession\tbioproject\t...\n")
        for acc, cat, taxid, status, level, form in genomes:
            rel_dir, name = genome_path(acc)
            url = "%s/%s" % (NCBI, rel_dir)
            ftp = {"https": url, "ftp": url.replace("https://", "ftp://"),
                   "col20": "na", "na": "na"}[form]
            f.write(summary_row(acc, name, cat, taxid, status, level, ftp,
                                url + "/" if form == "col20" else None))
        if with_short_row:
            f.write("GCF_999999.1\tPRJNA1\tshort row\n")
    return path


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    m = str(tmp_path_factory.mktemp("mirror"))
    for k, (acc, *_rest) in enumerate(GENOMES):
        rel_dir, name = genome_path(acc)
        recs = [("NZ_CP%06d.1 %s chromosome" % (k, name), 700 + 37 * k)]
        recs += [("NZ_CP%06d.1 %s plasmid p%d" % (k, name, j), 90 + j) for j in range(k % 3)]
        fasta_gz(os.path.join(m, rel_dir, name + "_genomic.fna.gz"), recs, k)
        fasta_gz(os.path.join(m, rel_dir, name + "_rna_from_genomic.fna.gz"), recs[:1], 50 + k)
    write_summary(m, "genomes/refseq/bacteria/assembly_summary.txt", GENOMES)
    write_summary(m, "genomes/refseq/viral/assembly_summary.txt", GENOMES[:2],
                  with_short_row=False)
    write_summary(m, "genomes/genbank/archaea/assembly_summary.txt", GENOMES[2:4])
    write_summary(m, "custom_summary.txt", GENOMES[1:4])
    tax = os.path.join(m, "pub", "taxonomy")
    os.makedirs(tax)
    with tarfile.open(os.path.join(tax, "taxdump.tar.gz"), "w:gz") as t:
        for name, text in (("nodes.dmp", "1\t|\t1\t|\tno rank\t|\n562\t|\t1\t|\tspecies\t|\n"),
                           ("names.dmp", "1\t|\troot\t|\t\t|\tscientific name\t|\n"),
                           ("readme.txt", "not extracted\n")):
            data = text.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    os.makedirs(os.path.join(m, "pub", "UniVec"))
    with open(os.path.join(m, "pub", "UniVec", "UniVec"), "w") as f:
        f.write(">gnl|uv|A00001.1:1-20 vector one\nACGTACGTACGTACGTACGT\n"
                ">gnl|uv|A00002.1:5-30 vector two\nTTTTGGGGCCCCAAAA\n")
    emvec = os.path.join(m, "pub", "databases", "emvec")
    os.makedirs(emvec)
    with gzip.open(os.path.join(emvec, "emvec.dat.gz"), "wt") as f:
        f.write("ID   EMVEC1\nDE   cloning vector pUC|19 part\nSQ   Sequence 20 BP;\n"
                "     acgtacgtac gtacgtacgt        20\n//\n"
                "ID   EMVEC2\nDE   expression vector 2\nSQ   Sequence 10 BP;\n"
                "     ttttgggcca                   10\n//\n")
    files = os.path.join(m, "records", "10023239", "files")
    os.makedirs(files)
    for i in (1, 2, 3):
        with open(os.path.join(files, "cfr_hpv+gbsarscov2.%d.cfr" % i), "wb") as f:
            f.write(bytes(range(i, 200 + i)))
    return m


def mirror_fetch(m, log):
    """fetch(url, dest, retries) that copies url's path from the mirror."""
    def fetch(url, dest=None, retries=3):
        log.append((url, None if dest is None else os.path.basename(dest), retries))
        src = os.path.join(m, urllib.parse.urlparse(url).path.lstrip("/"))
        if not os.path.isfile(src):
            raise RuntimeError("Error downloading %s: %s" % (url, "HTTP Error 404"))
        if dest is None:
            with open(src, "rb") as f:
                return f.read()
        shutil.copyfile(src, dest)
        return dest
    return fetch


@pytest.fixture
def no_urlopen(monkeypatch):
    calls = []

    def urlopen(*a, **k):
        calls.append(a)
        raise OSError("urlopen called in a test")
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    yield calls
    assert not calls, calls


def snapshot(d):
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def run(module, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = module.main(argv)
        except SystemExit as e:
            rc = ("exit", e.code)
        except Exception as e:  # noqa: BLE001 - the two CLIs must fail alike
            rc = ("raised", type(e).__name__, str(e))
    return rc, out.getvalue(), err.getvalue()


def run_both(mirror, tmp_path, monkeypatch, argv, prepare=None, usage_error=False):
    """The JAX CLI, then the port's, in the same directory: (rc, stdout,
    stderr, fetch log, files) of the port's run, held equal to the JAX run's.
    After a usage error only the message is compared: the usage lines name
    each CLI's own prog."""
    work = str(tmp_path / "run")
    results = []
    for module in (jdl, pdl):
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        if prepare:
            prepare(work)
        log = []
        monkeypatch.setattr(module, "fetch", mirror_fetch(mirror, log))
        argv_w = [a.replace("{W}", work).replace("{M}", mirror) for a in argv]
        rc, out, err = run(module, argv_w)
        results.append([rc, out, err, log, snapshot(work)])
    if "-P" in argv and argv[argv.index("-P") + 1] != "1":
        for r in results:    # the pool's threads fetch in any order
            r[3].sort()
    if usage_error:
        for r in results:
            r[2:3] = [r[2].splitlines()[-1].split(": ", 1)[1]]
    for what, j, p in zip(("rc", "stdout", "stderr", "fetched", "files"), *results):
        assert p == j, what
    return results[1]


def seqids(out):
    return [line.split("\t") for line in out.splitlines()]


CASES = {
    "refseq": ["-o", "{W}/lib", "refseq"],
    "refseq_filters": ["-o", "{W}/lib", "-a", "Complete Genome,Chromosome", "-c",
                       "reference genome", "-t", "562,1280", "-d", "bacteria", "refseq"],
    "refseq_any_two_domains": ["-o", "{W}/lib", "-a", "Any", "-d", "bacteria,viral", "refseq"],
    "genbank_any": ["-o", "{W}/lib", "-a", "Any", "-d", "archaea", "genbank"],
    "refseq_file_map": ["-o", "{W}/lib", "-f", "-a", "Any", "refseq"],
    "refseq_rna_flag_kept": ["-o", "{W}/lib", "-r", "-l", "-u", "-v", "-g", "wget", "refseq"],
    "custom": ["-o", "{W}/lib", "-a", "Any", "{M}/custom_summary.txt"],
    "custom_missing": ["-o", "{W}/lib", "{W}/nowhere/assembly_summary.txt"],
    "no_genomes": ["-o", "{W}/lib", "-t", "999999", "refseq"],
    "protein_missing_from_mirror": ["-o", "{W}/lib", "-p", "-t", "1773", "refseq"],
    "taxonomy": ["-o", "{W}/tax", "taxonomy"],
    "contaminants": ["-o", "{W}/lib", "contaminants"],
    "contaminants_file_map": ["-o", "{W}/lib", "-f", "contaminants"],
    "prebuilt": ["-o", "{W}/idx", "cfr_hpv+gbsarscov2"],
    "prebuilt_unknown": ["-o", "{W}/idx", "cfr_x"],
    "no_database": ["-o", "{W}/lib"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_download_equals_jax(case, mirror, tmp_path, monkeypatch, no_urlopen):
    rc, out, err, log, files = run_both(mirror, tmp_path, monkeypatch, CASES[case],
                                        usage_error=case == "no_database")
    if case == "refseq":
        assert rc == 0
        # genome k carries k % 3 plasmids: 0, 1 and 6 pass the default filters
        assert [t for _, t in seqids(out)] == ["562", "1280", "1280", "1773"]
        assert all(name.endswith(("_genomic.fna.gz", "assembly_summary.txt")) for name in files)
    elif case == "refseq_filters":
        # only GCF_000001 is a reference genome at either level
        assert rc == 0 and [t for _, t in seqids(out)] == ["562"] and len(log) == 2
    elif case == "refseq_any_two_domains":
        assert rc == 0 and "lib/viral/assembly_summary.txt" in files
        assert any(url.startswith(NCBI + "/genomes/all/GCF/000/004/") for url, *_ in log)
    elif case == "refseq_file_map":
        assert all(path.startswith(str(tmp_path)) for path, _ in seqids(out))
    elif case in ("custom_missing", "no_genomes", "prebuilt_unknown"):
        assert rc == 1 and out == ""
    elif case == "custom":
        assert rc == 0 and "lib/assembly_summary.txt" in files
    elif case == "protein_missing_from_mirror":
        assert rc[0] == "raised" and "protein.faa.gz" in rc[2]
    elif case == "taxonomy":
        assert rc == 0 and sorted(files) == ["tax/names.dmp", "tax/nodes.dmp"]
    elif case.startswith("contaminants"):
        assert rc == 0
        assert files["lib/contaminants/EmVec.fna"] == (
            b">cloning_vector_pUC_19_part\nACGTACGTACGTACGTACGT\n"
            b">expression_vector_2\nTTTTGGGCCA\n")
        assert len(out.splitlines()) == (2 if case.endswith("map") else 4)
    elif case == "prebuilt":
        assert rc == 0 and len(files) == 3 and [d for _, d, _ in log] == [
            "cfr_hpv+gbsarscov2.%d.cfr" % i for i in (1, 2, 3)]
    elif case == "no_database":
        assert rc == ("exit", 2) and err == "error: the following arguments are required: database"


def test_existing_files_are_not_fetched_again(mirror, tmp_path, monkeypatch, no_urlopen):
    """A non-empty file already in place is kept; an empty one is fetched."""
    rel_dir, name = genome_path(GENOMES[0][0])
    _, name2 = genome_path(GENOMES[1][0])

    def prepare(work):
        d = os.path.join(work, "lib", "bacteria")
        os.makedirs(d)
        shutil.copyfile(os.path.join(mirror, rel_dir, name + "_genomic.fna.gz"),
                        os.path.join(d, name + "_genomic.fna.gz"))
        open(os.path.join(d, name2 + "_genomic.fna.gz"), "w").close()
    rc, _, _, log, _ = run_both(mirror, tmp_path, monkeypatch, CASES["refseq"], prepare)
    fetched = [d for _, d, _ in log]
    assert rc == 0 and name + "_genomic.fna.gz" not in fetched
    assert name2 + "_genomic.fna.gz" in fetched


def test_dustmasker(mirror, tmp_path, monkeypatch, no_urlopen):
    """-m runs gunzip, the named binary and gzip; a stub dustmasker copies its
    input."""
    stub = tmp_path / "dustmasker"
    stub.write_text('#!/bin/sh\n[ "$1 $2 $3 $5 $6 $7 $8" = "-infmt fasta -in -level 20 '
                    '-outfmt fasta" ] || exit 3\ncat "$4"\n')
    stub.chmod(0o755)
    rc, out, _, _, files = run_both(mirror, tmp_path, monkeypatch,
                                    ["-o", "{W}/lib", "-m", str(stub), "-f", "refseq"])
    assert rc == 0
    masked = sorted(f for f in files if f.endswith("_dustmasked.fna.gz"))
    assert len(masked) == 3 and all(p.endswith("_dustmasked.fna.gz") for p, _ in seqids(out))
    for f in masked:
        plain = gzip.decompress(files[f.replace("_dustmasked.fna.gz", ".fna.gz")])
        assert gzip.decompress(files[f]) == plain
    assert not [f for f in files if f.endswith(".fna")]


@pytest.mark.parametrize("args", [["-a", "Any", "-d", "bacteria,viral"], ["-f", "-a", "Any"]])
def test_threads(args, mirror, tmp_path, monkeypatch, no_urlopen):
    """-P 4 prints in task order: its output equals -P 1's."""
    one = run_both(mirror, tmp_path, monkeypatch, ["-o", "{W}/lib", "-P", "1"] + args +
                   ["refseq"])
    four = run_both(mirror, tmp_path, monkeypatch, ["-o", "{W}/lib", "-P", "4"] + args +
                    ["refseq"])
    assert one[0] == four[0] == 0
    assert one[1] == four[1] and one[2] == four[2] and one[4] == four[4]
    assert sorted(one[3]) == sorted(four[3])


class FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@pytest.mark.parametrize("fail_first", [0, 2, 3])
def test_fetch(fail_first, tmp_path, monkeypatch):
    """The real fetch with urlopen replaced: fail_first failures, then the
    data; three failures use up the retries and raise."""
    data = bytes(range(256)) * 9000
    results = []
    for module in (jdl, pdl):
        calls = []

        def urlopen(url):
            calls.append(url)
            if len(calls) <= fail_first:
                raise OSError("attempt %d refused" % len(calls))
            return FakeResponse(data)
        monkeypatch.setattr(urllib.request, "urlopen", urlopen)
        dest = str(tmp_path / ("%s.bin" % module.__name__))
        try:
            got = (module.fetch("https://example.org/a.bin", dest),
                   module.fetch("https://example.org/a.bin", None, retries=5))
            with open(dest, "rb") as f:
                assert f.read() == data
            got = (os.path.basename(got[0]).split(".", 1)[1], got[1] == data)
        except RuntimeError as e:
            got = ("raised", str(e))
        results.append((got, calls))
    assert results[0] == results[1]
    assert results[1][0][0] == ("raised" if fail_first >= 3 else "cli.download_cli.bin")
