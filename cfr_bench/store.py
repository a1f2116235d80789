"""A configuration's database and the port's index of it, made once a
checkout and kept under cfr_bench/_cache/<config>-<digest>/ (git-ignored):

  db/    the sequences (codes.npy, layout.npz) the read generator and the
         reference share, and the FASTA and dumps the builder reads
  idx/   the index that the port's cfr-build-torch writes with the
         configuration's build flags, and the wide-row file that the port's
         first load of it writes beside it
  ref/   the plain reference's own index (reference/index.py build_state)

The digest covers the configuration's file, so an edited configuration
never finds a stale database.  Each part is made in a .tmp directory and
renamed into place when whole, so a cut run leaves nothing half made.
Each is made in a child process, so that a checkout's first run reads the
same host memory as the runs after it.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from .spec import ROOT


def cache_dir(cell):
    blob = json.dumps(cell.config, sort_keys=True).encode()
    return os.path.join(cell.bench_dir, "_cache", "%s-%s" % (
        cell.entry["config"], hashlib.sha1(blob).hexdigest()[:12]))


def _make(final, fill):
    if os.path.isdir(final):
        return final
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    fill(tmp)
    os.replace(tmp, final)
    return final


def _child(code, args, log_path):
    """Run `code` in a fresh interpreter from the checkout's root."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(log_path, "w") as f:
        rc = subprocess.run([sys.executable, "-c", code] + list(args), cwd=ROOT, env=env,
                            stdout=f, stderr=subprocess.STDOUT,
                            stdin=subprocess.DEVNULL).returncode
    if rc != 0:
        with open(log_path) as f:
            raise RuntimeError("%s exited with %d:\n%s" % (args[:1], rc, f.read()[-2000:]))


_MAKE_DB = """
import json, sys
from cfr_bench.gen.db import Database
cfg = json.load(open(sys.argv[1]))
db = Database.make(cfg, cfg["db_seed"])
db.save(sys.argv[2])
db.write_inputs(sys.argv[2])
"""

# the port's first load of an index writes its wide-row file; a CPU
# classifier does it without the card
_FIRST_LOAD = """
import json, sys
from centrifuger_tpu_torch.build import is_protein_index, load_index
from centrifuger_tpu_torch.classify.params import ClassifierParam
from centrifuger_tpu_torch.cli.classify_cli import make_classifier
serve = json.loads(sys.argv[2])
fm, tax, _, _ = load_index(sys.argv[1])
make_classifier(fm, tax, ClassifierParam(), is_protein_index(sys.argv[1]), serve["engine"],
                device="cpu", serve_layout=serve["serve_layout"])
"""


def database(cell, log):
    def fill(d):
        log("making the %s database from db_seed %d" % (cell.entry["config"],
                                                         cell.config["db_seed"]))
        cfg = os.path.join(cell.bench_dir, "configs", cell.entry["config"] + ".json")
        _child(_MAKE_DB, [cfg, d], os.path.join(d, "make.log"))
    return _make(os.path.join(cache_dir(cell), "db"), fill)


def index(cell, db_dir, log):
    """The port's index prefix, built by cfr-build-torch where missing."""
    def fill(d):
        prefix = os.path.join(d, "db")
        args = ["-r", os.path.join(db_dir, "ref.fa"),
                "--taxonomy-tree", os.path.join(db_dir, "nodes.dmp"),
                "--name-table", os.path.join(db_dir, "names.dmp"),
                "--conversion-table", os.path.join(db_dir, "ref_seqid.map"),
                "-o", prefix] + list(cell.config["build_flags"])
        log("building the index: cfr-build-torch " + " ".join(args))
        _child("import sys; from centrifuger_tpu_torch.cli.build_cli import main; "
               "sys.exit(main(sys.argv[1:]))", args, os.path.join(d, "build.log"))
        log("index built; the port's first load writes its wide-row file")
        _child(_FIRST_LOAD, [prefix, json.dumps(cell.config["serve"])],
               os.path.join(d, "first_load.log"))
        log("index ready")
    return os.path.join(_make(os.path.join(cache_dir(cell), "idx"), fill), "db")


def reference_dir(cell):
    return os.path.join(cache_dir(cell), "ref")
