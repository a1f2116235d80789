# Port copy of centrifuger_tpu.native (host code, no accelerator).
"""Native (C++) host components, loaded via ctypes with on-demand compilation.

  sais.cpp        linear-time SA-IS suffix sort (offline index build)
  sa_chunked.cpp  difference-cover chunked SA builder (the memory-bounded
                  build path, fm/sa_external.py)
  fastqpack.cpp   one-pass FASTQ parse + 2-bit pack (the bulk FASTQ producer,
                  io/fastq_fast.py), and the record splitter of the object
                  route's ReadFiles (io/readers.py)
  tsvquant.cpp    one-pass classification-TSV ingest (quant/quantifier.py)

Each shared library is written into a git-ignored build directory beside this
package (native/_build/), never next to the source.
"""

import ctypes
import os
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_LIBS = {}


def _build_lib(name):
    src = os.path.join(_HERE, name + ".cpp")
    out = os.path.join(_BUILD, "lib" + name + ".so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", "-o", tmp, src]
    sys.stderr.write("[native] compiling %s\n" % name)
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def load(name):
    """Load (compiling if needed) the named native library.  Raises when the
    host toolchain is missing: the port has no pure-Python fallback."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_build_lib(name))
        return _LIBS[name]
