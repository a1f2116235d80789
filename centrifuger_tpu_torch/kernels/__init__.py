"""Hand-written Hopper kernels: build, load and launch.

Each kernel is one CUDA C++ source in csrc/ with a plain C entry point
(`<name>_launch`) that takes device pointers and the stream, launches, and
returns cudaGetLastError().  The sources are compiled with nvcc for sm_90a
into kernels/_build/ (git-ignored) at first use, all in parallel, and
bound with ctypes.  Nothing here is imported or compiled when the package is
imported, and there is no fallback: a missing nvcc or a failed build raises.

LAUNCHES counts, per kernel, the launches its wrapper made; callers reset it
with reset_launches().
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

# C entry point arguments after the leading `const FMView*` and before the
# trailing stream: P = device pointer, i = int
SIGNATURES = {
    "chain_search": "PPPiiiiPP",    # pack2 vmask lengths U L mhl H hits nhits
    "resolve_rows": "PPiP",         # rows valid M out
    "finalize_units": "PPiiiiiiP",  # hits nhits Q nr H mhl me k_out packed
    "prefix_search": "PPiiP",       # codes ms B L out[3, B]
}
KERNELS = tuple(SIGNATURES)
_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
_COMMON = ("fm_device.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = dict.fromkeys(KERNELS, 0)
BUILD_LOG = {}
_LOCK = threading.Lock()
_LIBS = {}


def reset_launches():
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name):
    h = hashlib.sha1()
    for f in (name + ".cu",) + _COMMON:
        with open(os.path.join(_CSRC, f), "rb") as fp:
            h.update(fp.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, "lib%s-%s.so" % (name, h.hexdigest()[:12]))


def build_all():
    """Compile every kernel that is not built yet, one nvcc per source, all
    started together.  Returns the wall seconds spent."""
    t0 = time.time()
    with _LOCK:
        todo = [k for k in KERNELS if not os.path.exists(_lib_path(k))]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        os.makedirs(_BUILD, exist_ok=True)
        procs = []
        for k in todo:
            out = _lib_path(k)
            tmp = "%s.%d.tmp" % (out, os.getpid())
            cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, os.path.join(_CSRC, k + ".cu")]
            procs.append((k, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for k, out, tmp, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            BUILD_LOG[k] = log
            if p.returncode != 0:
                failed.append("%s:\n%s" % (k, log))
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for\n" + "\n".join(failed))
    return time.time() - t0


def _lib(name):
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        with _LOCK:
            lib = _LIBS.setdefault(name, ctypes.CDLL(_lib_path(name)))
    return lib


class FMView(ctypes.Structure):
    """Mirror of `struct FMView` in csrc/fm_device.cuh."""
    _fields_ = [("rows", ctypes.c_void_p), ("ftab", ctypes.c_void_p),
                ("psum", ctypes.c_void_p), ("sampled_sa", ctypes.c_void_p),
                ("sel_rows", ctypes.c_void_p), ("sel_vals", ctypes.c_void_p),
                ("rowmap", ctypes.c_void_p),
                ("n", ctypes.c_int32), ("first_isa", ctypes.c_int32),
                ("last_chr", ctypes.c_int32), ("sample_rate", ctypes.c_int32),
                ("adjusted_sa0", ctypes.c_int32), ("pw", ctypes.c_int32),
                ("n_sel", ctypes.c_int32)]


def _fm_view(fm):
    def ptr(t):
        return None if t is None else t.data_ptr()
    return FMView(ptr(fm.rows), ptr(fm.ftab), ptr(fm.psum), ptr(fm.sampled_sa),
                  ptr(fm.sel_rows), ptr(fm.sel_vals), ptr(fm.rowmap),
                  fm.n, fm.first_isa, fm.last_chr, fm.sample_rate,
                  fm.adjusted_sa0, fm.pw,
                  0 if fm.sel_rows is None else len(fm.sel_rows))


def launch(name, fm, *args):
    """Launch kernel `name` on the current stream of the index's device with
    `args` in the order of SIGNATURES[name]."""
    sig = SIGNATURES[name]
    if len(args) != len(sig):
        raise TypeError("%s takes %d arguments, got %d" % (name, len(sig), len(args)))
    cargs = []
    for kind, a in zip(sig, args):
        if kind == "P":
            if not isinstance(a, torch.Tensor) or a.device.type != "cuda":
                raise ValueError("%s: a CPU tensor reached the kernel" % name)
            cargs.append(a.data_ptr())
        else:
            cargs.append(int(a))
    lib = _lib(name)
    fn = getattr(lib, name + "_launch")
    fn.argtypes = ([ctypes.POINTER(FMView)]
                   + [ctypes.c_void_p if k == "P" else ctypes.c_int for k in sig]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(_fm_view(fm)), *cargs,
            torch.cuda.current_stream(fm.device).cuda_stream)
    if rc != 0:
        err = lib.cfr_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError("%s launch failed: CUDA error %d (%s)"
                           % (name, rc, err(rc).decode()))
    with _LOCK:
        LAUNCHES[name] += 1
