"""Hand-written Hopper kernels: build, load and launch.

Each kernel is one CUDA C++ source in csrc/ with a plain C entry point
(`<name>_launch`) that takes device pointers and the stream, launches, and
returns cudaGetLastError().  The sources are compiled with nvcc for sm_90a
into kernels/_build/ (git-ignored) at first use, all in parallel, and
bound with ctypes.  Nothing here is imported or compiled when the package is
imported, and there is no fallback: a missing nvcc or a failed build raises.

LAUNCHES counts the launches each wrapper made, under the name of the
instantiation, "<kernel>:<rank layout>[:i64][:<variant>...]" (for example
"chain_search:plain", "chain_search:generic:lanes",
"chain_search:plain:wideftab", "resolve_rows:generic:i64",
"chain_search:plain_sharded"; ":i64" marks an int64 index, kernel K9, and
"plain_sharded" the plain layout with its big tables row-sharded, kernel
K10); callers reset it with reset_launches().  A launch runs with the
index's device current, on that device's current stream.

The launch path is host code on every kernel call, so it does no work that
an index or a library already fixed: an index's FMView (about 45 fields from
20 data pointers) and its launch-count names are built at its first launch
and kept on it (TorchFM.kernel_view, dropped when an attribute of the index
is set), and each entry point's ctypes prototype is set once, when its
library loads.

dep_gather (K12, a microbenchmark of its own) and translate_frames (K13,
the protein engine's six-frame translation) take no FMView: they are
launched through launch_raw and counted under the kernel's name.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

# C entry point -> (the source that holds it, its arguments after the leading
# `const FMView*` (none for RAW_ENTRIES) and before the trailing stream:
# P = device pointer, i = int)
ENTRIES = {
    # pack2 vmask lengths U L mhl H hits nhits
    "chain_search": ("chain_search", "PPPiiiiPP"),
    # codes lengths B L mhl H hits nhits
    "chain_search_lanes": ("chain_search", "PPiiiiPP"),
    # rows valid M out
    "resolve_rows": ("resolve_rows", "PPiP"),
    # hits nhits Q nr H mhl me k_out protein packed
    "finalize_units": ("finalize_units", "PPiiiiiiiP"),
    # codes ms B L out[3, B]
    "prefix_search": ("prefix_search", "PPiiP"),
    # mode a b c M out0 out1
    "rank_probe": ("rank_probe", "iPPPiPP"),
    # table nrow idx B iters out (no FMView)
    "dep_gather": ("dep_gather", "PiPiiP"),
    # flat starts table R L codes lengths (no FMView)
    "translate_frames": ("translate_frames", "PPPiiPP"),
}
RAW_ENTRIES = ("dep_gather", "translate_frames")
KERNELS = tuple(dict.fromkeys(src for src, _ in ENTRIES.values()))
LAYOUT_IDS = {"plain": 0, "runblock": 1, "generic": 2, "plain_sharded": 3}
_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
_COMMON = ("fm_view.cuh", "fm_device.cuh", "rank_plain.cuh", "rank_mega.cuh",
           "rank_runblock.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = collections.Counter()
BUILD_LOG = {}
_LOCK = threading.Lock()
_LIBS = {}
_ENTRY_FNS = {}     # entry -> its prototyped ctypes function
ROW_ALIGN = 16      # bytes: the group ranks read rows and blocks as 16-byte vectors


def reset_launches():
    with _LOCK:
        LAUNCHES.clear()


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
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = _bind(ctypes.CDLL(_lib_path(name)), name)
    return lib


def _bind(lib, name):
    """Set the ctypes prototypes of the library `name`'s entry points and of
    the helpers every library holds, once; returns lib."""
    for entry, (src, sig) in ENTRIES.items():
        if src != name:
            continue
        fn = getattr(lib, entry + "_launch")
        fn.argtypes = ([] if entry in RAW_ENTRIES else [ctypes.POINTER(FMView)]) + \
            [ctypes.c_void_p if k == "P" else ctypes.c_int for k in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY_FNS[entry] = fn
    lib.cfr_error_string.argtypes = [ctypes.c_int]
    lib.cfr_error_string.restype = ctypes.c_char_p
    lib.cfr_enable_peer_access.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)]
    lib.cfr_enable_peer_access.restype = ctypes.c_int
    return lib


def _entry_fn(entry):
    fn = _ENTRY_FNS.get(entry)
    if fn is None:
        _lib(ENTRIES[entry][0])
        fn = _ENTRY_FNS[entry]
    return fn


class FMView(ctypes.Structure):
    """Mirror of `struct FMView` in csrc/fm_view.cuh."""
    _POINTERS = ("rows", "mega", "ind_words", "ind_cum", "lit_words", "lit_occ",
                 "run_words", "run_occ", "ftab", "psum", "sampled_sa", "sel_rows",
                 "sel_vals", "end_marker_sa", "rowmap")
    _INT64S = ("ftab_size", "n", "first_isa", "adjusted_sa0", "lit_n", "run_n")
    _INTS = ("layout", "idx64", "last_chr", "sample_rate", "pw", "code_bits", "sigma",
             "n_sel", "n_end", "b", "b_lt_n", "width", "m_lit", "m_run")
    _SHARDED = ([(p, ctypes.c_void_p) for p in ("rows_shards", "rowmap_shards",
                                                "sampled_shards")]
                + [(i, ctypes.c_int64) for i in ("rps_map", "rps_sa")]
                + [(i, ctypes.c_int32) for i in ("rps_rows", "n_shards", "has_rowmap")])
    _fields_ = ([(p, ctypes.c_void_p) for p in _POINTERS]
                + [(i, ctypes.c_int64) for i in _INT64S]
                + [(i, ctypes.c_int32) for i in _INTS] + _SHARDED)


def _aligned(t, what):
    if t is not None and t.data_ptr() % ROW_ALIGN:
        raise ValueError("%s is not %d-byte aligned (data_ptr %% %d = %d): the kernels read "
                         "it as 16-byte vectors" % (what, ROW_ALIGN, ROW_ALIGN,
                                                    t.data_ptr() % ROW_ALIGN))


def _fm_view(fm):
    """A new FMView of the index `fm`; raises where its wide rows (or a
    shard of them) or its generic indicator and stream words are not 16-byte
    aligned."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    def sub(m, name):
        return None if m is None else getattr(m, name).data_ptr()
    common = dict(
        ftab=ptr(fm.ftab), psum=ptr(fm.psum), sel_rows=ptr(fm.sel_rows),
        sel_vals=ptr(fm.sel_vals), end_marker_sa=ptr(fm.end_marker_sa),
        ftab_size=fm.ftab_size, layout=LAYOUT_IDS[fm.layout],
        idx64=int(fm.idtype == torch.int64), n=fm.n,
        first_isa=fm.first_isa, last_chr=fm.last_chr, sample_rate=fm.sample_rate,
        adjusted_sa0=fm.adjusted_sa0, pw=fm.pw, code_bits=fm.code_bits,
        sigma=fm.sigma,
        n_sel=0 if fm.sel_rows is None else len(fm.sel_rows),
        n_end=0 if fm.end_marker_sa is None else len(fm.end_marker_sa),
        b=fm.b, b_lt_n=int(fm.b_lt_n))
    if fm.layout == "plain_sharded":
        # the three big tables are read through their shard tables only
        for s, t in enumerate(fm.shards["rows"]):
            _aligned(t, "shard %d of the wide rows" % s)
        return FMView(**common, **fm.shard_fields())
    _aligned(fm.rows, "the wide rows")
    for name in ("ind", "lit", "run"):
        _aligned(None if getattr(fm, name) is None else getattr(fm, name).words,
                 "the generic %s words" % name)
    return FMView(
        **common, rows=ptr(fm.rows), mega=ptr(fm.mega),
        ind_words=sub(fm.ind, "words"), ind_cum=sub(fm.ind, "cum"),
        lit_words=sub(fm.lit, "words"), lit_occ=sub(fm.lit, "occ"),
        run_words=sub(fm.run, "words"), run_occ=sub(fm.run, "occ"),
        sampled_sa=ptr(fm.sampled_sa), rowmap=ptr(fm.rowmap),
        width=0 if fm.lit is None else fm.lit.width,
        lit_n=fm.lit_n, run_n=fm.run_n, m_lit=fm.m_lit, m_run=fm.m_run,
        has_rowmap=int(fm.rowmap is not None))


class LaunchView:
    """What a launch needs of an index, built once (TorchFM.kernel_view):
    its FMView and a pointer to it, its device, and the launch-count names of
    the (entry, variant) pairs launched on it so far."""

    __slots__ = ("fm_view", "pointer", "device", "names")

    def __init__(self, fm):
        self.fm_view = _fm_view(fm)
        self.pointer = ctypes.pointer(self.fm_view)
        self.device = fm.device
        self.names = {}


def instantiation(kernel, fm, variant=()):
    """The launch-count name of `kernel` on the index `fm`."""
    return ":".join((kernel, fm.layout) + ("i64",) * (fm.idtype == torch.int64)
                    + tuple(variant))


def launch(entry, fm, *args, variant=()):
    """Launch the C entry point `entry` on the current stream of the index's
    device with `args` in the order of ENTRIES[entry]; the kernel is the
    instantiation for the index's rank layout and index type.  `variant`
    names what else the wrapper's arguments select, for the launch count."""
    cargs = _c_args(entry, args)
    view = fm.kernel_view()
    _call(entry, view.device, [view.pointer] + cargs)
    name = view.names.get((entry, variant))
    if name is None:
        name = view.names[entry, variant] = instantiation(ENTRIES[entry][0], fm, variant)
    with _LOCK:
        LAUNCHES[name] += 1


def launch_raw(entry, device, *args):
    """Launch a C entry point that takes no FMView (RAW_ENTRIES) on the
    current stream of `device`, counted under the kernel's name."""
    _call(entry, device, _c_args(entry, args))
    with _LOCK:
        LAUNCHES[ENTRIES[entry][0]] += 1


def enable_peer_access(device, peer):
    """Let kernels that run on CUDA device `device` read memory of device
    `peer` (ints).  Raises where the pair has no peer access or enabling it
    fails; an access enabled before is no error."""
    lib = _lib(KERNELS[0])
    can = ctypes.c_int(0)
    rc = lib.cfr_enable_peer_access(int(device), int(peer), ctypes.byref(can))
    if rc != 0:
        raise RuntimeError("enabling peer access from cuda:%d to cuda:%d failed: %s"
                           % (device, peer, _error_string(lib, rc)))
    if not can.value:
        raise RuntimeError("cuda:%d cannot access the memory of cuda:%d "
                           "(cudaDeviceCanAccessPeer is 0)" % (device, peer))


def _error_string(lib, rc):
    return "CUDA error %d (%s)" % (rc, lib.cfr_error_string(rc).decode())


def _stream(index):
    """The raw cudaStream_t of CUDA device `index`'s current stream.  The
    public torch.cuda.current_stream(device).cuda_stream builds a Stream
    object on every call; this is the call it wraps."""
    return torch._C._cuda_getCurrentRawStream(index)


def _c_args(entry, args):
    """`args` of `entry` as the C call takes them (a tensor's data pointer,
    an int); raises on a wrong count or a tensor that is not on a card."""
    sig = ENTRIES[entry][1]
    if len(args) != len(sig):
        raise TypeError("%s takes %d arguments, got %d" % (entry, len(sig), len(args)))
    cargs = []
    for kind, a in zip(sig, args):
        if kind == "P":
            if not isinstance(a, torch.Tensor) or not a.is_cuda:
                raise ValueError("%s: a CPU tensor reached the kernel" % entry)
            cargs.append(a.data_ptr())
        else:
            cargs.append(int(a))
    return cargs


def _call(entry, device, cargs):
    """Call `<entry>_launch` with cargs and the stream, `device` current, and
    raise on a CUDA error."""
    fn = _entry_fn(entry)
    index, current = device.index, torch._C._cuda_getDevice()
    if index is None or index == current:
        rc = fn(*cargs, _stream(current))
    else:   # an index on another card (a sharded index's view): its context
        with torch.cuda.device(device):
            rc = fn(*cargs, _stream(index))
    if rc != 0:
        raise RuntimeError("%s launch failed: %s"
                           % (entry, _error_string(_lib(ENTRIES[entry][0]), rc)))
