# Port copy of centrifuger_tpu.fm.sa_external (host code, no accelerator).
"""Memory-bounded chunked suffix-array construction (the Python side).

Drives native/sa_chunked.cpp: a difference-cover sample sort bounds every
suffix comparison, then k-mer-prefix chunks of at most ~bmax suffixes are
classified and multikey-quicksorted concurrently, streamed back in global SA
order. Peak memory stays near

    text + BWT accumulation + DC sample ranks + threads * bmax * 8B

(fm/builder.py:build_memory counts every term of it) instead of the ~17
bytes/char a whole-text SA-IS needs — the capability of
the reference's --build-mem/--bmax/--dcv machinery
(compactds/FMBuilder.hpp:371-438 parameter inference, :444-811 chunk builds;
compactds/SuffixArrayGenerator.hpp) in an independent k-mer-bucket design.

Checkpoint/resume mirrors the reference's protocol (FMBuilder.hpp:52-58):
state is dumped after the DC phase and every ~10% of chunk batches; an
interrupted build resumes from the last completed batch, under the same
chunk plan only (plan_record; fm/builder.py starts afresh otherwise).
"""

import ctypes
import json
import os

import numpy as np

from ..utils import log2ceil


def default_kprefix(n, sigma):
    """The chunk plan's k-mer length: its counters table has at most 2^24
    entries (128 MB of int64) and at most ~4n."""
    bits = max(1, log2ceil(int(sigma)))
    k = max(1, min(24 // bits, 12))
    while k > 2 and (1 << (bits * k)) > 4 * max(n, 1):
        k -= 1
    return k


class ChunkedSA:
    """Iterator over (row0, sa_chunk) pieces of the suffix array, in order."""

    def __init__(self, codes, sigma, dcv=4096, bmax=1 << 24, threads=1,
                 kprefix=None, checkpoint_prefix=None, log=None):
        from ..native import load
        self.lib = load("sa_chunked")
        self._cfg_ctypes()
        self.codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self.n = len(self.codes)
        self.sigma = int(sigma)
        self.bits = max(1, log2ceil(self.sigma))
        self.threads = max(1, int(threads))
        self.bmax = max(int(bmax), 256)
        self.dcv = int(dcv)
        self.ckpt = checkpoint_prefix
        self.log = log or (lambda m: None)
        # content digest guards checkpoint resume against a changed input
        # genome of the same length (same guard as the SA-IS build path)
        import hashlib
        self.digest = hashlib.sha256(self.codes.tobytes()).hexdigest()[:16] \
            if self.ckpt else None
        self.k = int(default_kprefix(self.n, self.sigma) if kprefix is None else kprefix)
        self.chunks = None
        self.h = self.lib.sac_create(
            self.codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.n, self.sigma, self.dcv)

    def _cfg_ctypes(self):
        lib = self.lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.sac_create.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_int32]
        lib.sac_create.restype = ctypes.c_void_p
        lib.sac_destroy.argtypes = [ctypes.c_void_p]
        lib.sac_v.argtypes = [ctypes.c_void_p]
        lib.sac_v.restype = ctypes.c_int32
        lib.sac_dc_init.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.sac_dc_size.argtypes = [ctypes.c_void_p]
        lib.sac_dc_size.restype = ctypes.c_int64
        lib.sac_dc_save.argtypes = [ctypes.c_void_p, i64p]
        lib.sac_dc_load.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64]
        lib.sac_kmer_hist.argtypes = [ctypes.c_void_p, ctypes.c_int32, i64p]
        lib.sac_sort_chunks.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, u64p, u64p, ctypes.c_int32,
            ctypes.c_int32, i64p, ctypes.c_int64, i64p]
        lib.sac_sort_chunks.restype = ctypes.c_int64

    def close(self):
        if self.h:
            self.lib.sac_destroy(self.h)
            self.h = None

    # ------------------------------------------------------------ checkpoint

    def _ckpt_paths(self):
        return (self.ckpt + "_checkpoint.json",
                self.ckpt + "_checkpoint_dc.npy")

    def _save_dc(self):
        if not self.ckpt:
            return
        jp, dp = self._ckpt_paths()
        sz = self.lib.sac_dc_size(self.h)
        buf = np.empty(sz, np.int64)
        self.lib.sac_dc_save(self.h, buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)))
        np.save(dp + ".tmp.npy", buf)
        os.replace(dp + ".tmp.npy", dp)
        with open(jp + ".tmp", "w") as f:
            json.dump({"phase": "dc_done", "n": self.n, "dcv": self.dcv,
                       "k": self.k, "digest": self.digest}, f)
        os.replace(jp + ".tmp", jp)

    def _try_load_dc(self):
        if not self.ckpt:
            return False
        jp, dp = self._ckpt_paths()
        if not (os.path.exists(jp) and os.path.exists(dp)):
            return False
        with open(jp) as f:
            meta = json.load(f)
        if meta.get("n") != self.n or meta.get("dcv") != self.dcv \
                or meta.get("digest") != self.digest:
            return False
        buf = np.load(dp)
        self.lib.sac_dc_load(self.h, buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)), len(buf))
        self.log("resumed DC sample ranks from checkpoint")
        return True

    # ------------------------------------------------------------- main flow

    def plan_chunks(self):
        """k-mer histogram -> list of (kmer_lo, kmer_hi, count) chunks with
        count <= bmax where possible (single overweight k-mers may exceed).
        The histogram becomes its own inclusive prefix sum in place, so the
        plan holds one 4^k table of int64."""
        size = 1 << (self.bits * self.k)
        cum = np.zeros(size, np.int64)
        self.lib.sac_kmer_hist(self.h, self.k, cum.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)))
        np.cumsum(cum, out=cum)          # cum[i] = suffixes with key <= i

        def before(b):                    # suffixes with key < b
            return int(cum[b - 1]) if b > 0 else 0
        bounds = [0]
        # vectorized greedy: repeatedly find furthest cut with
        # before(cut) - before(cur) <= bmax
        while bounds[-1] < size:
            cur = bounds[-1]
            hi = int(np.searchsorted(cum, before(cur) + self.bmax, side="right"))
            if hi <= cur:
                hi = cur + 1  # single overweight k-mer
            bounds.append(min(hi, size))
        return [(bounds[i], bounds[i + 1], before(bounds[i + 1]) - before(bounds[i]))
                for i in range(len(bounds) - 1)]

    def prepare(self):
        """The difference-cover ranks (sorted, or read from the checkpoint)
        and the chunk plan; iter_chunks calls it when it has not run."""
        if self.chunks is not None:
            return
        if not self._try_load_dc():
            self.log("sorting difference-cover sample (v=%d)..."
                     % self.lib.sac_v(self.h))
            self.lib.sac_dc_init(self.h, self.threads)
            self._save_dc()
        self.chunks = self.plan_chunks()
        self.n_chunks = len(self.chunks)
        self.log("chunk plan: %d chunks (k=%d, bmax=%d)"
                 % (self.n_chunks, self.k, self.bmax))

    def plan_record(self):
        """What a state checkpoint must match to resume under this plan: the
        k-mer length, bmax, the DC period, the chunk count and a digest of
        the chunk bounds and counts."""
        import hashlib
        self.prepare()
        digest = hashlib.sha256(np.asarray(self.chunks, np.int64).tobytes()).hexdigest()[:16]
        return {"k": self.k, "bmax": self.bmax, "dcv": self.dcv,
                "n_chunks": self.n_chunks, "plan_digest": digest}

    def __iter__(self):
        return self.iter_chunks(0)

    def iter_chunks(self, start_chunk=0):
        """Yields (chunk_index, row0, sorted_positions) in global SA order,
        starting at chunk `start_chunk` (for checkpoint resume).  A batch is
        up to `threads` consecutive chunks of at most min(threads * bmax, n)
        suffixes together (one overweight chunk alone may be more); every
        batch's positions land in one reused buffer, so each yielded array
        is valid until the next one is asked for."""
        self.prepare()
        chunks = self.chunks
        T = self.threads
        row0 = sum(c[2] for c in chunks[:start_chunk])
        cap = max(min(T * self.bmax, self.n),
                  max((c[2] for c in chunks[start_chunk:]), default=1), 1)
        out = np.empty(cap, np.int64)
        i = start_chunk
        while i < len(chunks):
            j, total = i + 1, chunks[i][2]
            while j < len(chunks) and j - i < T and total + chunks[j][2] <= cap:
                total += chunks[j][2]
                j += 1
            batch = chunks[i:j]
            lo = np.array([c[0] for c in batch], np.uint64)
            hi = np.array([c[1] for c in batch], np.uint64)
            offs = np.zeros(len(batch) + 1, np.int64)
            got = self.lib.sac_sort_chunks(
                self.h, self.k,
                lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                len(batch), T,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(out),
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if got < 0:
                raise RuntimeError("chunk capacity exceeded (histogram drift?)")
            for m in range(len(batch)):
                part = out[offs[m]:offs[m + 1]]
                yield i + m, row0, part
                row0 += len(part)
            i = j
        if row0 != self.n:
            raise RuntimeError("chunked SA covered %d of %d suffixes"
                               % (row0, self.n))
