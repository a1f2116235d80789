# Port copy of centrifuger_tpu.fm.suffix_array (host code, no accelerator).
"""Suffix array construction (host-side, offline) with the native linear-time
SA-IS builder (native/sais.cpp).  Comparison semantics match the reference's
sentinel-free ordering, where a shorter suffix sorts before any suffix it
prefixes (SubrangeCompare, compactds/FixedSizeElemArray.hpp:283-...).
"""

import ctypes

import numpy as np


def suffix_array(codes, sigma=None):
    """SA of the code sequence (no sentinel; shorter-suffix-first ordering)."""
    codes = np.asarray(codes)
    n = len(codes)
    if n <= 1:
        return np.zeros(n, dtype=np.int64)
    from ..native import load
    lib = load("sais")
    if sigma is None:
        sigma = int(codes.max()) + 1
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    sa = np.empty(len(codes), dtype=np.int64)
    fn = lib.sais_u8
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    rc = fn(codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(codes), sigma,
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise RuntimeError("sais_u8 failed with code %d" % rc)
    return sa


def bwt_from_sa(codes, sa):
    """BWT with no explicit end marker: BWT[i] = T[SA[i]-1], and for SA[i]==0 the
    last character of T is stored (reference compactds/FMBuilder.hpp:244-250).
    Returns (bwt_codes, first_isa)."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    bwt = np.where(sa == 0, codes[n - 1], codes[sa - 1]).astype(np.uint8)
    first_isa = int(np.flatnonzero(sa == 0)[0])
    return bwt, first_isa
