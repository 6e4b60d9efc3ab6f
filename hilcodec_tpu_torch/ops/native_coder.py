"""ctypes binding to the native range coder (`csrc/rangecoder.cpp`, the
package's own copy of the root source).

The library is built with g++ on first use into
`_build/librangecoder-<hash>.so` (`ops/cuda_build.build_host`): keyed by
the source and the flags, written under a temporary name of its own
process and renamed into place. The Python classes of
`ops/entropy_coding.py` define the bitstream; this coder is bit-identical
to them and takes the per-symbol loop off the Python interpreter. A
library that cannot be built or loaded raises; nothing falls back to the
Python coder.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import cuda_build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded coder with its signatures set, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load_host("rangecoder")
            lib.rc_encode.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
            lib.rc_encode.restype = ctypes.c_int64
            lib.rc_decode.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
            lib.rc_decode.restype = ctypes.c_int
            _lib = lib
        return _lib


def encode(symbols: np.ndarray, cdfs: np.ndarray) -> bytes:
    """symbols [n] int, cdfs [n, card+1] int64 -> bitstream."""
    lib = library()
    sym = np.ascontiguousarray(np.asarray(symbols).ravel(), np.int32)
    cd = np.ascontiguousarray(cdfs, np.int64)
    n, stride = cd.shape
    if len(sym) != n:
        raise ValueError(f"{len(sym)} symbols for {n} cdfs")
    # worst case ~precision bits a symbol + renormalization slack; the
    # coder reports an overflow and the buffer grows
    cap = 4 * n + 1024
    while True:
        out = np.empty(cap, np.uint8)
        nbytes = lib.rc_encode(
            sym.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            cd.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), stride - 1,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if nbytes >= 0:
            return out[:nbytes].tobytes()
        cap *= 2


def decode(data: bytes, cdfs: np.ndarray) -> np.ndarray:
    """bitstream + cdfs [n, card+1] int64 -> symbols [n] int64."""
    lib = library()
    cd = np.ascontiguousarray(cdfs, np.int64)
    n, stride = cd.shape
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int32)
    rc = lib.rc_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        cd.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), stride - 1, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"native range decoder failed (rc {rc})")
    return out.astype(np.int64)
