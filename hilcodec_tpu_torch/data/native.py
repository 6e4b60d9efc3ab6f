"""ctypes binding to the native WAV reader (`csrc/wavio.cpp`, the package's
own copy of the root source; `hilcodec_tpu/data/native.py`).

RIFF parsing, seeking and the int -> float conversion in C++, and a
batched reader that fills a whole training batch from a pool of threads
in one call, outside the GIL. The library is built with g++ on first use
into `_build/libwavio-<hash>.so` (`ops/cuda_build.build_host`): keyed by
the source and the flags, written under a temporary name of its own
process and renamed into place. A library that cannot be built or loaded
raises; nothing falls back to the stdlib reader here. (`data/datasets.
read_wav` reads a file the native reader refuses, such as a 64-bit float
WAV, with the stdlib reader, file by file, as the JAX package does.)
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops import cuda_build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class Refused(IOError):
    """The reader refused a file (its C function returned an error): the
    only error a caller may answer with another reader. A library that
    cannot be built or loaded raises something else."""


def library() -> ctypes.CDLL:
    """The loaded reader with its signatures set, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load_host("wavio")
            lib.wav_info.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int32)]
            lib.wav_info.restype = ctypes.c_int
            lib.wav_read_segment.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float)]
            lib.wav_read_segment.restype = ctypes.c_int64
            lib.wav_read_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.wav_read_batch.restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded; raises if it cannot be."""
    return library() is not None


def wav_info(path: str) -> Tuple[int, int, int]:
    """(num_frames, sample_rate, channels); Refused for a file the reader
    cannot parse."""
    frames, sr, ch = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    if library().wav_info(path.encode(), ctypes.byref(frames),
                          ctypes.byref(sr), ctypes.byref(ch)) != 0:
        raise Refused(f"cannot parse {path}")
    return frames.value, sr.value, ch.value


def read_segment(path: str, start: int = 0, frames: int = -1) -> np.ndarray:
    """float32 mono segment [frames] (channels averaged); frames=-1 reads
    to the end. Refused for a file the reader cannot decode."""
    lib = library()
    if frames < 0:
        total, _sr, _ch = wav_info(path)
        frames = total - start
    out = np.zeros(max(frames, 0), np.float32)
    got = lib.wav_read_segment(
        path.encode(), start, frames,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        raise Refused(f"cannot read {path}")
    return out[:got] if got < frames else out


def read_batch(paths: Sequence[str], starts: Sequence[int], frames: int,
               threads: int = 8) -> np.ndarray:
    """[len(paths), frames] float32 from `threads` threads; a short read is
    zero-padded. Refused when any item cannot be read."""
    lib = library()
    n = len(paths)
    out = np.zeros((n, frames), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = (ctypes.c_int64 * n)(*[int(s) for s in starts])
    good = lib.wav_read_batch(
        c_paths, c_starts, frames, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
    if good != n:
        raise Refused(f"{n - good} of {n} segment reads failed")
    return out
