"""Build the package's native sources and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C interface and is compiled with
nvcc on first use into `_build/lib<name>-<hash>.so` inside the package
(listed in `.gitignore`), keyed by a hash of the source and the flags, so
that a checkout builds from its own sources and never reuses a stale
library. A host library, `csrc/<name>.cpp` (the range coder, the WAV
reader), is built the same way with g++ (`build_host` / `load_host`).
Each build writes a temporary file named by its process and renames it
into place, so concurrent builds of one source never share a file.
Nothing here runs at import time: the CPU tests import every module, and
`nvcc` is needed only when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _library_path(name: str, ext: str, flags) -> Path:
    src = (CSRC_DIR / f"{name}{ext}").read_bytes()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def _compile(name: str, ext: str, compiler: str, flags
             ) -> Tuple[Path, float, str]:
    out = _library_path(name, ext, flags)
    report = out.with_suffix(".log")      # the compiler's messages
    if out.exists():
        return out, 0.0, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(CSRC_DIR / f"{name}{ext}")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed for "
                           f"{name}{ext} (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    report.write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees old or new
    return out, dt, proc.stderr


def build(name: str) -> Tuple[Path, float, str]:
    """Compile `csrc/<name>.cu` unless this exact source is built already.

    Returns (library path, build seconds, nvcc's messages with ptxas's
    report; they are kept beside the library, so a cached build returns
    them too)."""
    return _compile(name, ".cu", nvcc(), NVCC_FLAGS)


def gxx() -> str:
    """Path of the host C++ compiler: $CXX, else g++ on PATH."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("g++ not found (set CXX): the host libraries "
                           "(csrc/rangecoder.cpp, csrc/wavio.cpp) are "
                           "built with it")
    return found


def build_host(name: str) -> Tuple[Path, float, str]:
    """Compile the host library `csrc/<name>.cpp` with g++, as `build`."""
    return _compile(name, ".cpp", gxx(), GXX_FLAGS)


def _load(name: str, compile_fn) -> ctypes.CDLL:
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _, _ = compile_fn(name)
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    return _load(name, build)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cpp`, built on first use."""
    return _load(name, build_host)
