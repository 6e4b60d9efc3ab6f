"""The RVQ cascade kernel: wrapper, launch count and dispatching `quantize`.

Counterpart of `hilcodec_tpu/ops/pallas_rvq.py` (`quantize_pallas` and the
dispatching `quantize`). The CUDA C++ kernel is `csrc/rvq.cu`, which states
what it replaces, what bounds it and how it is built; its plain version is
`ops/rvq.quantize`, used here only for tensors on the CPU. A CUDA tensor
launches the kernel or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build
from . import rvq as _rvq

KERNEL = "rvq_cascade"
SOURCE = "hilcodec_tpu_torch/csrc/rvq.cu"
# launches of the kernel, counted where it is launched and nowhere else
LAUNCHES: Dict[str, int] = {KERNEL: 0}
SMEM_MAX = 232448  # dynamic shared memory a Hopper block may use

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_ready_devices: set = set()   # devices where rvq_cascade_init has run
# id(codebooks) -> (weakref, version, ||E||^2 [n_q, K])
_norms: Dict[int, Tuple[weakref.ref, int, torch.Tensor]] = {}


def reset_launches() -> None:
    LAUNCHES[KERNEL] = 0


def _library(device: torch.device) -> ctypes.CDLL:
    """The built kernel library, with the shared-memory limit raised once
    on `device` (the current device)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("rvq")
            lib.rvq_cascade.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.rvq_cascade.restype = ctypes.c_int
            lib.rvq_cascade_smem_bytes.argtypes = [ctypes.c_int]
            lib.rvq_cascade_smem_bytes.restype = ctypes.c_int
            lib.rvq_cascade_init.argtypes = [ctypes.c_int]
            lib.rvq_cascade_init.restype = ctypes.c_int
            _lib = lib
        if device.index not in _ready_devices:
            rc = _lib.rvq_cascade_init(SMEM_MAX)
            if rc != 0:
                raise RuntimeError(f"rvq_cascade_init failed on {device}: "
                                   f"CUDA error {rc}")
            _ready_devices.add(device.index)
        return _lib


def codebook_norms(codebooks: torch.Tensor) -> torch.Tensor:
    """||E||^2 per codeword, [n_q, K] f32: a constant of the weights, made
    once per codebook stack (and again if the stack is changed in place)."""
    key = id(codebooks)
    with _lock:
        hit = _norms.get(key)
        if (hit is not None and hit[0]() is codebooks
                and hit[1] == codebooks._version):
            return hit[2]
    e = codebooks.float()
    norms = torch.sum(e * e, dim=-1).contiguous()
    with _lock:
        for k in [k for k, v in _norms.items() if v[0]() is None]:
            del _norms[k]
        _norms[key] = (weakref.ref(codebooks), codebooks._version, norms)
    return norms


def quantize_cuda(x: torch.Tensor, codebooks: torch.Tensor,
                  n: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel. x: [B, T, C]; codebooks: [n_q, K, C], both f32 on
    one CUDA device -> indices [n, B, T] (int32)."""
    if x.device.type != "cuda" or codebooks.device != x.device:
        raise ValueError(f"rvq_cascade needs x and codebooks on one CUDA "
                         f"device, got {x.device} and {codebooks.device}")
    if x.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError(f"rvq_cascade takes float32, got {x.dtype} and "
                        f"{codebooks.dtype}")
    n_q, K, C = codebooks.shape
    n = n_q if n is None else n
    B, T, Cx = x.shape
    if Cx != C or not 0 <= n <= n_q:
        raise ValueError(f"shapes x {tuple(x.shape)}, codebooks "
                         f"{tuple(codebooks.shape)}, n={n}")
    flat = x.reshape(B * T, C).contiguous()
    books = codebooks.contiguous()
    norms = codebook_norms(books)
    out = torch.empty((n, B * T), dtype=torch.int32, device=x.device)
    if B * T == 0 or n == 0:
        return out.reshape(n, B, T)
    for t in (flat, books, norms):
        if t.data_ptr() % 16:
            raise ValueError("rvq_cascade needs 16-byte aligned tensors")
    with torch.cuda.device(x.device):
        lib = _library(x.device)
        if C % 4 or lib.rvq_cascade_smem_bytes(C) > SMEM_MAX:
            raise ValueError(f"rvq_cascade needs C % 4 == 0 and shared "
                             f"memory for C={C}")
        rc = lib.rvq_cascade(flat.data_ptr(), books.data_ptr(),
                             norms.data_ptr(), out.data_ptr(), B * T, K, C, n,
                             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rvq_cascade launch failed: CUDA error {rc}")
    LAUNCHES[KERNEL] += 1
    return out.reshape(n, B, T)


def quantize(x: torch.Tensor, codebooks: torch.Tensor,
             n: Optional[int] = None) -> torch.Tensor:
    """x: [B, T, C]; codebooks: [n_q, K, C] -> indices [n, B, T] (int32).

    The kernel for CUDA tensors; the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return _rvq.quantize(x, codebooks, n)
    return quantize_cuda(x, codebooks, n)
