"""The RVQ cascade kernel: plan, wrapper, launch count and dispatching
`quantize`.

Counterpart of `hilcodec_tpu/ops/pallas_rvq.py` (`quantize_pallas` and the
dispatching `quantize`). The CUDA C++ kernel is `csrc/rvq.cu`; it replaces
the TPU kernels K1 (`_rvq_kernel`, the resident stack) and K2
(`_rvq_staged_kernel`, one codebook per grid step): it streams the
codebooks, so one kernel serves any stack size. Its plain version is
`ops/rvq.quantize`, used here only for tensors on the CPU. A CUDA tensor
launches the kernel or raises: nothing falls back.

Bound on an H100 SXM at n = 8, K = 1024, C = 128: 1.26 us at M = 16 rows
(the 4.2 MB of codebooks over 3.35 TB/s) and 4.0 us at M = 128 (the dot
products over 67 TFLOP/s f32).

Design (details in `csrc/rvq.cu`). A thread-block cluster of G = 8 or 16
CTAs owns a tile of rows; each CTA owns a contiguous slice of about K / G
codewords of every stage, which lands in a ring of shared-memory chunk
slots by
Hopper bulk copies (one per 8 codewords) completing on mbarriers, ahead of
the cascade. Each CTA scores its slice on the f32 CUDA cores in the
reference's order and keeps the first argmin; the CTAs merge their
(distance, index) candidates through distributed shared memory, one
cluster barrier per stage, with the rule "smaller distance, then smaller
index", so every CTA knows the global first argmin and updates its own
copy of the residual. The distances stay on FFMA: at the serving shape a
stage costs latency and shared-memory traffic, not arithmetic, and FFMA
keeps the tokens those of the plain cascade except at real f32 ties.

`rvq_plan` picks the cluster size, rows per cluster, slice, chunk width
and ring depth from the shapes and from how many clusters the card holds
at once (cudaOccupancyMaxActiveClusters): clusters of 16 CTAs while all
of them fit one wave (the serving shape), else of 8 (the frame-kernel
path's 128 rows). The kernel launches that plan as given, so the CPU tests
check what the card runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch

from . import cuda_build
from . import rvq as _rvq

KERNEL = "rvq_cascade"
SOURCE = "hilcodec_tpu_torch/csrc/rvq.cu"
# launches of the kernel, counted where it is launched and nowhere else
LAUNCHES: Dict[str, int] = {KERNEL: 0}
SMEM_MAX = 232448  # dynamic shared memory a Hopper block may use
# CTAs per cluster, widest first: 16 needs the non-portable opt-in (made at
# init), 8 is the largest portable size
CLUSTERS = (16, 8)
ROWS = (8, 16)     # rows per cluster (the kernel's instances)
MAX_RING = 4       # chunk slots (kMaxRing in csrc/rvq.cu)
GROUP = 8          # codewords per bulk copy (kQ in csrc/rvq.cu)
PAD = 4            # floats of padding per group row in shared memory
WARPS = 8          # warps per CTA

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_ready_devices: set = set()   # devices where rvq_cascade_init has run
# id(codebooks) -> (weakref, version, ||E||^2 [n_q, K])
_norms: Dict[int, Tuple[weakref.ref, int, torch.Tensor]] = {}


def reset_launches() -> None:
    LAUNCHES[KERNEL] = 0


def smem_bytes(C: int, rows: int, codes: int, ring: int) -> int:
    """Dynamic shared memory of one CTA (`smem_bytes` in csrc/rvq.cu, which
    refuses a launch whose plan disagrees): mbarriers, the ring of `ring`
    chunks of `codes` codewords in padded groups of GROUP, the padded
    residual rows, ||r||^2, and the candidates (distance, index) of each
    row and warp, double-buffered by stage."""
    floats = (ring * (codes // GROUP) * (GROUP * C + PAD) + rows * (C + PAD)
              + rows + 4 * rows * WARPS)
    return 8 * MAX_RING + 4 * floats


@dataclasses.dataclass(frozen=True)
class RvqPlan:
    """One launch, passed whole to the kernel: `tiles` clusters of
    `cluster` CTAs, each cluster on `rows` rows; CTA r scores codewords
    [r * slice, (r + 1) * slice) of every stage (clipped to K), in
    `chunks` chunks of up to `codes` codewords through a ring of `ring`
    slots, in `smem` bytes of shared memory."""
    cluster: int
    rows: int
    codes: int
    ring: int
    slice: int
    chunks: int
    tiles: int
    smem: int


def make_plan(M: int, K: int, C: int, n: int, cluster: int,
              rows: int) -> RvqPlan:
    """The launch with `cluster` CTAs a cluster and `rows` rows a cluster.

    Chunks of 128 codewords, or 64 when a slice is no larger (then four
    row groups share the CTA's 256 threads instead of two); the deepest
    ring of up to MAX_RING chunks that fits SMEM_MAX."""
    if cluster not in CLUSTERS or rows not in ROWS:
        raise ValueError(f"no kernel instance for clusters of {cluster} "
                         f"CTAs on {rows} rows")
    if K <= 0 or C <= 0 or C % 4:
        raise ValueError(f"rvq_cascade needs K > 0 and C % 4 == 0, got "
                         f"K={K}, C={C}")
    per = -(-K // cluster)
    codes = 128 if per > 64 else 64
    chunks = -(-per // codes)
    ring = max(1, min(MAX_RING, n * chunks))
    while ring > 1 and smem_bytes(C, rows, codes, ring) > SMEM_MAX:
        ring -= 1
    smem = smem_bytes(C, rows, codes, ring)
    if smem > SMEM_MAX:
        raise ValueError(f"rvq_cascade: C={C} needs {smem} bytes of shared "
                         f"memory, over {SMEM_MAX}")
    return RvqPlan(cluster=cluster, rows=rows, codes=codes, ring=ring,
                   slice=per, chunks=chunks, tiles=-(-M // rows), smem=smem)


def rvq_plan(M: int, K: int, C: int, n: int,
             held: Callable[[RvqPlan], int]) -> RvqPlan:
    """The launch for x [M, C] against n codebooks of K codewords, on a
    card that holds `held(plan)` clusters of a plan at once.

    A stage's time is mostly its slice's scoring, which a wider cluster
    cuts, as long as every cluster runs in the first wave. So: the widest
    cluster whose tiles of 8 rows all fit one wave; if none, clusters of
    8 on tiles of 16 rows, which halves the codebook traffic per row."""
    for cluster in CLUSTERS:
        plan = make_plan(M, K, C, n, cluster, ROWS[0])
        if plan.tiles <= held(plan):
            return plan
    plan = make_plan(M, K, C, n, CLUSTERS[-1], ROWS[-1])
    if held(plan) <= 0:
        raise ValueError(f"rvq_cascade: the card holds no cluster of "
                         f"{plan.cluster} CTAs with {plan.smem} bytes of "
                         f"shared memory")
    return plan


def _library(device: torch.device) -> ctypes.CDLL:
    """The built kernel library, with the shared-memory and cluster limits
    raised once on `device` (the current device)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("rvq")
            i, p = ctypes.c_int, ctypes.c_void_p
            lib.rvq_cascade.argtypes = [p, p, p, p] + [i] * 11 + [p]
            lib.rvq_cascade.restype = i
            lib.rvq_cascade_init.argtypes = [i]
            lib.rvq_cascade_init.restype = i
            lib.rvq_cascade_max_clusters.argtypes = [
                i, i, i, i, i, i, ctypes.POINTER(i)]
            lib.rvq_cascade_max_clusters.restype = i
            _lib = lib
        if device.index not in _ready_devices:
            rc = _lib.rvq_cascade_init(SMEM_MAX)
            if rc != 0:
                raise RuntimeError(f"rvq_cascade_init failed on {device}: "
                                   f"CUDA error {rc}")
            _ready_devices.add(device.index)
        return _lib


@functools.lru_cache(maxsize=256)
def device_plan(device: torch.device, M: int, K: int, C: int,
                n: int) -> Tuple[RvqPlan, Dict[Tuple[int, int], int]]:
    """The plan the kernel launches on `device`, made once per shape, and
    the cudaOccupancyMaxActiveClusters of each (cluster, rows) it was
    chosen from."""
    held: Dict[Tuple[int, int], int] = {}

    def query(plan: RvqPlan) -> int:
        out = ctypes.c_int(0)
        rc = lib.rvq_cascade_max_clusters(plan.cluster, plan.rows,
                                          plan.codes, plan.ring, C,
                                          plan.smem, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"rvq_cascade: cluster occupancy query "
                               f"failed on {device}: CUDA error {rc}")
        held[(plan.cluster, plan.rows)] = out.value
        return out.value

    with torch.cuda.device(device):
        lib = _library(device)
        plan = rvq_plan(M, K, C, n, query)
    return plan, held


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
    M = B * T
    flat = x.reshape(M, C).contiguous()
    books = codebooks.contiguous()
    norms = codebook_norms(books)
    out = torch.empty((n, M), dtype=torch.int32, device=x.device)
    if M == 0 or n == 0:
        return out.reshape(n, B, T)
    for t in (flat, books, norms):
        if t.data_ptr() % 16:
            raise ValueError("rvq_cascade needs 16-byte aligned tensors")
    plan, _ = device_plan(x.device, M, K, C, n)
    with torch.cuda.device(x.device):
        rc = _lib.rvq_cascade(flat.data_ptr(), books.data_ptr(),
                              norms.data_ptr(), out.data_ptr(), M, K, C, n,
                              plan.cluster, plan.rows, plan.codes, plan.ring,
                              plan.slice, plan.chunks, plan.smem,
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
