"""The multi-leaf AdamP kernel: its static leaf table, launch count and
wrapper.

Replaces no TPU kernel (the JAX package leaves AdamP to XLA). The CUDA C++
kernel is `csrc/adamp.cu`; its plain version is `train/optim.AdamP.update`
with the masked commit, which `AdamP.apply` runs on the CPU. One call updates every leaf of a tree in at most three
launches (pass A over (leaf, chunk) items, pass R over the projected
leaves, pass B over their chunks) plus one host-to-device copy of the
leaves' pointers.

`build_table` makes, once per tree structure and optimizer, everything
that does not change from step to step: each leaf's place in the flat
outputs (offsets padded to 4 floats, so that 16-byte accesses line up),
its dim-0 rows and row length, its mode (0 no projection, 1 the channel
projection always, 2 the gate), its gate thresholds delta / sqrt(row
length) and delta / sqrt(numel) (`optim.gate_inputs`), its `lr_scale`
and `weight_decay`, and the work items. Only the pointer table is built
each step. The table is plain numpy, so the CPU tests check what the card
runs.

Bound on an H100 SXM: the bytes (`bytes_moved`), 28 an element in mode 0 and 40 in modes
1-2 (`csrc/adamp.cu`): 0.11 ms for the flagship's generator and 0.60 ms
for its discriminators at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

KERNEL = "adamp_step"
SOURCE = "hilcodec_tpu_torch/csrc/adamp.cu"
# launches of the kernel's passes, counted where they are launched
LAUNCHES: Dict[str, int] = {KERNEL: 0}
CHUNK = 4096        # elements of a work item at most (a row's slice)
LONG_ROW = 1024     # rows this long and longer are cut into slices
THREADS = 256       # threads a block (kThreads in csrc/adamp.cu)
ALIGN = 4           # floats: each leaf's offset in the flat outputs
# the static table's columns (the enums of csrc/adamp.cu)
NUMEL, OFF, ROWS, LEN, PBASE, NSL, RBASE, MODE = range(8)
LR_SCALE, WEIGHT_DECAY, THR_CH, THR_LY = range(4)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def bytes_moved(table: "LeafTable") -> int:
    """The least bytes of one call over `table`: p, g, m, v read and p', m',
    v' written, 28 an element; a leaf of mode 1-2 writes q in pass A and
    reads p and q again in pass B, 40 an element (`csrc/adamp.cu`)."""
    numel = table.leaves_i[:, NUMEL]
    return int(np.sum(np.where(table.leaves_i[:, MODE] > 0, 40, 28) * numel))


def leaf_mode(ndim: int, project_channel: bool, delta: float) -> int:
    """0: no projection (a leaf of ndim <= 1, or a gate that never opens:
    delta <= 0 makes both thresholds <= 0, under no |cosine|); 1: the
    channel projection, always; 2: the gate."""
    if project_channel:
        return 1
    return 2 if ndim > 1 and delta > 0 else 0


def lanes_per_row(length: int) -> int:
    """Lanes that take one short row together: a power of two, up to 32,
    so that each lane takes at most 8 elements of a row of up to 256."""
    per8 = max(1, -(-length // 8))
    return min(32, 1 << (per8 - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class LeafTable:
    """The static tables of one tree structure (numpy, for the CPU tests
    and the upload). leaves_i [n, 8] int64 (numel, offset, rows, row
    length, first partial, partials a row, first row coefficient, mode);
    leaves_f [n, 4] f32 (lr_scale, weight_decay, the channel and layer
    thresholds); items_a [nA, 5] int64 (leaf, kind, x, y, partial): kind 0
    the elements [x, x + y), kind G >= 1 the rows [x, x + y) at G lanes a
    row; rlist [nR] int32 the leaves of mode 1-2; items_b [nB, 3] int64
    (leaf, x, y) their elements; `total` floats of flat outputs,
    `partials` float4 and `rowcoefs` float2 of scratch."""
    shapes: Tuple[Tuple[int, ...], ...]
    leaves_i: np.ndarray
    leaves_f: np.ndarray
    items_a: np.ndarray
    rlist: np.ndarray
    items_b: np.ndarray
    total: int
    partials: int
    rowcoefs: int

    @property
    def views(self) -> List[Tuple[Tuple[int, ...], Tuple[int, ...], int]]:
        """(shape, contiguous strides, offset) of each leaf's view of the
        flat outputs."""
        out = []
        for shape, off in zip(self.shapes, self.leaves_i[:, OFF].tolist()):
            strides, acc = [], 1
            for d in reversed(shape):
                strides.append(acc)
                acc *= d
            out.append((shape, tuple(reversed(strides)), off))
        return out


def _chunks(leaf: int, start: int, count: int, kind: int,
            part: int) -> np.ndarray:
    """Items over the elements [start, start + count), CHUNK at most each,
    all writing partial `part` (-1: none)."""
    xs = np.arange(start, start + count, CHUNK, dtype=np.int64)
    ys = np.minimum(CHUNK, start + count - xs)
    return np.stack([np.full_like(xs, leaf), np.full_like(xs, kind), xs, ys,
                     np.full_like(xs, part)], axis=1)


def build_table(shapes: Sequence[Tuple[int, ...]],
                options: Sequence[Dict], delta: float) -> LeafTable:
    """The table of a tree whose leaves (in flatten order) have `shapes`
    and the regex-group `options` (project_channel, weight_decay,
    lr_scale: each leaf's resolved values)."""
    n = len(shapes)
    li = np.zeros((n, 8), np.int64)
    lf = np.zeros((n, 4), np.float32)
    items_a, items_b, rlist = [], [], []
    off = part = rbase = 0
    for k, (shape, opts) in enumerate(zip(shapes, options)):
        numel = int(np.prod(shape, dtype=np.int64))
        if numel >= 2 ** 31:
            raise ValueError(f"adamp_step: a leaf of {numel} elements")
        rows = int(shape[0]) if len(shape) else 1
        length = numel // rows if rows else 0
        mode = leaf_mode(len(shape), opts["project_channel"], delta)
        nsl = -(-length // CHUNK) if length >= LONG_ROW else 1
        li[k] = (numel, off, rows, length, part, nsl, rbase, mode)
        lf[k] = (opts["lr_scale"], opts["weight_decay"],
                 delta / math.sqrt(max(length, 1)),
                 delta / math.sqrt(max(numel, 1)))
        if numel == 0:
            continue
        if mode == 0:
            items_a.append(_chunks(k, 0, numel, 0, -1))
        elif length >= LONG_ROW:
            # a row's slice s is partial part + r * nsl + s
            starts = np.arange(0, length, CHUNK, dtype=np.int64)
            r = np.repeat(np.arange(rows, dtype=np.int64), nsl)
            s = np.tile(np.arange(nsl, dtype=np.int64), rows)
            xs = r * length + starts[s]
            ys = np.minimum(CHUNK, length - starts[s])
            items_a.append(np.stack([np.full_like(xs, k), np.zeros_like(xs),
                                     xs, ys, part + r * nsl + s], axis=1))
        else:
            lanes = lanes_per_row(length)
            turn = THREADS // lanes
            per = turn * max(1, CHUNK // (length * turn))
            xs = np.arange(0, rows, per, dtype=np.int64)
            ys = np.minimum(per, rows - xs)
            items_a.append(np.stack([np.full_like(xs, k),
                                     np.full_like(xs, lanes), xs, ys,
                                     part + xs], axis=1))
        if mode:
            rlist.append(k)
            items_b.append(_chunks(k, 0, numel, 0, -1)[:, [0, 2, 3]])
            part += rows * nsl
            rbase += rows
        off += -(-numel // ALIGN) * ALIGN
    cat = (lambda xs, w: np.concatenate(xs).astype(np.int64) if xs
           else np.zeros((0, w), np.int64))
    return LeafTable(shapes=tuple(tuple(int(d) for d in s) for s in shapes),
                     leaves_i=li, leaves_f=lf, items_a=cat(items_a, 5),
                     rlist=np.asarray(rlist, np.int32),
                     items_b=cat(items_b, 3), total=off, partials=part,
                     rowcoefs=rbase)


def dynamic_table(trees: Sequence[List[torch.Tensor]]) -> np.ndarray:
    """The per-call int64 table of the leaves' tensors (p, g, m, v, each a
    list in flatten order): [n, 4] data pointers, [n] layout indices (-1
    where all four are contiguous), and for each leaf with a tensor in
    another layout (cuDNN returns some convolutions' weight gradients
    channels-last) its shape padded to 4 dims and each tensor's 4 strides.
    ValueError for such a leaf of more than 4 dims."""
    n = len(trees[0])
    head = np.empty(5 * n, np.int64)
    for col, leaves in enumerate(trees):
        head[col:4 * n:4] = [t.data_ptr() for t in leaves]
    head[4 * n:] = -1
    layouts = []
    for k in range(n):
        ts = [leaves[k] for leaves in trees]
        if all(t.is_contiguous() for t in ts):
            continue
        pad = 4 - ts[0].dim()
        if pad < 0:
            raise ValueError(f"adamp_step: leaf {k} of {ts[0].dim()} dims "
                             f"in another layout; the kernel reads strides "
                             f"of up to 4 dims")
        entry = [1] * pad + list(ts[0].shape)
        for t in ts:
            entry += [0] * pad + list(t.stride())
        head[4 * n + k] = len(layouts)
        layouts.append(entry)
    return np.concatenate([head,
                           np.asarray(layouts, np.int64).reshape(-1)])


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("adamp")
            i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
            lib.adamp_step.argtypes = ([p, p, p, i, p, i, p, i, p, i]
                                       + [p] * 11 + [f] * 6 + [i, p])
            lib.adamp_step.restype = i
            _lib = lib
        return _lib


class DeviceTable:
    """A LeafTable's arrays on one device, uploaded once, and its views."""

    def __init__(self, table: LeafTable, device: torch.device):
        self.table = table
        self.device = device
        up = (lambda a: torch.from_numpy(np.ascontiguousarray(a))
              .to(device))
        self.leaves_i = up(table.leaves_i)
        self.leaves_f = up(table.leaves_f)
        self.items_a = up(table.items_a)
        self.rlist = up(table.rlist)
        self.items_b = up(table.items_b)
        self.views = table.views
        n = len(table.shapes)
        # scratch, in floats: q, the partials (float4), the row and leaf
        # coefficients (float2, float4), each part 16-byte aligned
        self.scratch_parts = (table.total, 4 * table.partials,
                              -(-2 * table.rowcoefs // 4) * 4, 4 * n)


def step(dt: DeviceTable, params: List[torch.Tensor],
         grads: List[torch.Tensor], exp_avg: List[torch.Tensor],
         exp_avg_sq: List[torch.Tensor], step_in: torch.Tensor,
         lr: torch.Tensor, commit: Optional[torch.Tensor],
         betas: Tuple[float, float], eps: float, wd_ratio: float,
         nesterov: bool) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                  List[torch.Tensor], torch.Tensor]:
    """Launch the kernel on leaves (flatten order, CUDA f32, each of its
    table's shape) and 0-d step (int32), lr (f32) and commit (bool, or
    None: always) on the table's device. Returns (params, exp_avg,
    exp_avg_sq) as views of three fresh flat buffers, and the new step.
    Nothing is read back to the host."""
    dev = dt.device
    table = dt.table
    host = dynamic_table((params, grads, exp_avg, exp_avg_sq))
    dyn = torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)
    outs = [torch.empty(table.total, dtype=torch.float32, device=dev)
            for _ in range(3)]
    scratch = torch.empty(sum(dt.scratch_parts), dtype=torch.float32,
                          device=dev)
    bases, at = [], scratch.data_ptr()
    for size in dt.scratch_parts:
        bases.append(at)
        at += 4 * size
    step_out = torch.empty((), dtype=torch.int32, device=dev)
    b1, b2 = betas
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.adamp_step(
            dt.leaves_i.data_ptr(), dt.leaves_f.data_ptr(),
            dt.items_a.data_ptr(), len(table.items_a),
            dt.rlist.data_ptr(), len(table.rlist), dt.items_b.data_ptr(),
            len(table.items_b), dyn.data_ptr(), len(params),
            *(buf.data_ptr() for buf in outs), *bases,
            step_in.data_ptr(), step_out.data_ptr(), lr.data_ptr(),
            None if commit is None else commit.data_ptr(), b1, 1 - b1, b2,
            1 - b2, eps, wd_ratio, int(nesterov),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adamp_step launch failed: CUDA error {rc}")
    LAUNCHES[KERNEL] += 1 + (2 if len(table.rlist) else 0)
    views = [[buf.as_strided(shape, strides, off)
              for shape, strides, off in dt.views] for buf in outs]
    return views[0], views[1], views[2], step_out
