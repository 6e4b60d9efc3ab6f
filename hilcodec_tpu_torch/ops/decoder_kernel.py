"""The fused decoder frame step (and the shared segment executor).

Counterpart of `hilcodec_tpu/ops/pallas_decoder.py`: `Op`, `decoder_ops`,
`prepare_weights`, the plain segment executor `run_plain` (the plain
version of the kernel, `_segment_kernel` in PyTorch, time-major [B, T, C])
and the step class `DecoderMegakernel`. The CUDA C++ kernel is
`csrc/segment.cu`; its source note says what it replaces, what bounds it
and how it is built. `ops/encoder_kernel.py` drives the same kernel for the
encoder.

The TPU package packs the op list into segments whose weights fit a 6 MB
VMEM budget (`_pack_segments`) and picks a stream block that fits VMEM
(`_pick_stream_block`). Both were sized for VMEM and do not carry over: on
Hopper the weights are read through the 50 MB L2 and the activations live
in global scratch, so one launch runs every op of a frame step (one
segment) over all streams. The op list is lowered here to the kernel's
phase table (`build_phases`): act, scale and a residual pre-scale become
transforms on the next conv's input, res_end the epilogue of the conv
before it.

`step` runs the kernel for CUDA tensors and the plain version for CPU
tensors; a CUDA tensor launches the kernel or raises. Weights are taken
from the folded param tree only (unfolded params raise) and prepared once
per tree, not per frame.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

KERNEL = "decoder_frame"
SOURCE = "hilcodec_tpu_torch/csrc/segment.cu"
# launches of the kernel, counted where it is launched and nowhere else
LAUNCHES: Dict[str, int] = {KERNEL: 0}

ACTIVATIONS = ("ELU", "ReLU", "Tanh", "Identity")


def reset_launches() -> None:
    LAUNCHES[KERNEL] = 0


@dataclasses.dataclass
class Op:
    kind: str                 # pw | dw | convt | act | scale | res_begin
    #                           | res_end | post | dense1ch | mix | dws
    #                           | l2norm
    attrs: Dict[str, Any]
    cache_slot: Optional[int] = None   # index into the flat cache list
    atomic_group: int = -1             # resblock id


def check_supported(m, what: str) -> None:
    """The kernel's op set: identity skips, act_all off, ELU alpha 1."""
    if m.skip != "identity" or m.act_all:
        raise ValueError(f"{what} frame kernel needs identity skips and "
                         f"act_all=False")
    if (m.activation_params or {}).get("alpha", 1.0) != 1.0:
        raise ValueError(f"{what} frame kernel needs ELU alpha 1")
    if m.activation not in ACTIVATIONS:
        raise ValueError(f"{what} frame kernel has no {m.activation!r}")


def decoder_ops(dec) -> Tuple[List[Op], List[Tuple[int, int]], int]:
    """Flatten the Decoder spec into the op list.

    Returns (ops, cache_shapes [(L, C)...] in reference order, in_dim)."""
    check_supported(dec, "decoder")
    ops: List[Op] = []
    cache_shapes: List[Tuple[int, int]] = []
    group = 0
    c = int(2 ** len(dec.ratios)) * dec.n_filters
    ops.append(Op("pw", dict(path=("pre_pw",), cin=dec.dimension, cout=c)))
    k = dec.kernel_size
    cache_shapes.append((k - 1, c))
    ops.append(Op("dw", dict(path=("pre_dw",), k=k, d=1, c=c), cache_slot=0))

    for si, ratio in enumerate(dec.ratios):
        ops.append(Op("act", dict(name=dec.activation)))
        cache_shapes.append((1, c))
        ops.append(Op("convt", dict(path=("stages", si, "up_dw"), r=ratio,
                                    c=c), cache_slot=len(cache_shapes) - 1))
        ops.append(Op("pw", dict(path=("stages", si, "up_pw"), cin=c,
                                 cout=c // 2)))
        c //= 2
        kr = dec.residual_kernel_size
        for bi in range(dec.n_residual_layers):
            group += 1
            pre = ((1 + bi * dec.res_scale ** 2) ** -0.5
                   if dec.res_scale is not None else None)
            ops.append(Op("res_begin", dict(pre_scale=pre),
                          atomic_group=group))
            for di, d in enumerate((dec.dilation_base ** bi, 1)):
                base = ("stages", si, "blocks", bi, "blocks", di)
                ops.append(Op("act", dict(name=dec.activation),
                              atomic_group=group))
                ops.append(Op("pw", dict(path=base + ("pointwise",), cin=c,
                                         cout=c), atomic_group=group))
                cache_shapes.append((d * (kr - 1), c))
                ops.append(Op("dw", dict(path=base + ("depthwise",), k=kr,
                                         d=d, c=c),
                              cache_slot=len(cache_shapes) - 1,
                              atomic_group=group))
            ops.append(Op("res_end", dict(), atomic_group=group))
        if dec.res_scale is not None:
            ops.append(Op("scale", dict(
                s=(1 + dec.n_residual_layers * dec.res_scale ** 2) ** -0.5)))

    ops.append(Op("act", dict(name=dec.activation)))
    kp = dec.last_kernel_size
    cache_shapes.append((kp - 1, c))
    ops.append(Op("post", dict(path=("conv_post",), k=kp, c=c),
                  cache_slot=len(cache_shapes) - 1))
    if dec.final_activation:
        ops.append(Op("act", dict(name=dec.final_activation)))
    return ops, cache_shapes, dec.dimension


def op_shapes(ops: Sequence[Op], t: int, c: int
              ) -> List[Tuple[int, int, int, int]]:
    """(t_in, c_in, t_out, c_out) per stream of every op, from the input
    (t, c); the encoder's raw wav window is (k - 1 + hop*L, 1)."""
    out = []
    for op in ops:
        a = op.attrs
        t0, c0 = t, c
        if op.kind == "pw":
            c = a["cout"]
        elif op.kind == "convt":
            t = t * a["r"]
        elif op.kind == "post":
            c = 1
        elif op.kind == "dense1ch":
            t, c = t - (a["k"] - 1), a["c"]
        elif op.kind == "dws":
            t = t // a["s"]
        out.append((t0, c0, t, c))
    return out


# ---------------------------------------------------------------------------
# kernel-layout weights (once per param tree)
# ---------------------------------------------------------------------------

def _lookup(params: Dict[str, Any], path: Tuple) -> Dict[str, Any]:
    node: Any = params
    for p in path:
        node = node[p]
    return node


def _conv_params(params, op: Op) -> Dict[str, Any]:
    p = _lookup(params, op.attrs["path"])
    if op.kind == "mix":
        p = p["layer"]
    if "w" not in p:
        raise ValueError(
            f"the frame kernels take folded params (fold_params); "
            f"{'/'.join(map(str, op.attrs['path']))} is not folded")
    return p


def _layouts(op: Op, p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Kernel-layout tensors of one op: w (and w2 for convt), b."""
    w, b = p["w"].float(), p.get("b")
    if op.kind in ("pw", "mix"):
        out = {"w": w[:, :, 0].T}                         # [Cin, Cout]
    elif op.kind in ("dw", "dws", "dense1ch"):
        out = {"w": w[:, 0, :].T}                         # [k, C]
    elif op.kind == "convt":
        r = op.attrs["r"]
        out = {"w": w[:, 0, r:].T, "w2": w[:, 0, :r].T}   # wA, wB [r, C]
    else:  # post
        out = {"w": w[0].T}                               # [k, C]
        b = None if b is None else b[:1]
    if b is not None:
        out["b"] = b.float()
    return out


@dataclasses.dataclass
class Weights:
    """Packed kernel-layout weights of one param tree: `flat` holds every
    tensor at a 16-byte aligned offset; `per_op[i]` maps w / w2 / b to views
    of `flat` (None for an op without weights), `offsets[i]` to offsets."""
    flat: torch.Tensor
    per_op: List[Optional[Dict[str, torch.Tensor]]]
    offsets: List[Optional[Dict[str, int]]]


def prepare_weights(ops: Sequence[Op], params) -> Weights:
    """Kernel-layout weights for `ops` from a folded param tree."""
    layouts: List[Optional[Dict[str, torch.Tensor]]] = []
    for op in ops:
        if op.kind in ("pw", "mix", "dw", "dws", "dense1ch", "convt", "post"):
            layouts.append(_layouts(op, _conv_params(params, op)))
        else:
            layouts.append(None)
    offsets: List[Optional[Dict[str, int]]] = []
    pieces, pos = [], 0
    device = next(t for lay in layouts if lay for t in lay.values()).device
    for lay in layouts:
        if lay is None:
            offsets.append(None)
            continue
        offs = {}
        for name, tensor in lay.items():
            offs[name] = pos
            n = tensor.numel()
            pad = (-n) % 4
            pieces.append(tensor.reshape(-1))
            if pad:
                pieces.append(torch.zeros(pad, device=device))
            pos += n + pad
        offsets.append(offs)
    flat = torch.cat(pieces).contiguous()
    per_op = [None if offs is None else
              {name: flat[o:o + lay[name].numel()].view(lay[name].shape)
               for name, o in offs.items()}
              for lay, offs in zip(layouts, offsets)]
    return Weights(flat, per_op, offsets)


# ---------------------------------------------------------------------------
# the plain version: _segment_kernel op by op, time-major [B, T, C]
# ---------------------------------------------------------------------------

def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "ELU":
        return F.elu(x)
    if name == "ReLU":
        return torch.relu(x)
    if name == "Tanh":
        return torch.tanh(x)
    return x


def run_plain(ops: Sequence[Op], weights: Sequence[Optional[Dict]],
              x: torch.Tensor, aux: Sequence[torch.Tensor],
              caches: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The frame step of `ops` in plain PyTorch.

    x: [B, T, C], or the raw wav window [B, k-1+T] of a dense1ch op;
    aux: the mix ops' inputs [B, T_s, F]; caches: time-major [B, L, C] in
    slot order. Returns (y [B, T', C'], new caches)."""
    x = x.float()
    if x.ndim == 2:
        x = x[:, :, None]
    new: Dict[int, torch.Tensor] = {}
    ai = 0
    skip = None

    def with_cache(op):
        xc = torch.cat([caches[op.cache_slot].float(), x], dim=1)
        clen = caches[op.cache_slot].shape[1]
        new[op.cache_slot] = xc[:, xc.shape[1] - clen:]
        return xc

    for op, w in zip(ops, weights):
        a = op.attrs
        if op.kind == "act":
            x = _act(a["name"], x)
        elif op.kind == "scale":
            x = x * a["s"]
        elif op.kind == "res_begin":
            skip = x
            if a["pre_scale"] is not None:
                x = x * a["pre_scale"]
        elif op.kind == "res_end":
            x = x + skip
            skip = None
        elif op.kind in ("pw", "mix"):
            src = x
            if op.kind == "mix":
                src = aux[ai].float()
                ai += 1
            y = torch.matmul(src, w["w"])
            if "b" in w:
                y = y + w["b"]
            x = x + y if op.kind == "mix" else y
        elif op.kind == "dw":
            k, d = a["k"], a["d"]
            xc = with_cache(op)
            t = x.shape[1]
            y = None
            for j in range(k):
                term = xc[:, j * d:j * d + t, :] * w["w"][j]
                y = term if y is None else y + term
            x = y + w["b"] if "b" in w else y
        elif op.kind == "convt":
            r = a["r"]
            xc = with_cache(op)
            B, t, c = x.shape
            xa, xb = xc[:, :t, None, :], xc[:, 1:, None, :]
            y = (xa * w["w"][None, None] + xb * w["w2"][None, None]
                 ).reshape(B, t * r, c)            # [B, t, r, C] -> [B, tr, C]
            x = y + w["b"] if "b" in w else y
        elif op.kind == "post":
            k = a["k"]
            xc = with_cache(op)
            t = x.shape[1]
            y = None
            for j in range(k):
                term = torch.sum(xc[:, j:j + t, :] * w["w"][j], dim=-1)
                y = term if y is None else y + term
            y = y[:, :, None]
            x = y + w["b"] if "b" in w else y
        elif op.kind == "dense1ch":
            k = a["k"]
            t = x.shape[1] - (k - 1)
            y = None
            for j in range(k):
                term = x[:, j:j + t, :] * w["w"][j]
                y = term if y is None else y + term
            x = y + w["b"] if "b" in w else y
        elif op.kind == "dws":
            s = a["s"]
            xc = with_cache(op)
            B, tc, c = xc.shape
            tout = (tc - s) // s
            xr = xc.reshape(B, tc // s, s, c)
            y = None
            for j in range(s):
                term = (xr[:, :tout, j, :] * w["w"][j]
                        + xr[:, 1:tout + 1, j, :] * w["w"][s + j])
                y = term if y is None else y + term
            x = y + w["b"] if "b" in w else y
        elif op.kind == "l2norm":
            n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
            x = x / torch.clamp(n, min=a["eps"])
            if a["inout_norm"]:
                x = x * math.sqrt(a["c"])
        else:
            raise ValueError(op.kind)
    return x, [new[s] for s in range(len(caches))]


# ---------------------------------------------------------------------------
# the kernel's phase table
# ---------------------------------------------------------------------------

# phase kinds and transforms: the enums of csrc/segment.cu
EWISE, PW, DW, CONVT, POST, DENSE1CH, DWS, MIX, L2NORM = range(9)
UNARY = {"ELU": 1, "ReLU": 2, "Tanh": 3}
SCALE = 4
MAX_PRE = 4
MAX_AUX = 8
PHASE_DTYPE = np.dtype([
    ("kind", "<i4"), ("src", "<i4"), ("dst", "<i4"), ("res", "<i4"),
    ("aux", "<i4"), ("t_in", "<i4"), ("t_out", "<i4"), ("c_in", "<i4"),
    ("c_out", "<i4"), ("k", "<i4"), ("d", "<i4"), ("w", "<i4"),
    ("w2", "<i4"), ("bias", "<i4"), ("cache", "<i4"), ("cache_len", "<i4"),
    ("n_pre", "<i4"), ("pre_kind", "<i4", (MAX_PRE,)),
    ("pre_scale", "<f4", (MAX_PRE,)), ("eps", "<f4"), ("gain", "<f4"),
    ("bm", "<i4"), ("bn", "<i4"), ("splits", "<i4"), ("kslice", "<i4")])
assert PHASE_DTYPE.itemsize == 124
_CONV_KIND = {"pw": PW, "dw": DW, "convt": CONVT, "post": POST,
              "dense1ch": DENSE1CH, "dws": DWS}

# ---------------------------------------------------------------------------
# GEMM tiling: the tile shape and K-split of each 1x1-conv phase
# ---------------------------------------------------------------------------

BK = 32            # the kernel's k-block (kBK)
WARPS = 8          # warps of a block, all computing a tile
# the kernel's tiles (segment.cu SEGMENT_TILES): (BM, BN) -> the (WM, WN)
# part of it that one warp computes; the warps left over split each
# k-block's k8 steps
TILES = {(16, 64): (16, 32), (32, 32): (32, 16), (32, 64): (32, 32),
         (32, 96): (16, 48), (64, 64): (32, 32), (64, 96): (32, 24),
         (64, 128): (32, 32), (128, 64): (32, 32)}
MAX_SPLITS = 64
# Cost model of one work item (a tile's K-slice) on one block, in SM
# cycles; the two blocks of an SM share its L2 bandwidth and tensor cores.
# Coarse H100 figures: they rank the choices, they predict no time.
_ITEM_CYCLES = 2000.0       # pipeline fill, epilogue and barriers of an item
_L2_BYTES_PER_CYCLE = 16.0  # L2 -> shared memory, per block
_MMA_FLOPS_PER_CYCLE = 512.0  # TF32 tensor-core operations, per block
_ISSUE_PER_CYCLE = 2.0      # warp instructions, per block
_REDUCE_CYCLES = 1000.0     # fence and counter of a split tile


def _kblock_cycles(bm: int, bn: int) -> float:
    """One k-block of a bm x bn tile: the larger of its loads, its 3xTF32
    products and its instruction issue (per k8 step and warp: a load and
    four instructions of hi/lo split per fragment element, three mma.sync
    per fragment pair; each warp takes 1 / k_warps of the k8 steps)."""
    wm, wn = TILES[(bm, bn)]
    mt, nt = wm // 16, wn // 8
    k_warps = WARPS // ((bm // wm) * (bn // wn))
    loads = (bm + bn) * BK * 4 / _L2_BYTES_PER_CYCLE
    mma = 3 * 2 * bm * bn * BK / _MMA_FLOPS_PER_CYCLE
    issue = WARPS * (BK // 8 // k_warps) * (20 * mt + 10 * nt + 3 * mt * nt) \
        / _ISSUE_PER_CYCLE
    return max(loads, mma, issue)


def gemm_tiling(M: int, N: int, K: int, grid: int
                ) -> Tuple[int, int, int, int]:
    """(bm, bn, splits, kslice) for an [M, K] x [K, N] phase on a grid of
    `grid` blocks: the tile and K-split whose items (tiles x splits) take
    the fewest estimated cycles over the grid. Slice s covers K columns
    [s * kslice, min(K, (s + 1) * kslice)); kslice is a multiple of BK and
    every slice is non-empty."""
    kblocks = -(-K // BK)
    best = None
    for bm, bn in TILES:
        tiles = -(-M // bm) * -(-N // bn)
        per_kb = _kblock_cycles(bm, bn)
        for splits in range(1, min(kblocks, MAX_SPLITS) + 1):
            kc = -(-kblocks // splits)
            if -(-kblocks // kc) != splits:
                continue           # the same slices as fewer splits
            item = _ITEM_CYCLES + kc * per_kb
            if splits > 1:
                item += (_REDUCE_CYCLES + bm * bn * 4 * (splits + 1)
                         / _L2_BYTES_PER_CYCLE)
            cost = -(-tiles * splits // grid) * item
            key = (cost, splits, -bm * bn)
            if best is None or key < best[0]:
                best = (key, (bm, bn, splits, kc * BK))
    return best[1]


def split_workspace(table: np.ndarray, B: int) -> Tuple[int, int]:
    """(floats of the split-K workspace, counters) that the GEMM phases of
    `table` need at B streams: a bm x bn partial per item of a split phase,
    a counter per tile."""
    ws, counters = 0, 0
    for p in table:
        if int(p["kind"]) in (PW, MIX) and int(p["splits"]) > 1:
            bm, bn, s = int(p["bm"]), int(p["bn"]), int(p["splits"])
            tiles = -(-B * int(p["t_in"]) // bm) * -(-int(p["c_out"]) // bn)
            ws = max(ws, tiles * s * bm * bn)
            counters = max(counters, tiles)
    return ws, counters


def cache_layout(cache_shapes: Sequence[Tuple[int, int]], B: int
                 ) -> Tuple[List[int], int]:
    """Offsets (floats) of each slot's [B, L, C] block in the packed cache
    buffer, and its total size."""
    offs, pos = [], 0
    for L, C in cache_shapes:
        offs.append(pos)
        pos += B * L * C
    return offs, pos


def build_phases(ops: Sequence[Op], offsets: Sequence[Optional[Dict]],
                 cache_shapes: Sequence[Tuple[int, int]], B: int, t: int,
                 c: int, grid: int) -> Tuple[np.ndarray, int]:
    """Lower the op list to the kernel's phase table for B streams of input
    (t, c) per stream on a grid of `grid` blocks. Returns (phases, the
    largest activation of a stream in floats, which sizes each of the three
    scratch buffers).

    Buffers: -1 is the step's input (as a source) or output (the last
    phase's destination), 0..2 scratch. Each phase writes a buffer that is
    neither its source nor the live residual, except where an output
    element reads only its own position there (a residual add, the mix).
    Each GEMM phase (pw, mix) gets its tile and K-split (`gemm_tiling`)."""
    cache_offs, _ = cache_layout(cache_shapes, B)
    phases: List[Dict[str, Any]] = []
    pending: List[Tuple[int, float]] = []
    cur, skip = -1, None
    act_max = 0
    aux_i = 0

    def free(*busy):
        return next(i for i in range(3) if i not in busy)

    def emit(kind, src, dst, t_in, c_in, t_out, c_out, **kw):
        nonlocal act_max
        if len(pending) > MAX_PRE:
            raise ValueError(f"more than {MAX_PRE} transforms before a conv")
        ph = dict(kind=kind, src=src, dst=dst, res=-1, aux=-1, t_in=t_in,
                  t_out=t_out, c_in=c_in, c_out=c_out, k=0, d=0, w=-1, w2=-1,
                  bias=-1, cache=-1, cache_len=0, pre=list(pending), eps=0.0,
                  gain=1.0, bm=0, bn=0, splits=0, kslice=0)
        ph.update(kw)
        if kind in (PW, MIX):
            ph.update(zip(("bm", "bn", "splits", "kslice"),
                          gemm_tiling(B * t_in, c_out, c_in, grid)))
        pending.clear()
        phases.append(ph)
        act_max = max(act_max, t_out * c_out)

    def materialize(res=-1, dst=None):
        nonlocal cur
        if dst is None:
            dst = free(cur, -1 if skip is None else skip)
        emit(EWISE, cur, dst, t, c, t, c, res=res)
        cur = dst

    for op, (t_in, c_in, t_out, c_out), offs in zip(
            ops, op_shapes(ops, t, c), offsets):
        a = op.attrs
        if op.kind == "act":
            if a["name"] not in ACTIVATIONS:
                raise ValueError(f"no activation {a['name']!r} in the kernel")
            if a["name"] != "Identity":
                pending.append((UNARY[a["name"]], 0.0))
            continue
        if op.kind == "scale":
            pending.append((SCALE, a["s"]))
            continue
        if op.kind == "res_begin":
            if pending:
                materialize()
            skip = cur
            if a["pre_scale"] is not None:
                pending.append((SCALE, a["pre_scale"]))
            continue
        if op.kind == "res_end":
            last = phases[-1] if phases else None
            if (pending or last is None or last["kind"] not in (PW, DW)
                    or last["dst"] != cur or last["src"] == skip):
                materialize(res=skip, dst=skip)
            else:
                last["res"] = last["dst"] = cur = skip
            skip = None
            continue
        busy = (cur, -1 if skip is None else skip)
        w = offs or {}
        common = dict(w=w.get("w", -1), w2=w.get("w2", -1),
                      bias=w.get("b", -1))
        if op.kind == "mix":
            if pending:
                materialize()
            if cur < 0:
                raise ValueError("a mix op needs a conv before it")
            if aux_i >= MAX_AUX:
                raise ValueError(f"more than {MAX_AUX} aux inputs")
            emit(MIX, cur, cur, t_in, a["f"], t_out, a["cout"], res=cur,
                 aux=aux_i, **common)
            aux_i += 1
            continue
        if op.kind == "l2norm":
            dst = free(*busy)
            emit(L2NORM, cur, dst, t_in, c_in, t_out, c_out, eps=a["eps"],
                 gain=float(np.float32(math.sqrt(a["c"])))
                 if a["inout_norm"] else 1.0)
            cur = dst
            t, c = t_out, c_out
            continue
        if op.kind == "dense1ch" and (pending or cur != -1):
            raise ValueError("dense1ch must read the raw wav window")
        kw = dict(common)
        if op.cache_slot is not None:
            L, C = cache_shapes[op.cache_slot]
            if C != c_in:
                raise ValueError(f"cache slot {op.cache_slot} has {C} "
                                 f"channels, the op {c_in}")
            kw.update(cache=cache_offs[op.cache_slot], cache_len=L)
        if op.kind in ("dw", "post", "dense1ch"):
            kw.update(k=a["k"], d=a.get("d", 1))
        elif op.kind == "convt":
            kw.update(k=2 * a["r"], d=a["r"])
            if kw["cache_len"] != 1:
                raise ValueError("convt needs a one-frame cache (k = 2r)")
        elif op.kind == "dws":
            if a["k"] != 2 * a["s"]:
                raise ValueError("dws needs k = 2s")
            kw.update(k=a["k"], d=a["s"])
        dst = free(*busy)
        emit(_CONV_KIND[op.kind], cur, dst, t_in, c_in, t_out, c_out, **kw)
        cur = dst
        t, c = t_out, c_out
    if skip is not None:
        raise ValueError("res_begin without res_end")
    if pending or not phases:
        materialize()
    phases[-1]["dst"] = -1

    table = np.zeros(len(phases), PHASE_DTYPE)
    for i, ph in enumerate(phases):
        pre = ph.pop("pre")
        for name, val in ph.items():
            table[name][i] = val
        table["n_pre"][i] = len(pre)
        for j, (kind, s) in enumerate(pre):
            table["pre_kind"][i, j] = kind
            table["pre_scale"][i, j] = s
    return table, act_max


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_grid: Dict[int, int] = {}   # device index -> blocks of the persistent grid


def _library(device: torch.device) -> Tuple[ctypes.CDLL, int]:
    """The built kernel library and the grid size on `device` (the current
    device), queried once per device."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("segment")
            p = ctypes.c_void_p
            lib.segment_run.argtypes = [
                p, ctypes.c_int, p, p, p, p, p, p, p, p, p, ctypes.c_int,
                p, p, ctypes.c_int, ctypes.c_int, p]
            lib.segment_run.restype = ctypes.c_int
            lib.segment_grid.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.segment_grid.restype = ctypes.c_int
            _lib = lib
        if device.index not in _grid:
            blocks = ctypes.c_int(0)
            rc = _lib.segment_grid(ctypes.byref(blocks))
            if rc != 0:
                raise RuntimeError(f"segment_grid failed on {device}: CUDA "
                                   f"error {rc} (cooperative launch needed)")
            _grid[device.index] = blocks.value
        return _lib, _grid[device.index]


@dataclasses.dataclass
class Plan:
    """The phase table of one (batch, frames, device, stream) on the device,
    with the buffers its launches share: three scratch buffers for the
    activations (rows 16-byte aligned), the split-K workspace and the
    per-tile counters (zero, and left zero by every launch). Launches of one
    plan run one after another on its stream."""
    phases: torch.Tensor
    n_phases: int
    act_max: int
    bufs: torch.Tensor
    ws: torch.Tensor
    counters: torch.Tensor


def make_plan(table: np.ndarray, act_max: int, B: int,
              device: torch.device) -> Plan:
    """Upload `table` and allocate the buffers its launches need."""
    if B * act_max >= 2 ** 31:
        raise ValueError("frame kernel: an activation of 2^31 floats or "
                         "more (32-bit indices)")
    ws, counters = split_workspace(table, B)
    stride = -(-max(B * act_max, 1) // 64) * 64
    return Plan(
        torch.from_numpy(table.view(np.int32)).to(device), len(table),
        act_max, torch.empty((3, stride), dtype=torch.float32, device=device),
        torch.empty(max(ws, 1), dtype=torch.float32, device=device),
        torch.zeros(max(counters, 1), dtype=torch.int32, device=device))


def _check(t: torch.Tensor, device: torch.device, name: str) -> None:
    if t.device != device or t.dtype != torch.float32 or \
            not t.is_contiguous():
        raise ValueError(f"frame kernel: {name} must be contiguous float32 "
                         f"on {device}, got {t.dtype} on {t.device}")


def launch(kernel: str, counter: Dict[str, int], plan: Plan,
           weights: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           aux: Sequence[torch.Tensor], cache_in: torch.Tensor,
           cache_out: torch.Tensor, B: int) -> None:
    """Launch the segment kernel for one frame step on the current stream;
    raises if the launch is refused."""
    device = x.device
    for name, t in (("x", x), ("y", y), ("weights", weights),
                    ("cache_in", cache_in), ("cache_out", cache_out)):
        _check(t, device, name)
    for t in aux:
        _check(t, device, "aux")
    if len(aux) > MAX_AUX:
        raise ValueError(f"frame kernel takes at most {MAX_AUX} aux inputs")
    if cache_in.data_ptr() == cache_out.data_ptr() and cache_in.numel():
        raise ValueError("frame kernel: cache_in and cache_out must differ")
    aux_ptrs = (ctypes.c_void_p * MAX_AUX)(
        *[t.data_ptr() for t in aux], *([None] * (MAX_AUX - len(aux))))
    bufs = plan.bufs
    with torch.cuda.device(device):
        lib, blocks = _library(device)
        rc = lib.segment_run(
            plan.phases.data_ptr(), plan.n_phases, x.data_ptr(),
            y.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            bufs[2].data_ptr(), cache_in.data_ptr(), cache_out.data_ptr(),
            weights.data_ptr(), aux_ptrs, len(aux), plan.ws.data_ptr(),
            plan.counters.data_ptr(), B, blocks,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    counter[kernel] += 1


# ---------------------------------------------------------------------------
# frame steps
# ---------------------------------------------------------------------------

class FrameKernel:
    """Shared base of the frame steps: one kernel over an op list whose caches
    are time-major [B, L, C] in the reference flat order.

    Time-major caches made here (`init_cache`, `cache_to_time_major`) and
    those a step returns are views of one packed buffer, which the kernel
    reads whole; other cache lists are packed on entry."""
    kernel = ""
    launches: Dict[str, int] = {}

    def __init__(self, ops: List[Op], cache_shapes: List[Tuple[int, int]]):
        self.ops = ops
        self.cache_shapes = cache_shapes
        self._lock = threading.Lock()
        self._weights: Dict[int, Tuple[Any, List, Weights]] = {}
        self._plans: Dict[Tuple, Plan] = {}

    # -- caches -------------------------------------------------------------
    def unpack(self, flat: torch.Tensor, B: int) -> List[torch.Tensor]:
        offs, _ = cache_layout(self.cache_shapes, B)
        return [flat[o:o + B * L * C].view(B, L, C)
                for o, (L, C) in zip(offs, self.cache_shapes)]

    def pack(self, caches: Sequence[torch.Tensor], B: int) -> torch.Tensor:
        """The packed buffer that `caches` are views of, or a packed copy."""
        offs, total = cache_layout(self.cache_shapes, B)
        if len(caches) != len(self.cache_shapes):
            raise ValueError(f"{len(caches)} caches, expected "
                             f"{len(self.cache_shapes)}")
        for c, (L, C) in zip(caches, self.cache_shapes):
            if tuple(c.shape) != (B, L, C):
                raise ValueError(f"cache of shape {tuple(c.shape)}, expected "
                                 f"{(B, L, C)}")
        first = caches[0]
        if all(c.is_contiguous() and c.dtype == first.dtype
               and c.untyped_storage().data_ptr()
               == first.untyped_storage().data_ptr()
               and c.storage_offset() == first.storage_offset() + o
               for c, o in zip(caches, offs)):
            return first.as_strided((total,), (1,), first.storage_offset())
        return torch.cat([c.reshape(-1) for c in caches])

    def _zeros(self, batch: int, dtype, device) -> List[torch.Tensor]:
        _, total = cache_layout(self.cache_shapes, batch)
        return self.unpack(torch.zeros(total, dtype=dtype, device=device),
                           batch)

    def _to_time_major(self, caches: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        if not caches:
            return []
        B = caches[0].shape[0]
        return self.unpack(self.pack([c.transpose(1, 2) for c in caches], B),
                           B)

    # -- weights and plans ---------------------------------------------------
    def _leaves(self, params) -> List[torch.Tensor]:
        out = []
        for op in self.ops:
            if "path" in op.attrs:
                p = _conv_params(params, op)
                out += [p["w"]] + ([p["b"]] if p.get("b") is not None else [])
        return out

    def weights(self, params) -> Weights:
        """Kernel-layout weights of `params`, made once per param tree (and
        again when a leaf is replaced or changed in place)."""
        leaves = self._leaves(params)
        with self._lock:
            hit = self._weights.get(id(params))
            if (hit is not None and hit[0] is params
                    and len(hit[1]) == len(leaves)
                    and all(a is b and a._version == v
                            for (a, v), b in zip(hit[1], leaves))):
                return hit[2]
        w = prepare_weights(self.ops, params)
        with self._lock:
            if len(self._weights) >= 4:
                self._weights.pop(next(iter(self._weights)))
            self._weights[id(params)] = (
                params, [(t, t._version) for t in leaves], w)
        return w

    def plan(self, w: Weights, B: int, t: int, c: int,
             device: torch.device) -> Plan:
        """The phase table and buffers for B streams of input (t, c) on the
        current stream of `device`, made once; tiled for the device's
        grid."""
        stream = torch.cuda.current_stream(device).cuda_stream
        key = (B, t, c, device, stream)
        with self._lock:
            plan = self._plans.get(key)
        if plan is None:
            with torch.cuda.device(device):
                _, grid = _library(device)
            table, act_max = build_phases(self.ops, w.offsets,
                                          self.cache_shapes, B, t, c, grid)
            plan = make_plan(table, act_max, B, device)
            with self._lock:
                self._plans[key] = plan
        return plan

    def run(self, params, x: torch.Tensor, aux: Sequence[torch.Tensor],
            caches: Sequence[torch.Tensor]
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One frame step over the op list: the kernel for CUDA tensors,
        the plain version for CPU tensors.

        x: [B, T, C] (or the raw [B, k-1+T] wav window); aux: [B, T_s, F];
        caches: time-major in slot order. Returns (y [B, T', C'], caches)."""
        w = self.weights(params)
        if x.device.type == "cpu":
            return run_plain(self.ops, w.per_op, x, aux, caches)
        B = x.shape[0]
        t, c = (x.shape[1], 1) if x.ndim == 2 else (x.shape[1], x.shape[2])
        plan = self.plan(w, B, t, c, x.device)
        t_out, c_out = op_shapes(self.ops, t, c)[-1][2:]
        cache_in = self.pack(caches, B)
        cache_out = torch.empty_like(cache_in)
        y = torch.empty((B, t_out, c_out), dtype=torch.float32,
                        device=x.device)
        launch(self.kernel, self.launches, plan, w.flat,
               x.float().contiguous(), y, [a.float().contiguous()
                                           for a in aux],
               cache_in, cache_out, B)
        return y, self.unpack(cache_out, B)


class DecoderMegakernel(FrameKernel):
    """Fused streaming decoder step. `step(folded_params, cache_tm, q)`;
    caches are time-major ([B, L, C]) in the reference flat order (convert
    with `cache_to_time_major`)."""
    kernel = KERNEL
    launches = LAUNCHES

    def __init__(self, dec):
        ops, cache_shapes, in_dim = decoder_ops(dec)
        super().__init__(ops, cache_shapes)
        self.dec = dec
        self.in_dim = in_dim

    def cache_to_time_major(self, cache: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
        return self._to_time_major(cache)

    def cache_from_time_major(self, cache: Sequence[torch.Tensor]
                              ) -> List[torch.Tensor]:
        return [c.transpose(1, 2) for c in cache]

    def init_cache(self, batch: int, dtype=torch.float32, device="cpu"
                   ) -> List[torch.Tensor]:
        return self._zeros(batch, dtype, device)

    def step(self, params, cache: Sequence[torch.Tensor], q: torch.Tensor
             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """q: [B, dim, L] latent frames -> (wav [B, 1, L*hop], new_cache)."""
        y, cache = self.run(params, q.transpose(1, 2), [], cache)
        return y.transpose(1, 2), cache
