"""Analytic FLOP and byte count of any function of the port, correct for
grouped and depthwise convolutions (counterpart of the JAX package's
`scripts/flops_analysis.py`, which walks a jaxpr).

The function runs once on `meta` tensors under a torch dispatch mode that
sees every aten operator it calls, forward and backward. The rules are the
JAX counter's:

  convolution:  2 * prod(out) * (Cin / groups) * prod(k)
  product:      2 * prod(batch + contracted + free dims)  (mm, bmm, addmm,
                baddbmm, mv, dot; the RVQ cascade `hilcodec::rvq_cascade`
                counts its distance products, 2 * M * K * C a stage, as
                the JAX cascade's dot_general does)
  anything else: prod(out), reported apart as an elementwise proxy
                (views and reductions counted the same way)

Bytes are the sum of operand and result sizes of every operator (an upper
bound on memory traffic, as in JAX). The backward of a convolution
(`convolution_backward`) counts one convolution for each gradient it
computes: the input's, the transposed convolution of the output gradient
(2 * prod(x) * (Cout / groups) * prod(k), so a strided convolution's
counts its zero-stuffed positions, as JAX's lhs-dilated gradient does),
and the weight's, which contracts x with the output gradient (the
forward's products). Both are grouped where the forward is
(torch.utils.flop_counter counts a grouped convolution's weight gradient
as a dense one).

Why meta tensors: the count has to be the same on the CPU as on the card,
and the port's convolutions take other routes for CPU tensors
(`ops/conv.py`: one convolution a group for a grouped one, `row_matmul`
over k-tap rows padded to ROW_BLOCK rows for a dense one, an overlap-add
for a dense transposed one). On `meta` tensors `ops/conv.py` takes the
card's branch (one `F.conv1d` / `F.conv_transpose1d`, one matmul) and no
arithmetic runs. The whole train step runs on meta tensors: it reads no
value on the host. The tools that run on the card count there, on the
CUDA tensors they time (the same branches, and faster to trace than meta
tensors, whose shape functions run in Python); a convolution or product
on CPU tensors raises.
A transposed convolution counts the outputs its caller keeps
(`ops/conv._convt_window`'s window: L * s samples in batch and in a
streaming step, the JAX lhs-dilated convolution's output), not the full
transposed convolution the card computes before the cut, so that the
count is the function's work, whatever implements it.

Usage:
  python -m hilcodec_tpu_torch.scripts.flops_analysis [bf16|f32] [batch]
Counts the train step of configs/hilcodec_speech_synth.yaml (default bf16,
batch 24) and prints JAX's JSON summary, with the card's floors in place
of the TPU's (`h100_floor_ms` at the dtype's peak: 989 TFLOP/s bf16, 67
TFLOP/s f32 on the CUDA cores, the parity mode's; `h100_hbm_floor_ms` at
3.35 TB/s), then the split by category, the top 15 convolutions and the
top 8 other operators by bytes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import conv as conv_ops

CONV = "convolution"
DOT = "dot"
META = torch.device("meta")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "hilcodec_speech_synth.yaml")

# published dense peaks of one card (NVIDIA's data sheet, SXM part, at its
# 700 W limit), looked up by a part of torch.cuda.get_device_name(): f32 on
# the CUDA cores (the parity mode, TF32 off), TF32 and bf16 on the tensor
# cores, and HBM bytes a second
PEAKS = {"h100": {"f32": 67e12, "tf32": 495e12, "bf16": 989e12,
                  "hbm": 3.35e12}}
H100 = PEAKS["h100"]

_aten = torch.ops.aten
# product operators: (index of the left operand, of the right one)
_PRODUCTS = {
    _aten.mm.default: (0, 1), _aten.bmm.default: (0, 1),
    _aten.addmm.default: (1, 2), _aten.baddbmm.default: (1, 2),
    _aten.mv.default: (0, 1), _aten.addmv.default: (1, 2),
    _aten.dot.default: (0, 1), _aten.vdot.default: (0, 1)}


class Row(NamedTuple):
    """One operator instance: the category (`CONV`, `DOT` or the aten
    operator's name), its FLOPs and bytes, a description, and for a
    convolution its kind (conv1d / conv2d, dense / grouped) and, for a
    forward one, its signature (`conv_signature`)."""
    prim: str
    flops: float
    bytes: float
    desc: str
    kind: str = ""
    sig: Optional[tuple] = None


def card_peaks(device) -> Optional[Dict[str, float]]:
    """The peaks of the card `device` is, by its name; None for a CPU or
    an unknown card (no MFU is printed for it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    return next((v for k, v in PEAKS.items() if k in name), None)


def peak_key(dtype: str) -> str:
    """The peak a dtype mode's arithmetic runs at: bf16 on the tensor
    cores for `bf16`; f32 on the CUDA cores otherwise (the parity mode
    turns TF32 off, and `bf16w` widens its bf16 weights to the f32
    activations)."""
    return "bf16" if dtype == "bf16" else "f32"


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of `tree`."""
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _conv_flops(out_shape, w_shape, transposed: bool, groups: int) -> int:
    """2 * prod(out) * (Cin / groups) * prod(k); a transposed weight is
    [Cin, Cout / groups, k...], a plain one [Cout, Cin / groups, k...]."""
    cin_g = w_shape[0] // groups if transposed else w_shape[1]
    return 2 * math.prod(out_shape) * cin_g * math.prod(w_shape[2:])


def _kind(w: torch.Tensor, groups: int) -> str:
    return (f"conv{w.dim() - 2}d_"
            + ("grouped" if groups > 1 else "dense"))


class OpCounter(TorchDispatchMode):
    """Counts every operator dispatched inside it into `rows`."""

    def __init__(self):
        super().__init__()
        self.rows: List[Row] = []
        self._kept: Optional[int] = None

    def __enter__(self):
        # a transposed convolution counts the window its caller keeps
        window = self._window = conv_ops._convt_window

        def kept_window(x, w, b, stride, dilation, groups, start, length):
            self._kept = length
            try:
                return window(x, w, b, stride, dilation, groups, start,
                              length)
            finally:
                self._kept = None
        conv_ops._convt_window = kept_window
        return super().__enter__()

    def __exit__(self, *exc):
        conv_ops._convt_window = self._window
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.rows.extend(self._rows(func, args, kwargs, out))
        return out

    @staticmethod
    def _off_cpu(func, tensors) -> None:
        for t in tensors:
            if t.device.type == "cpu":
                raise ValueError(
                    f"{func}: count on meta or CUDA tensors, not CPU ones: "
                    f"ops/conv.py takes other routes for CPU tensors")

    def _rows(self, func, args, kwargs, out) -> List[Row]:
        byts = tree_bytes((args, kwargs)) + tree_bytes(out)
        if func is _aten.convolution.default:
            x, w, _b, stride, padding, dilation, transposed, out_pad, \
                groups = args
            self._off_cpu(func, (x, w))
            shape = list(out.shape)
            if transposed and self._kept is not None:
                shape[-1] = self._kept
            sig = (tuple(x.shape), x.dtype, tuple(w.shape), w.dtype,
                   tuple(stride), tuple(padding), tuple(dilation),
                   bool(transposed), tuple(out_pad), groups)
            return [Row(CONV,
                        _conv_flops(shape, w.shape, transposed, groups),
                        byts, f"in{tuple(x.shape)} w{tuple(w.shape)} "
                        f"g={groups}{' T' if transposed else ''} -> "
                        f"{tuple(shape)}", _kind(w, groups), sig)]
        if func is _aten.convolution_backward.default:
            gy, x, w = args[:3]
            transposed, groups, mask = args[7], args[9], args[10]
            self._off_cpu(func, (gy, x, w))
            # dx is the transposed convolution of gy, counted at x's
            # shape; dw contracts x with gy, the forward's products. The
            # bytes are the operator's, split between its gradients.
            grads = [("dx", _conv_flops(x.shape, w.shape, not transposed,
                                        groups)),
                     ("dw", _conv_flops(gy.shape, w.shape, transposed,
                                        groups))]
            grads = [g for g, m in zip(grads, mask[:2]) if m]
            if not grads:               # the bias's gradient only
                return [Row("convolution_backward", 0, byts, "bias")]
            return [Row(CONV, flops, byts / len(grads),
                        f"backward {name} in{tuple(x.shape)} "
                        f"w{tuple(w.shape)} g={groups}"
                        f"{' T' if transposed else ''} <- {tuple(gy.shape)}",
                        _kind(w, groups)) for name, flops in grads]
        if func in _PRODUCTS:
            i, j = _PRODUCTS[func]
            a, b = args[i], args[j]
            self._off_cpu(func, (a, b))
            flops = 2 * max(out.numel(), 1) * a.shape[-1]
            return [Row(DOT, flops, byts,
                        f"{tuple(a.shape)} @ {tuple(b.shape)}")]
        if func is torch.ops.hilcodec.rvq_cascade.default:
            x, books, n = args
            self._off_cpu(func, (x, books))
            B, T, C = x.shape
            return [Row(DOT, 2 * B * T * books.shape[1] * C * n, byts,
                        f"rvq_cascade x{tuple(x.shape)} "
                        f"books{tuple(books.shape)} n={n}")]
        flops = sum(t.numel() for t in pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor))
        return [Row(func.__name__.split(".")[0], flops, byts,
                    " ".join(f"{tuple(t.shape)}:{str(t.dtype)[6:]}"
                             for t in pytree.tree_leaves(args)
                             if isinstance(t, torch.Tensor))[:120])]


def to_meta(tree):
    """`tree` with every tensor leaf as a meta tensor of its shape and
    dtype."""
    return pytree.tree_map(
        lambda t: t.to(META) if isinstance(t, torch.Tensor) else t, tree)


def analyze(fn, *args, **kwargs) -> List[Row]:
    """The rows of one call `fn(*args, **kwargs)` on meta (or CUDA)
    tensors."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.rows


def totals(rows: List[Row]) -> Dict[str, float]:
    """Convolution, product and elementwise FLOPs, bytes and the number of
    convolution instances."""
    conv = sum(r.flops for r in rows if r.prim == CONV)
    dot = sum(r.flops for r in rows if r.prim == DOT)
    return {"conv": conv, "dot": dot,
            "elem": sum(r.flops for r in rows) - conv - dot,
            "bytes": sum(r.bytes for r in rows),
            "n_conv": sum(1 for r in rows if r.prim == CONV)}


def conv_signatures(rows: List[Row]) -> Dict[tuple, List[float]]:
    """The forward convolutions of `rows` by signature (input shape and
    dtype, weight shape and dtype, stride, padding, dilation, transposed,
    output padding, groups): {signature: [instances, FLOPs of one]}."""
    sigs: Dict[tuple, List[float]] = {}
    for r in rows:
        if r.sig is not None:
            sigs.setdefault(r.sig, [0, r.flops])[0] += 1
    return sigs


def floor_ms(flops: float, peak: float) -> float:
    return flops / peak * 1e3


def train_step_rows(config: str, dtype: str, batch: int) -> List[Row]:
    """The rows of one train step of `config` at `batch` (compute dtype
    bf16 for `dtype == "bf16"`), traced on meta tensors from the seeded
    initial state and draws."""
    from ..train.loop import build_trainer
    from ..utils.hparams import load_config

    hps = load_config(config)
    trainer = build_trainer(hps, META)
    if dtype == "bf16":
        trainer = dataclasses.replace(trainer, compute_dtype=torch.bfloat16)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    seg = hps.data.get("segment_size", 24000)
    wav = torch.zeros((batch, 1, seg), device=META)
    draws = trainer.sample_draws(torch.Generator().manual_seed(1), wav.shape)
    return analyze(trainer.train_step, state, wav, draws)


def categories(rows: List[Row]) -> Dict[str, Dict[str, float]]:
    """Convolutions by kind: conv1d / conv2d, dense / grouped."""
    cats: Dict[str, List[float]] = {}
    for r in rows:
        if r.prim == CONV:
            c = cats.setdefault(r.kind, [0.0, 0.0, 0])
            c[0] += r.flops
            c[1] += r.bytes
            c[2] += 1
    return {k: {"tflop": round(v[0] / 1e12, 3), "gb": round(v[1] / 1e9, 2),
                "n": v[2]} for k, v in sorted(cats.items())}


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "bf16"
    batch = int(argv[1]) if len(argv) > 1 else 24
    if which not in ("bf16", "f32"):
        raise SystemExit(f"dtype must be bf16 or f32, got {which!r}")
    rows = train_step_rows(CONFIG, which, batch)
    t = totals(rows)
    print(json.dumps({
        "dtype": which, "batch": batch,
        "conv_tflop": round(t["conv"] / 1e12, 3),
        "dot_tflop": round(t["dot"] / 1e12, 3),
        "elementwise_gflop_proxy": round(t["elem"] / 1e9, 1),
        "n_conv_ops": t["n_conv"],
        "sum_operand_bytes_gb": round(t["bytes"] / 1e9, 2),
        "h100_floor_ms": round(floor_ms(t["conv"] + t["dot"],
                                        H100[peak_key(which)]), 2),
        "h100_hbm_floor_ms": round(floor_ms(t["bytes"], H100["hbm"]), 2),
    }))
    print(json.dumps(categories(rows)))
    for r in sorted((r for r in rows if r.prim == CONV),
                    key=lambda r: -r.flops)[:15]:
        print(f"{r.flops / 1e9:10.2f} GF {r.bytes / 1e6:9.1f} MB  {r.desc}")
    print("-- top non-conv by bytes --")
    for r in sorted((r for r in rows if r.prim != CONV),
                    key=lambda r: -r.bytes)[:8]:
        print(f"{r.flops / 1e9:10.2f} GF {r.bytes / 1e6:9.1f} MB  "
              f"{r.prim} {r.desc}")


if __name__ == "__main__":
    main()
