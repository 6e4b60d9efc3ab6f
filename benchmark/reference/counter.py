"""Analytic FLOP and byte count of a function of the frozen reference.

A frozen copy of the port's `scripts/flops_analysis.py` counter, which
the benchmark keeps so that its yardstick does not move with the port.
It runs a function once on `meta` tensors under a torch dispatch mode
that sees every aten operator it calls, forward and backward, with the
JAX counter's rules:

  convolution:  2 * prod(out) * (Cin / groups) * prod(k)
  product:      2 * prod(batch + contracted + free dims)  (mm, bmm, addmm,
                baddbmm, mv, dot)
  anything else: prod(out), reported apart as an elementwise proxy

Bytes are the sum of operand and result sizes of every operator. A
convolution's backward counts one convolution for each gradient it
computes (the input's at the input's shape, zero-stuffed when strided;
the weight's as the forward's products, grouped). A transposed
convolution counts the window its caller keeps
(`frozen/ops/conv._convt_window`). The function counted is the frozen
reference's (`reference/frozen/`), never the port's: whatever implements
the work, the count stays the same. Differences from the copied counter:
the port's RVQ operator is not counted (the reference's cascade is plain
products, counted as such), and there is no command line.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .frozen.ops import conv as conv_ops

CONV = "convolution"
DOT = "dot"
META = torch.device("meta")

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
