"""Weight reparameterization: weight norm and its deployment-time fold.

Counterpart of `hilcodec_tpu/ops/reparam.py` for the norm the flagship
configs use. A weight-normed conv holds `{v, g[, b]}` with
w = g * v / ||v||, the L2 norm taken per index of axis 0 over all other
axes (torch's `weight_norm(dim=0)`); `fold` turns it into `{w[, b]}`,
and `fold_tree` every such dict of a whole tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

ParamDict = Dict[str, Any]

WEIGHT_NORM = "weight_norm"
NONE = "none"


def weight_norm_init(w: torch.Tensor) -> ParamDict:
    """Split an initialized weight into {v, g} with w == g * v/||v||."""
    norm = torch.sqrt(torch.sum(w.float() ** 2, dim=tuple(range(1, w.ndim)),
                                keepdim=True))
    return {"v": w, "g": norm.to(w.dtype)}


def weight_norm_compute(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    v32 = v.float()
    norm = torch.sqrt(torch.sum(v32 ** 2, dim=tuple(range(1, v.ndim)),
                                keepdim=True))
    return (g.float() * v32 / norm).to(v.dtype)


def _check(norm: str) -> None:
    if norm not in (WEIGHT_NORM, NONE):
        raise NotImplementedError(
            f"norm {norm!r} is not ported yet (see ROADMAP.md)")


def torch_default_conv_init(gen: torch.Generator, shape: Tuple[int, ...],
                            with_bias: bool = True
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """torch Conv{1,2}d's default init drawn from `gen`: kaiming_uniform
    with a=sqrt(5), i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in)), for the
    weight and the bias."""
    bound = math.sqrt(1.0 / math.prod(shape[1:]))
    w = torch.empty(shape).uniform_(-bound, bound, generator=gen)
    b = (torch.empty(shape[0]).uniform_(-bound, bound, generator=gen)
         if with_bias else None)
    return w, b


def init_reparam(w: torch.Tensor, norm: str,
                 bias: Optional[torch.Tensor] = None) -> ParamDict:
    """Wrap an initialized raw weight into the parameterization for `norm`."""
    _check(norm)
    p = weight_norm_init(w) if norm == WEIGHT_NORM else {"w": w}
    if bias is not None:
        p["b"] = bias
    return p


def compute_weight(params: ParamDict, norm: str) -> torch.Tensor:
    """Effective convolution weight from a (possibly folded) dict."""
    if "w" in params:
        return params["w"]
    _check(norm)
    return weight_norm_compute(params["v"], params["g"])


def fold(params: ParamDict, norm: str) -> ParamDict:
    """Materialize the effective weight: {v, g[, b]} -> {w[, b]}."""
    out: ParamDict = {"w": compute_weight(params, norm)}
    if params.get("b") is not None:
        out["b"] = params["b"]
    return out


def fold_tree(params, norm: str = WEIGHT_NORM):
    """Fold every `{v, g[, b]}` conv dict of a param tree into `{w[, b]}`;
    every other node (the EnCodec LSTM's weights, say) passes through."""
    def walk(node):
        if isinstance(node, dict):
            if "v" in node and "g" in node:
                return fold(node, norm)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)
