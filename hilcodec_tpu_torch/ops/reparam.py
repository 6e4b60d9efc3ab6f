"""Weight reparameterization: weight norm, weight standardization,
spectral norm and the deployment-time fold.

Counterpart of `hilcodec_tpu/ops/reparam.py`. A weight-normed conv holds
`{v, g[, b]}` with w = g * v / ||v||, the L2 norm taken per index of axis
0 over all other axes (torch's `weight_norm(dim=0)`). A weight-standardized
conv holds `{v, g[, scale][, b]}` with w = (g * scale) * (v - mean) *
rsqrt(max(var * fan_in, 1e-7)), mean and (biased) var per index of axis 0,
in f32; `scale` is an optional constant. A spectrally normed
conv holds `{v, u[, b]}` with w = v / sigma(v), sigma estimated by one
power-iteration step on the 2-D reshape of v; `u` is a buffer (the
running left singular vector), detached in `compute` and advanced only by
`spectral_norm_power_iter`, which the train step calls once a step.
`fold` turns any of them into `{w[, b]}`, and `fold_tree` every such dict
of a whole tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

ParamDict = Dict[str, Any]

WEIGHT_NORM = "weight_norm"
WEIGHT_STANDARDIZATION = "weight_standardization"
SPECTRAL_NORM = "spectral_norm"
NONE = "none"
NORMS = (WEIGHT_NORM, WEIGHT_STANDARDIZATION, SPECTRAL_NORM, NONE)


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


def weight_standardization_init(w: torch.Tensor,
                                scale: Optional[float] = None,
                                zero_init: bool = False) -> ParamDict:
    """{v, g[, scale]}: g ones (zeros with zero_init) of shape [d0, 1, ...]."""
    g_shape = (w.shape[0],) + (1,) * (w.ndim - 1)
    g = (torch.zeros if zero_init else torch.ones)(g_shape, dtype=w.dtype)
    p: ParamDict = {"v": w, "g": g}
    if scale is not None:
        p["scale"] = torch.tensor(scale, dtype=w.dtype)
    return p


def weight_standardization_compute(v: torch.Tensor, g: torch.Tensor,
                                   scale: Optional[torch.Tensor] = None,
                                   eps: float = 1e-7) -> torch.Tensor:
    """(g * scale) * (v - mean) * rsqrt(max(var * fan_in, eps)) in f32,
    per index of axis 0; returned in v's dtype."""
    axes = tuple(range(1, v.ndim))
    v32 = v.float()
    mean = v32.mean(dim=axes, keepdim=True)
    var = ((v32 - mean) ** 2).mean(dim=axes, keepdim=True)
    w = (v32 - mean) * torch.rsqrt(
        torch.clamp(var * math.prod(v.shape[1:]), min=eps))
    gain = g.float()
    if scale is not None:
        gain = gain * scale.float()
    return (gain * w).to(v.dtype)


def spectral_norm_init(w: torch.Tensor, gen: torch.Generator) -> ParamDict:
    """{v, u}: u a unit N(0, 1) draw of w.shape[0] from `gen`."""
    u = torch.randn(w.shape[0], generator=gen)
    return {"v": w, "u": u / (torch.linalg.vector_norm(u) + 1e-12)}


def spectral_norm_compute(v: torch.Tensor, u: torch.Tensor,
                          eps: float = 1e-12) -> torch.Tensor:
    """v / sigma, sigma = u . (W vv) with vv = W^T u / ||W^T u||, W the
    [d0, -1] view of v in f32; u takes no gradient."""
    u = u.detach().float()
    w2 = v.float().reshape(v.shape[0], -1)
    vv = w2.T @ u
    vv = vv / (torch.linalg.vector_norm(vv) + eps)
    sigma = u @ (w2 @ vv)
    return (v.float() / sigma).to(v.dtype)


def spectral_norm_power_iter(v: torch.Tensor, u: torch.Tensor,
                             eps: float = 1e-12) -> torch.Tensor:
    """One power-iteration update of u, outside autograd."""
    with torch.no_grad():
        w2 = v.float().reshape(v.shape[0], -1)
        vv = w2.T @ u
        vv = vv / (torch.linalg.vector_norm(vv) + eps)
        u_new = w2 @ vv
        return u_new / (torch.linalg.vector_norm(u_new) + eps)


def _check(norm: str) -> None:
    if norm not in NORMS:
        raise ValueError(f"unknown norm {norm!r} (one of {', '.join(NORMS)})")


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
                 bias: Optional[torch.Tensor] = None,
                 gen: Optional[torch.Generator] = None) -> ParamDict:
    """Wrap an initialized raw weight into the parameterization for `norm`
    (spectral norm draws its u from `gen`)."""
    _check(norm)
    if norm == WEIGHT_NORM:
        p = weight_norm_init(w)
    elif norm == WEIGHT_STANDARDIZATION:
        p = weight_standardization_init(w)
    elif norm == SPECTRAL_NORM:
        p = spectral_norm_init(w, gen)
    else:
        p = {"w": w}
    if bias is not None:
        p["b"] = bias
    return p


def compute_weight(params: ParamDict, norm: str) -> torch.Tensor:
    """Effective convolution weight from a (possibly folded) dict."""
    if "w" in params:
        return params["w"]
    _check(norm)
    if norm == SPECTRAL_NORM:
        return spectral_norm_compute(params["v"], params["u"])
    if norm == WEIGHT_STANDARDIZATION:
        return weight_standardization_compute(params["v"], params["g"],
                                              params.get("scale"))
    return weight_norm_compute(params["v"], params["g"])


def fold(params: ParamDict, norm: str) -> ParamDict:
    """Materialize the effective weight: {v, g|u[, scale][, b]} ->
    {w[, b]}."""
    out: ParamDict = {"w": compute_weight(params, norm)}
    if params.get("b") is not None:
        out["b"] = params["b"]
    return out


def fold_tree(params, norm: str = WEIGHT_NORM):
    """Fold every `{v, g[, b]}` conv dict of a param tree (spectral norm
    by its `u`, weight standardization by its `scale` leaf, else `norm`)
    into `{w[, b]}`; every other node (the EnCodec LSTM's weights, say)
    passes through."""
    def walk(node):
        if isinstance(node, dict):
            if "v" in node and ("g" in node or "u" in node):
                return fold(node, SPECTRAL_NORM if "u" in node
                            else WEIGHT_STANDARDIZATION if "scale" in node
                            else norm)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)
