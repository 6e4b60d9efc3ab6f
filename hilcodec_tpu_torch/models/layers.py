"""Codec building blocks: one layer spec -> batched `apply` + streaming `step`.

Counterpart of `hilcodec_tpu/models/layers.py`. Each block is a frozen
config object whose methods are plain functions of a parameter dict and
tensors:
  * activations `[B, C, T]`; parameters are nested dicts of f32 tensors
    named as in the JAX tree;
  * `init(gen) -> params` draws from a `torch.Generator` (on the CPU);
  * `init_cache(batch, ...) -> [tensors]` is the flat cache list in the
    reference order, and `step(params, cache, x)` consumes/returns it;
  * `fold(params)` is the deployment fold (weight norm removed, static
    scales merged). Folded params are told apart by structure: `"w"` in a
    conv dict, and no `res_scale_param` / `scale_param` left.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import conv as C
from ..ops import reparam as R
from ..ops import stft as S

Params = Dict[str, Any]
Cache = List[torch.Tensor]


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

_ACTS = {
    "ELU": F.elu,
    "ReLU": F.relu,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    # jax.nn.gelu defaults to the tanh approximation
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "SiLU": F.silu,
    "Tanh": torch.tanh,
    "Identity": lambda x: x,
}


def activation(name: str, params: Optional[dict] = None):
    if name == "LeakyReLU" and params and "negative_slope" in params:
        slope = params["negative_slope"]
        return lambda x: F.leaky_relu(x, slope)
    if name == "ELU" and params and params.get("alpha", 1.0) != 1.0:
        alpha = params["alpha"]
        return lambda x: torch.where(x > 0, x, alpha * torch.expm1(x))
    return _ACTS[name]


def kaiming_normal(gen: torch.Generator, shape: Tuple[int, ...], fan_in: int,
                   nonlinearity: str = "linear") -> torch.Tensor:
    """torch.nn.init.kaiming_normal_ (mode=fan_in)."""
    gain = math.sqrt(2.0) if nonlinearity == "relu" else 1.0
    return torch.randn(shape, generator=gen) * (gain / math.sqrt(fan_in))


def scale_as(x: torch.Tensor, s: float) -> torch.Tensor:
    """x * s with s first rounded to x's dtype, as the JAX package's
    `x * jnp.asarray(s, x.dtype)` (exact in f32; in bf16 the product of
    two bf16 values rounded once)."""
    if x.dtype != torch.float32:
        s = float(torch.tensor(s, dtype=x.dtype))
    return x * s


def _zeros_cache(batch, channels, length, dtype, device) -> Cache:
    return [torch.zeros((batch, channels, length), dtype=dtype,
                        device=device)]


# ---------------------------------------------------------------------------
# Conv / ConvTranspose layers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Conv1d:
    """Causal conv1d with weight norm (SConv1d): kaiming init, zero bias."""
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True
    norm: str = R.WEIGHT_NORM
    nonlinearity: str = "linear"
    pad_mode: str = "constant"   # "reflect": the EnCodec family's default

    def init(self, gen: torch.Generator) -> Params:
        fan_in = self.in_channels // self.groups * self.kernel_size
        w = kaiming_normal(gen, (self.out_channels,
                                 self.in_channels // self.groups,
                                 self.kernel_size), fan_in, self.nonlinearity)
        b = torch.zeros(self.out_channels) if self.bias else None
        return R.init_reparam(w, self.norm, bias=b)

    def weight(self, params: Params) -> torch.Tensor:
        return R.compute_weight(params, self.norm)

    @property
    def cache_len(self) -> int:
        if self.kernel_size == 1:
            return 0
        return C.causal_conv1d_cache_len(self.kernel_size, self.stride,
                                         self.dilation)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight(params), params.get("b")
        if self.kernel_size > 1:
            return C.causal_conv1d(x, w, b, self.stride, self.dilation,
                                   self.groups, pad_mode=self.pad_mode)
        return C.conv1d(x, w, b, self.stride, self.dilation, self.groups)

    def apply_nopad(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Valid conv, no padding: the history arrives in-band (conv_pre
        on the shared wav ring)."""
        return C.conv1d(x, self.weight(params), params.get("b"),
                        self.stride, self.dilation, self.groups)

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        if self.cache_len == 0:
            return []
        return _zeros_cache(batch, self.in_channels, self.cache_len, dtype,
                            device)

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        w, b = self.weight(params), params.get("b")
        if self.cache_len == 0:
            return C.conv1d(x, w, b, self.stride, self.dilation,
                            self.groups), []
        y, new = C.causal_conv1d_step(x, cache[0], w, b, self.stride,
                                      self.dilation, self.groups)
        return y, [new]

    def fold(self, params: Params) -> Params:
        return R.fold(params, self.norm)


@dataclasses.dataclass(frozen=True)
class ConvTranspose1d:
    """Causal transposed conv (SConvTranspose1d) with weight norm."""
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True
    norm: str = R.WEIGHT_NORM
    nonlinearity: str = "linear"

    def init(self, gen: torch.Generator) -> Params:
        # torch ConvTranspose1d weight [in, out/groups, k]; fan_in is
        # (out/groups) * k as torch._calculate_fan_in_and_fan_out has it
        fan_in = self.out_channels // self.groups * self.kernel_size
        w = kaiming_normal(gen, (self.in_channels,
                                 self.out_channels // self.groups,
                                 self.kernel_size), fan_in, self.nonlinearity)
        b = torch.zeros(self.out_channels) if self.bias else None
        return R.init_reparam(w, self.norm, bias=b)

    def weight(self, params: Params) -> torch.Tensor:
        return R.compute_weight(params, self.norm)

    @property
    def cache_len(self) -> int:
        return C.causal_conv_transpose1d_cache_len(
            self.kernel_size, self.stride, self.dilation)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return C.causal_conv_transpose1d(
            x, self.weight(params), params.get("b"), self.stride,
            self.dilation, self.groups)

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        return _zeros_cache(batch, self.in_channels, self.cache_len, dtype,
                            device)

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        y, new = C.causal_conv_transpose1d_step(
            x, cache[0], self.weight(params), params.get("b"), self.stride,
            self.dilation, self.groups)
        return y, [new]

    def fold(self, params: Params) -> Params:
        return R.fold(params, self.norm)


# ---------------------------------------------------------------------------
# DWS block: act -> pointwise 1x1 -> (act) -> depthwise k
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DWSBlock:
    """Depthwise-separable unit (seanet.py dws_conv_block)."""
    act: str
    act_params: Optional[dict]
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    norm: str = R.WEIGHT_NORM
    act_all: bool = False
    expansion: int = 1
    groups: int = -1
    bias: bool = True

    def __post_init__(self):
        g = self.groups
        if g == -1:
            g = self.out_channels // self.expansion
        object.__setattr__(self, "_act", activation(self.act, self.act_params))
        object.__setattr__(self, "pointwise", Conv1d(
            self.in_channels, self.out_channels, 1,
            bias=self.bias if self.act_all else False, norm=self.norm,
            nonlinearity="relu"))
        object.__setattr__(self, "depthwise", Conv1d(
            self.out_channels, self.out_channels, self.kernel_size,
            self.stride, self.dilation, groups=g, norm=self.norm,
            bias=self.bias,
            nonlinearity="relu" if self.act_all else "linear"))

    def init(self, gen: torch.Generator) -> Params:
        return {"pointwise": self.pointwise.init(gen),
                "depthwise": self.depthwise.init(gen)}

    def _pw(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = self.pointwise.apply(params["pointwise"], self._act(x))
        return self._act(x) if self.act_all else x

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.depthwise.apply(params["depthwise"], self._pw(params, x))

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        return self.depthwise.init_cache(batch, dtype, device)

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        return self.depthwise.step(params["depthwise"], cache,
                                   self._pw(params, x))

    def fold(self, params: Params) -> Params:
        return {"pointwise": self.pointwise.fold(params["pointwise"]),
                "depthwise": self.depthwise.fold(params["depthwise"])}


# ---------------------------------------------------------------------------
# Residual block
# ---------------------------------------------------------------------------

SKIPS = ("identity", "1x1", "scale", "exp_scale", "channelwise_scale")


@dataclasses.dataclass(frozen=True)
class ResBlock:
    """Variance-constrained residual unit:
    y = skip(x) + res_scale * res_scale_param * block(x * pre_scale), with
    pre_scale = (1 + idx * res_scale^2)^-1/2. The skip is the identity, a
    1x1 conv (`shortcut`), or x times `skip_scale`: a scalar (`scale`,
    init 1), its exp (`exp_scale`, init 0) or one per channel
    (`channelwise_scale`, init 1). Folding absorbs the residual scale into
    the last depthwise conv and folds the shortcut conv."""
    dim: int
    kernel_size: int = 3
    dilations: Tuple[int, ...] = (1, 1)
    activation: str = "ELU"
    activation_params: Optional[dict] = None
    norm: str = R.WEIGHT_NORM
    skip: str = "identity"
    act_all: bool = False
    expansion: int = 1
    groups: int = -1
    bias: bool = True
    res_scale: Optional[float] = None
    idx: int = 0
    zero_init: bool = True

    def __post_init__(self):
        if self.skip not in SKIPS:
            raise ValueError(f"unknown ResBlock skip {self.skip!r} "
                             f"(one of {', '.join(SKIPS)})")
        object.__setattr__(self, "blocks", tuple(
            DWSBlock(self.activation, self.activation_params, self.dim,
                     self.dim, self.kernel_size, dilation=d, norm=self.norm,
                     act_all=self.act_all, expansion=self.expansion,
                     groups=self.groups, bias=self.bias)
            for d in self.dilations))
        object.__setattr__(self, "pre_scale",
                           (1 + self.idx * self.res_scale ** 2) ** -0.5
                           if self.res_scale is not None else None)
        object.__setattr__(self, "shortcut",
                           Conv1d(self.dim, self.dim, 1, norm=self.norm,
                                  bias=self.bias)
                           if self.skip == "1x1" else None)

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"blocks": [b.init(gen) for b in self.blocks]}
        if self.zero_init:
            p["res_scale_param"] = torch.zeros(1)
        if self.skip == "1x1":
            p["shortcut"] = self.shortcut.init(gen)
        elif self.skip == "scale":
            p["skip_scale"] = torch.ones((1, 1, 1))
        elif self.skip == "exp_scale":
            p["skip_scale"] = torch.zeros((1, 1, 1))
        elif self.skip == "channelwise_scale":
            p["skip_scale"] = torch.ones((1, self.dim, 1))
        return p

    def _shortcut(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self.skip == "identity":
            return x
        if self.skip == "1x1":
            return self.shortcut.apply(params["shortcut"], x)
        scale = params["skip_scale"].to(x.dtype)
        if self.skip == "exp_scale":
            scale = torch.exp(scale)
        return scale * x

    def _res_scale(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        scale = 1.0 if self.res_scale is None else self.res_scale
        if "res_scale_param" in params:
            return x * (torch.tensor(scale, dtype=x.dtype, device=x.device)
                        * params["res_scale_param"].to(x.dtype)[0])
        return x * scale

    def _folded(self, params: Params) -> bool:
        return "res_scale_param" not in params and self.zero_init

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        skip = self._shortcut(params, x)
        if self.pre_scale is not None:
            x = scale_as(x, self.pre_scale)
        for blk, bp in zip(self.blocks, params["blocks"]):
            x = blk.apply(bp, x)
        if not self._folded(params):
            x = self._res_scale(params, x)
        return x + skip

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        return [c for b in self.blocks
                for c in b.init_cache(batch, dtype, device)]

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        skip = self._shortcut(params, x)
        if self.pre_scale is not None:
            x = scale_as(x, self.pre_scale)
        new_cache: Cache = []
        i = 0
        for blk, bp in zip(self.blocks, params["blocks"]):
            n = 1 if blk.depthwise.cache_len else 0
            x, c = blk.step(bp, cache[i:i + n], x)
            new_cache.extend(c)
            i += n
        if not self._folded(params):
            x = self._res_scale(params, x)
        return x + skip, new_cache

    def fold(self, params: Params) -> Params:
        """Absorb res_scale * res_scale_param into the last depthwise conv;
        fold the shortcut conv, keep `skip_scale`."""
        out: Params = {"blocks": [b.fold(p) for b, p in
                                  zip(self.blocks, params["blocks"])]}
        if self.skip == "1x1":
            out["shortcut"] = self.shortcut.fold(params["shortcut"])
        elif self.skip != "identity":
            out["skip_scale"] = params["skip_scale"]
        if "res_scale_param" in params:
            scale = ((1.0 if self.res_scale is None else self.res_scale)
                     * params["res_scale_param"][0])
            last = out["blocks"][-1]["depthwise"]
            last["w"] = last["w"] * scale
            if last.get("b") is not None:
                last["b"] = last["b"] * scale
        return out


# ---------------------------------------------------------------------------
# SpecBlock
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpecBlock:
    """Causal log-magnitude STFT of the raw wav, fixed normalization, 1x1
    conv, zero-init scale, residual add. In streaming mode the caller
    passes the wav suffix from the shared ring (n_fft-1 + hop*L samples).
    `learnable`: the STFT is a strided conv with the `basis` parameter
    [n_fft+2, 1, n_fft], initialized to the windowed DFT basis; folding
    keeps it."""
    n_fft: int
    channels: int
    stride: int          # STFT hop
    norm: str = R.WEIGHT_NORM
    bias: bool = False
    learnable: bool = False
    compression: str = "log"
    mean: float = 0.0
    std: float = 1.0
    res_scale: Optional[float] = 1.0
    zero_init: bool = True
    inout_norm: bool = True

    def __post_init__(self):
        object.__setattr__(self, "layer", Conv1d(
            self.n_fft // 2 + 1, self.channels, 1, norm=self.norm,
            bias=self.bias))

    @property
    def cache_len(self) -> int:
        return self.n_fft - 1

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"layer": self.layer.init(gen)}
        if self.zero_init:
            p["scale_param"] = torch.zeros(1)
        if self.learnable:
            p["basis"] = torch.from_numpy(S.causal_stft_basis(self.n_fft))
        return p

    def _spec(self, wav: torch.Tensor, pad: bool,
              basis: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The compressed magnitudes; `basis` is the learnable STFT's."""
        if self.learnable:
            y = S.causal_stft_mag_learnable(wav, basis, self.stride, pad=pad)
        else:
            y = S.causal_stft_mag(wav, self.n_fft, self.stride, pad=pad)
        if self.compression == "log":
            y = torch.log(torch.clamp(y, min=1e-5))
        elif self.compression:
            c = float(self.compression)
            y = torch.sign(y) * torch.abs(y) ** c
        return y

    def _mix(self, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        folded = "scale_param" not in params and self.zero_init
        if self.inout_norm and not folded:
            y = (y - self.mean) / self.std
        y = self.layer.apply(params["layer"], y)
        if not folded:
            scale = 1.0 if self.res_scale is None else self.res_scale
            if "scale_param" in params:
                y = y * (torch.tensor(scale, dtype=x.dtype, device=x.device)
                         * params["scale_param"].to(x.dtype)[0])
            else:
                y = y * scale
        return x + y

    def apply(self, params: Params, x: torch.Tensor,
              wav: torch.Tensor) -> torch.Tensor:
        return self._mix(params, x,
                         self._spec(wav, True, params.get("basis")))

    def step(self, params: Params, x: torch.Tensor,
             wav_suffix: torch.Tensor) -> torch.Tensor:
        return self._mix(params, x,
                         self._spec(wav_suffix, False, params.get("basis")))

    def fold(self, params: Params) -> Params:
        """Fold mean/std normalization and the scale into the 1x1 conv."""
        if not self.zero_init:
            raise ValueError("SpecBlock.fold requires zero_init")
        layer = self.layer.fold(params["layer"])
        w = layer["w"]
        b = layer.get("b")
        if b is None:
            b = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
        if self.inout_norm:
            b = b + torch.sum(w, dim=(1, 2)) * (-self.mean / self.std)
            w = w / self.std
        scale = 1.0 if self.res_scale is None else self.res_scale
        if "scale_param" in params:
            scale = scale * params["scale_param"][0]
        out: Params = {"layer": {"w": w * scale, "b": b * scale}}
        if self.learnable:
            out["basis"] = params["basis"]
        return out


def l2norm(x: torch.Tensor, channels: int, eps: float = 1e-12,
           inout_norm: bool = True) -> torch.Tensor:
    """L2-normalize the channel dim, times sqrt(C) (F.normalize * sqrt(C))."""
    x32 = x.float()
    n = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True))
    y = x32 / torch.clamp(n, min=eps)
    if inout_norm:
        y = y * math.sqrt(channels)
    return y.to(x.dtype)
