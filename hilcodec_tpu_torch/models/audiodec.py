"""The AudioDec family (`hilcodec_tpu/models/audiodec.py`): the streaming
codec of hop 300 at 24 kHz.

The encoder stacks causal residual units (dilations 1, 3, 9) and strided
convs (strides 3, 4, 5, 5) and projects to `code_dim` channels without
weight norm; the decoder is a causal HiFiGAN generator whose residual
blocks are `MultiGroupConv1d`: the input repeated `groups` times along
the channels (`x.repeat(1, groups, 1)`, JAX's `jnp.tile`), grouped causal
conv pairs with a residual per dilation, then a 1x1 merge back. The
decoder first de-normalizes its input with stored `mean` / `scale`
stats. Every block has its batch `apply` and its streaming `step` in the
reference cache order; the quantizer (RVQ 8 x 1024 x `code_dim`) is
attached by `CodecModel`, as for the other families. The grouped convs
go through `ops/conv.py`, which on the CPU takes each group through the
batch-invariant `row_matmul` route of a dense conv.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import reparam as R
from . import layers as L
from .encodec import _cache_counts, _Steps
from .hilcodec import params_to

Params = Dict[str, Any]
Cache = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CausalResidualUnit:
    """x + pw(act(causal_conv_k(act(x))))."""
    channels: int
    kernel_size: int = 7
    dilation: int = 1
    bias: bool = False
    activation: str = "ELU"
    norm: str = R.NONE

    def __post_init__(self):
        object.__setattr__(self, "conv1", L.Conv1d(
            self.channels, self.channels, self.kernel_size,
            dilation=self.dilation, bias=self.bias, norm=self.norm))
        object.__setattr__(self, "conv2", L.Conv1d(
            self.channels, self.channels, 1, bias=self.bias,
            norm=self.norm))
        object.__setattr__(self, "_act", L.activation(self.activation))

    def init(self, gen: torch.Generator) -> Params:
        return {"conv1": self.conv1.init(gen), "conv2": self.conv2.init(gen)}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1.apply(params["conv1"], self._act(x))
        return x + self.conv2.apply(params["conv2"], self._act(y))

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        return self.conv1.init_cache(batch, dtype, device)

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        y, c = self.conv1.step(params["conv1"], cache, self._act(x))
        return x + self.conv2.apply(params["conv2"], self._act(y)), c


@dataclasses.dataclass(frozen=True)
class AudioDecEncoder:
    """conv7 -> per stage [3 residual units (d = 1, 3, 9) + a strided
    conv of kernel 2s] -> a projector conv3 to `code_dim` channels."""
    input_channels: int = 1
    encode_channels: int = 32
    channel_ratios: Tuple[int, ...] = (2, 4, 8, 16)
    strides: Tuple[int, ...] = (3, 4, 5, 5)
    kernel_size: int = 7
    bias: bool = True
    activation: str = "ELU"
    code_dim: int = 64
    norm: str = R.NONE

    def __post_init__(self):
        object.__setattr__(self, "hop_length", int(np.prod(self.strides)))
        stages = []
        in_ch = self.encode_channels
        for ratio, stride in zip(self.channel_ratios, self.strides):
            out_ch = self.encode_channels * ratio
            units = tuple(CausalResidualUnit(in_ch, dilation=d,
                                             activation=self.activation,
                                             norm=self.norm)
                          for d in (1, 3, 9))
            down = L.Conv1d(in_ch, out_ch, 2 * stride, stride=stride,
                            bias=self.bias, norm=self.norm)
            stages.append((units, down))
            in_ch = out_ch
        object.__setattr__(self, "conv_pre", L.Conv1d(
            self.input_channels, self.encode_channels, self.kernel_size,
            bias=False, norm=self.norm))
        object.__setattr__(self, "stages", tuple(stages))
        object.__setattr__(self, "projector", L.Conv1d(
            in_ch, self.code_dim, 3, bias=False, norm=self.norm))
        object.__setattr__(self, "_mods", self._order())
        object.__setattr__(self, "_counts", _cache_counts(self._mods))

    def _order(self):
        mods = [self.conv_pre]
        for units, down in self.stages:
            mods.extend(units)
            mods.append(down)
        return tuple(mods + [self.projector])

    def _params(self, params: Params) -> List[Params]:
        """Each module's params, in the order of `_order`."""
        out = [params["conv_pre"]]
        for sp in params["stages"]:
            out.extend(sp["units"])
            out.append(sp["down"])
        return out + [params["projector"]]

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"conv_pre": self.conv_pre.init(gen), "stages": []}
        for units, down in self.stages:
            p["stages"].append({"units": [u.init(gen) for u in units],
                                "down": down.init(gen)})
        p["projector"] = self.projector.init(gen)
        return p

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        for mod, mp in zip(self._mods, self._params(params)):
            x = mod.apply(mp, x)
        return x

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        return [c for m in self._mods
                for c in m.init_cache(batch, dtype, device)]

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        run = _Steps(cache, self._counts)
        for mod, mp in zip(self._mods, self._params(params)):
            x = run(mod, mp, x)
        return x, run.new


@dataclasses.dataclass(frozen=True)
class MultiGroupConv1d:
    """The grouped-conv stand-in for HiFiGAN's MRF: the input tiled
    `groups` times along the channels, per dilation a grouped causal conv
    pair with a residual, then a 1x1 merge back to `channels`."""
    channels: int
    kernel_size: int = 11
    dilations: Tuple[int, ...] = (1, 3, 5)
    groups: int = 3
    bias: bool = True
    use_additional_convs: bool = True
    activation: str = "LeakyReLU"
    activation_params: Optional[dict] = None
    norm: str = R.WEIGHT_NORM

    def __post_init__(self):
        ch = self.channels * self.groups
        convs1, convs2 = [], []
        for d in self.dilations:
            convs1.append(L.Conv1d(ch, ch, self.kernel_size, dilation=d,
                                   groups=self.groups, bias=self.bias,
                                   norm=self.norm))
            if self.use_additional_convs:
                convs2.append(L.Conv1d(ch, ch, self.kernel_size,
                                       groups=self.groups, bias=self.bias,
                                       norm=self.norm))
        object.__setattr__(self, "convs1", tuple(convs1))
        object.__setattr__(self, "convs2", tuple(convs2))
        object.__setattr__(self, "conv_out", L.Conv1d(
            ch, self.channels, 1, bias=False, norm=self.norm))
        object.__setattr__(self, "_act", L.activation(
            self.activation, self.activation_params
            or {"negative_slope": 0.1}))

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"convs1": [c.init(gen) for c in self.convs1]}
        if self.use_additional_convs:
            p["convs2"] = [c.init(gen) for c in self.convs2]
        p["conv_out"] = self.conv_out.init(gen)
        return p

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat(1, self.groups, 1)
        for li, conv1 in enumerate(self.convs1):
            xt = conv1.apply(params["convs1"][li], self._act(x))
            if self.use_additional_convs:
                xt = self.convs2[li].apply(params["convs2"][li],
                                           self._act(xt))
            x = xt + x
        return self.conv_out.apply(params["conv_out"], x)

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        out: Cache = []
        for li, conv1 in enumerate(self.convs1):
            out.extend(conv1.init_cache(batch, dtype, device))
            if self.use_additional_convs:
                out.extend(self.convs2[li].init_cache(batch, dtype, device))
        return out

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        new_cache: Cache = []
        x = x.repeat(1, self.groups, 1)
        i = 0
        for li, conv1 in enumerate(self.convs1):
            xt, c = conv1.step(params["convs1"][li], cache[i:i + 1],
                               self._act(x))
            new_cache.extend(c)
            i += 1
            if self.use_additional_convs:
                xt, c = self.convs2[li].step(params["convs2"][li],
                                             cache[i:i + 1], self._act(xt))
                new_cache.extend(c)
                i += 1
            x = xt + x
        return self.conv_out.apply(params["conv_out"], x), new_cache


@dataclasses.dataclass(frozen=True)
class AudioDecDecoder:
    """Causal HiFiGAN generator with grouped-conv blocks and input
    de-normalization stats: (c - mean) / scale -> conv7 -> per stage
    [LeakyReLU(0.1) -> convT (kernel 2s) -> MultiGroupConv1d] ->
    LeakyReLU(0.01) -> conv7 -> tanh."""
    in_channels: int = 64
    out_channels: int = 1
    channels: int = 512
    kernel_size: int = 7
    upsample_scales: Tuple[int, ...] = (5, 5, 4, 3)
    resblock_kernel_size: int = 11
    resblock_dilations: Tuple[int, ...] = (1, 3, 5)
    groups: int = 3
    bias: bool = True
    use_additional_convs: bool = True
    norm: str = R.WEIGHT_NORM
    use_stats: bool = True

    def __post_init__(self):
        ups, blocks = [], []
        for i, scale in enumerate(self.upsample_scales):
            ups.append(L.ConvTranspose1d(
                self.channels // (2 ** i), self.channels // (2 ** (i + 1)),
                2 * scale, stride=scale, norm=self.norm))
            blocks.append(MultiGroupConv1d(
                self.channels // (2 ** (i + 1)), self.resblock_kernel_size,
                tuple(self.resblock_dilations), self.groups, self.bias,
                self.use_additional_convs, norm=self.norm))
        object.__setattr__(self, "input_conv", L.Conv1d(
            self.in_channels, self.channels, self.kernel_size,
            norm=self.norm))
        object.__setattr__(self, "ups", tuple(ups))
        object.__setattr__(self, "blocks", tuple(blocks))
        object.__setattr__(self, "output_conv", L.Conv1d(
            self.channels // (2 ** len(self.upsample_scales)),
            self.out_channels, self.kernel_size, norm=self.norm))
        object.__setattr__(self, "_act_up",
                           L.activation("LeakyReLU", {"negative_slope": 0.1}))
        object.__setattr__(self, "_act_out", L.activation("LeakyReLU"))
        mods = [self.input_conv]
        for up, blk in zip(ups, blocks):
            mods += [up, blk]
        object.__setattr__(self, "_counts",
                           _cache_counts(mods + [self.output_conv]))

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"input_conv": self.input_conv.init(gen), "ups": [],
                     "blocks": []}
        for up, blk in zip(self.ups, self.blocks):
            p["ups"].append(up.init(gen))
            p["blocks"].append(blk.init(gen))
        p["output_conv"] = self.output_conv.init(gen)
        if self.use_stats:
            p["mean"] = torch.zeros(self.in_channels)
            p["scale"] = torch.ones(self.in_channels)
        return p

    def _norm_in(self, params: Params, c: torch.Tensor) -> torch.Tensor:
        if self.use_stats and "mean" in params:
            c = (c - params["mean"].to(c.dtype)[None, :, None]) \
                / params["scale"].to(c.dtype)[None, :, None]
        return c

    def apply(self, params: Params, c: torch.Tensor) -> torch.Tensor:
        """c: [B, in_channels, T] -> [B, out_channels, T * hop]."""
        c = self.input_conv.apply(params["input_conv"],
                                  self._norm_in(params, c))
        for i, (up, blk) in enumerate(zip(self.ups, self.blocks)):
            c = up.apply(params["ups"][i], self._act_up(c))
            c = blk.apply(params["blocks"][i], c)
        c = self.output_conv.apply(params["output_conv"], self._act_out(c))
        return torch.tanh(c)

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        out: Cache = list(self.input_conv.init_cache(batch, dtype, device))
        for up, blk in zip(self.ups, self.blocks):
            out.extend(up.init_cache(batch, dtype, device))
            out.extend(blk.init_cache(batch, dtype, device))
        out.extend(self.output_conv.init_cache(batch, dtype, device))
        return out

    def step(self, params: Params, cache: Cache, c: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        run = _Steps(cache, self._counts)
        c = run(self.input_conv, params["input_conv"],
                self._norm_in(params, c))
        for i, (up, blk) in enumerate(zip(self.ups, self.blocks)):
            c = run(up, params["ups"][i], self._act_up(c))
            c = run(blk, params["blocks"][i], c)
        c = run(self.output_conv, params["output_conv"], self._act_out(c))
        return torch.tanh(c), run.new


@dataclasses.dataclass(frozen=True)
class AudioDec:
    """The full AudioDec generator, hop 300; its params carry the
    reference's own `codebooks` leaf beside the encoder and decoder (the
    quantizer `CodecModel` attaches holds the ones it codes with)."""
    input_channels: int = 1
    encode_channels: int = 32
    enc_ratios: Tuple[int, ...] = (2, 4, 8, 16)
    enc_strides: Tuple[int, ...] = (3, 4, 5, 5)
    code_dim: int = 64
    codebook_num: int = 8
    codebook_size: int = 1024
    output_channels: int = 1
    decode_channels: int = 512
    dec_strides: Tuple[int, ...] = (5, 5, 4, 3)
    kernel_size: int = 7
    resblock_kernel_size: int = 11
    resblock_dilations: Tuple[int, ...] = (1, 3, 5)

    def __post_init__(self):
        enc = AudioDecEncoder(
            self.input_channels, self.encode_channels,
            tuple(self.enc_ratios), tuple(self.enc_strides),
            code_dim=self.code_dim)
        dec = AudioDecDecoder(
            self.code_dim, self.output_channels, self.decode_channels,
            self.kernel_size, tuple(self.dec_strides),
            self.resblock_kernel_size, tuple(self.resblock_dilations))
        object.__setattr__(self, "encoder", enc)
        object.__setattr__(self, "decoder", dec)
        object.__setattr__(self, "hop_length", enc.hop_length)

    @classmethod
    def from_config(cls, model_kwargs: Dict[str, Any]) -> "AudioDec":
        """Build from a YAML `model_kwargs` dict, unknown keys ignored (the
        JAX registry's `build_audiodec`)."""
        keep = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in model_kwargs.items() if k in keep})

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        """Seeded init: draws on the CPU from `gen`, then moves to device."""
        return params_to({
            "encoder": self.encoder.init(gen),
            "decoder": self.decoder.init(gen),
            "codebooks": torch.randn((self.codebook_num, self.codebook_size,
                                      self.code_dim), generator=gen)},
            device)

    def init_cache(self, batch: int, dtype=torch.float32, device="cpu"
                   ) -> Tuple[Cache, Cache]:
        return (self.encoder.init_cache(batch, dtype, device),
                self.decoder.init_cache(batch, dtype, device))

    def fold_params(self, params: Params) -> Params:
        """Deployment fold: weight norm removed from the decoder's convs
        (the encoder has none; the codebooks pass through)."""
        return R.fold_tree(params, R.WEIGHT_NORM)
