"""HILCodec encoder / decoder: SEANet with SpecBlocks.

Counterpart of `hilcodec_tpu/models/hilcodec.py`. `apply` runs whole
sequences; `step` consumes and returns the flat cache list in the JAX
(reference deployment) order, so streaming equals the batched forward.
Parameters are nested dicts of tensors with the JAX tree's names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import reparam as R
from . import layers as L

Params = Dict[str, Any]
Cache = List[torch.Tensor]

WAV_STD = 0.1122080159
SPEC_MEANS = (-4.554, -4.315, -4.021, -3.726, -3.477)
SPEC_STDS = (2.830, 2.837, 2.817, 2.796, 2.871)


def params_to(params: Any, device) -> Any:
    """Move every tensor leaf of a nested dict/list tree to `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to(v, device) for v in params]
    return params.to(device)


@dataclasses.dataclass(frozen=True)
class Encoder:
    """SEANetEncoder. The ratios are applied reversed: config strides
    [8,5,4,2] -> the encoder downsamples by 2,4,5,8."""
    channels: int = 1
    dimension: int = 128
    n_filters: int = 64
    n_fft_base: int = 64
    n_residual_layers: int = 2
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    activation: str = "ELU"
    activation_params: Optional[dict] = None
    norm: str = R.WEIGHT_NORM
    kernel_size: int = 5
    last_kernel_size: int = 5
    residual_kernel_size: int = 5
    dilation_base: int = 1
    skip: str = "identity"
    act_all: bool = False
    expansion: int = 1
    groups: int = -1
    l2norm: bool = True
    bias: bool = True
    spec: str = "stft"
    spec_compression: str = "log"
    spec_learnable: bool = False
    res_scale: Optional[float] = None
    wav_std: float = WAV_STD
    spec_means: Tuple[float, ...] = SPEC_MEANS
    spec_stds: Tuple[float, ...] = SPEC_STDS
    zero_init: bool = True
    inout_norm: bool = True

    def __post_init__(self):
        ratios = tuple(reversed(self.ratios))
        object.__setattr__(self, "hop_length", int(np.prod(ratios)))
        act, act_p = self.activation, self.activation_params

        conv_pre = L.Conv1d(self.channels, self.n_filters, self.kernel_size,
                            norm=self.norm, bias=self.bias)
        stages = []
        mult, stride = 1, 1
        for bi, ratio in enumerate(ratios):
            blocks = tuple(
                L.ResBlock(mult * self.n_filters,
                           kernel_size=self.residual_kernel_size,
                           dilations=(self.dilation_base ** j, 1),
                           activation=act, activation_params=act_p,
                           norm=self.norm, skip=self.skip,
                           act_all=self.act_all, expansion=self.expansion,
                           groups=self.groups, bias=self.bias,
                           res_scale=self.res_scale,
                           idx=(j - 1 if self.spec == "" else j),
                           zero_init=self.zero_init)
                for j in range(1, self.n_residual_layers + 1))
            spec_block = None
            if self.spec == "stft":
                spec_block = L.SpecBlock(
                    mult * self.n_fft_base, mult * self.n_filters, stride,
                    norm=self.norm, bias=False,
                    learnable=self.spec_learnable,
                    compression=self.spec_compression,
                    mean=self.spec_means[bi], std=self.spec_stds[bi],
                    res_scale=self.res_scale, zero_init=self.zero_init,
                    inout_norm=self.inout_norm)
            stride *= ratio
            down_pw = L.Conv1d(mult * self.n_filters,
                               mult * self.n_filters * 2, 1, norm=self.norm,
                               bias=False, nonlinearity="relu")
            down_dw = L.Conv1d(mult * self.n_filters * 2,
                               mult * self.n_filters * 2,
                               kernel_size=ratio * 2, stride=ratio,
                               groups=mult * self.n_filters * 2,
                               norm=self.norm, bias=self.bias)
            stages.append((spec_block, blocks, down_pw, down_dw))
            mult *= 2

        spec_post = None
        if self.spec == "stft":
            spec_post = L.SpecBlock(
                mult * self.n_fft_base, mult * self.n_filters, stride,
                norm=self.norm, bias=False, learnable=self.spec_learnable,
                compression=self.spec_compression, mean=self.spec_means[-1],
                std=self.spec_stds[-1], res_scale=self.res_scale,
                zero_init=self.zero_init, inout_norm=self.inout_norm)
        object.__setattr__(self, "conv_pre", conv_pre)
        object.__setattr__(self, "stages", tuple(stages))
        object.__setattr__(self, "spec_post", spec_post)
        object.__setattr__(self, "post_dw", L.Conv1d(
            mult * self.n_filters, mult * self.n_filters,
            self.last_kernel_size, groups=mult * self.n_filters,
            norm=self.norm, bias=False, nonlinearity="relu"))
        object.__setattr__(self, "post_pw", L.Conv1d(
            mult * self.n_filters, self.dimension, 1, norm=self.norm,
            bias=self.bias))
        object.__setattr__(self, "_act", L.activation(act, act_p))
        object.__setattr__(
            self, "stage_scale",
            None if self.res_scale is None else
            (1 + self.n_residual_layers * self.res_scale ** 2) ** -0.5)
        # one wav ring shared by every SpecBlock and conv_pre
        object.__setattr__(self, "wav_cache_len",
                           (mult // 2 * 2) * self.n_fft_base - 1)

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"conv_pre": self.conv_pre.init(gen), "stages": []}
        for spec, blocks, pw, dw in self.stages:
            sp: Params = {"blocks": [b.init(gen) for b in blocks],
                          "down_pw": pw.init(gen), "down_dw": dw.init(gen)}
            if spec is not None:
                sp["spec"] = spec.init(gen)
            p["stages"].append(sp)
        if self.spec_post is not None:
            p["spec_post"] = self.spec_post.init(gen)
        p["post_dw"] = self.post_dw.init(gen)
        p["post_pw"] = self.post_pw.init(gen)
        if self.l2norm:
            # big non-zero bias init for silence robustness
            p["post_pw"]["b"] = torch.randn(self.dimension, generator=gen)
        return p

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 1, T] -> [B, dimension, T/hop]."""
        folded = "w" in params["conv_pre"]
        wav = x
        if self.inout_norm and not folded:
            x = L.scale_as(x, 1.0 / self.wav_std)
        x = self.conv_pre.apply(params["conv_pre"], x)
        for (spec, blocks, pw, dw), sp in zip(self.stages, params["stages"]):
            if spec is not None:
                x = spec.apply(sp["spec"], x, wav)
            for blk, bp in zip(blocks, sp["blocks"]):
                x = blk.apply(bp, x)
            if self.stage_scale is not None:
                x = L.scale_as(x, self.stage_scale)
            x = pw.apply(sp["down_pw"], self._act(x))
            x = dw.apply(sp["down_dw"], x)
        if self.spec_post is not None:
            x = self.spec_post.apply(params["spec_post"], x, wav)
        x = self.post_dw.apply(params["post_dw"], self._act(x))
        x = self.post_pw.apply(params["post_pw"], x)
        if self.l2norm:
            x = L.l2norm(x, self.dimension, inout_norm=self.inout_norm)
        return x

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        """[wav_ring] + per stage [resblock caches..., down_dw] + [post_dw]."""
        out: Cache = [torch.zeros((batch, 1, self.wav_cache_len),
                                  dtype=dtype, device=device)]
        for _spec, blocks, _pw, dw in self.stages:
            for b in blocks:
                out.extend(b.init_cache(batch, dtype, device))
            out.extend(dw.init_cache(batch, dtype, device))
        out.extend(self.post_dw.init_cache(batch, dtype, device))
        return out

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        """x: [B, 1, hop*L] -> ([B, dimension, L], new_cache)."""
        folded = "w" in params["conv_pre"]
        wcl = self.wav_cache_len
        wav = torch.cat([cache[0], x], dim=-1)
        new_cache: Cache = [wav[:, :, wav.shape[-1] - wcl:]]

        x = wav[:, :, wcl - (self.kernel_size - 1):]
        if self.inout_norm and not folded:
            x = L.scale_as(x, 1.0 / self.wav_std)
        x = self.conv_pre.apply_nopad(params["conv_pre"], x)

        i = 1
        for (spec, blocks, pw, dw), sp in zip(self.stages, params["stages"]):
            if spec is not None:
                x = spec.step(sp["spec"], x, wav[:, :, wcl - spec.cache_len:])
            for blk, bp in zip(blocks, sp["blocks"]):
                n = len(blk.blocks)
                x, c = blk.step(bp, cache[i:i + n], x)
                new_cache.extend(c)
                i += n
            if self.stage_scale is not None:
                x = L.scale_as(x, self.stage_scale)
            x = pw.apply(sp["down_pw"], self._act(x))
            x, c = dw.step(sp["down_dw"], cache[i:i + 1], x)
            new_cache.extend(c)
            i += 1
        if self.spec_post is not None:
            x = self.spec_post.step(params["spec_post"], x, wav)
        x, c = self.post_dw.step(params["post_dw"], cache[i:i + 1],
                                 self._act(x))
        new_cache.extend(c)
        x = self.post_pw.apply(params["post_pw"], x)
        if self.l2norm:
            x = L.l2norm(x, self.dimension, inout_norm=self.inout_norm)
        return x, new_cache

    def fold_params(self, params: Params) -> Params:
        """Remove weight norm and merge every static scaling."""
        out: Params = {"conv_pre": self.conv_pre.fold(params["conv_pre"]),
                       "stages": []}
        if self.inout_norm:
            out["conv_pre"]["w"] = out["conv_pre"]["w"] / self.wav_std
        for (spec, blocks, pw, dw), sp in zip(self.stages, params["stages"]):
            fs: Params = {
                "blocks": [b.fold(p) for b, p in zip(blocks, sp["blocks"])],
                "down_pw": pw.fold(sp["down_pw"]),
                "down_dw": dw.fold(sp["down_dw"]),
            }
            if spec is not None:
                fs["spec"] = spec.fold(sp["spec"])
            out["stages"].append(fs)
        if self.spec_post is not None:
            out["spec_post"] = self.spec_post.fold(params["spec_post"])
        out["post_dw"] = self.post_dw.fold(params["post_dw"])
        out["post_pw"] = self.post_pw.fold(params["post_pw"])
        return out


@dataclasses.dataclass(frozen=True)
class Decoder:
    """SEANetDecoder."""
    channels: int = 1
    dimension: int = 128
    n_filters: int = 96
    n_residual_layers: int = 3
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    activation: str = "ELU"
    activation_params: Optional[dict] = None
    norm: str = R.WEIGHT_NORM
    kernel_size: int = 5
    last_kernel_size: int = 5
    residual_kernel_size: int = 5
    dilation_base: int = 1
    skip: str = "identity"
    final_activation: Optional[str] = "Tanh"
    act_all: bool = False
    expansion: int = 1
    groups: int = -1
    bias: bool = True
    res_scale: Optional[float] = None
    wav_std: float = WAV_STD
    zero_init: bool = True
    inout_norm: bool = True

    def __post_init__(self):
        object.__setattr__(self, "hop_length", int(np.prod(self.ratios)))
        act, act_p = self.activation, self.activation_params
        mult = int(2 ** len(self.ratios))
        pre_pw = L.Conv1d(self.dimension, mult * self.n_filters, 1,
                          norm=self.norm, bias=False)
        pre_dw = L.Conv1d(mult * self.n_filters, mult * self.n_filters,
                          self.kernel_size, groups=mult * self.n_filters,
                          norm=self.norm, bias=self.bias)
        stages = []
        for ratio in self.ratios:
            up_dw = L.ConvTranspose1d(
                mult * self.n_filters, mult * self.n_filters,
                kernel_size=ratio * 2, stride=ratio,
                groups=mult * self.n_filters, norm=self.norm, bias=False,
                nonlinearity="relu")
            up_pw = L.Conv1d(mult * self.n_filters,
                             mult * self.n_filters // 2, 1, norm=self.norm,
                             bias=self.bias)
            blocks = tuple(
                L.ResBlock(mult * self.n_filters // 2,
                           kernel_size=self.residual_kernel_size,
                           dilations=(self.dilation_base ** j, 1),
                           activation=act, activation_params=act_p,
                           norm=self.norm, skip=self.skip,
                           act_all=self.act_all, expansion=self.expansion,
                           groups=self.groups, bias=self.bias,
                           res_scale=self.res_scale, idx=j,
                           zero_init=self.zero_init)
                for j in range(self.n_residual_layers))
            stages.append((up_dw, up_pw, blocks))
            mult //= 2
        object.__setattr__(self, "pre_pw", pre_pw)
        object.__setattr__(self, "pre_dw", pre_dw)
        object.__setattr__(self, "stages", tuple(stages))
        object.__setattr__(self, "conv_post", L.Conv1d(
            self.n_filters, self.channels, self.last_kernel_size,
            norm=self.norm, bias=self.bias, nonlinearity="relu"))
        object.__setattr__(self, "_act", L.activation(act, act_p))
        object.__setattr__(
            self, "_final_act",
            L.activation(self.final_activation or "Identity", None))
        object.__setattr__(
            self, "stage_scale",
            None if self.res_scale is None else
            (1 + self.n_residual_layers * self.res_scale ** 2) ** -0.5)

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"pre_pw": self.pre_pw.init(gen),
                     "pre_dw": self.pre_dw.init(gen), "stages": []}
        for up_dw, up_pw, blocks in self.stages:
            p["stages"].append({"up_dw": up_dw.init(gen),
                                "up_pw": up_pw.init(gen),
                                "blocks": [b.init(gen) for b in blocks]})
        p["conv_post"] = self.conv_post.init(gen)
        return p

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: [B, dimension, T'] -> [B, 1, T'*hop]."""
        folded = "w" in params["conv_post"]
        x = self.pre_pw.apply(params["pre_pw"], x)
        x = self.pre_dw.apply(params["pre_dw"], x)
        for (up_dw, up_pw, blocks), sp in zip(self.stages, params["stages"]):
            x = up_dw.apply(sp["up_dw"], self._act(x))
            x = up_pw.apply(sp["up_pw"], x)
            for blk, bp in zip(blocks, sp["blocks"]):
                x = blk.apply(bp, x)
            if self.stage_scale is not None:
                x = L.scale_as(x, self.stage_scale)
        x = self.conv_post.apply(params["conv_post"], self._act(x))
        if self.inout_norm and not folded:
            x = L.scale_as(x, self.wav_std)
        return self._final_act(x)

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        """[pre_dw] + per stage [up_dw, resblock caches...] + [conv_post]."""
        out: Cache = list(self.pre_dw.init_cache(batch, dtype, device))
        for up_dw, _pw, blocks in self.stages:
            out.extend(up_dw.init_cache(batch, dtype, device))
            for b in blocks:
                out.extend(b.init_cache(batch, dtype, device))
        out.extend(self.conv_post.init_cache(batch, dtype, device))
        return out

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        """x: [B, dimension, L] -> ([B, 1, L*hop], new_cache)."""
        folded = "w" in params["conv_post"]
        new_cache: Cache = []
        x = self.pre_pw.apply(params["pre_pw"], x)
        x, c = self.pre_dw.step(params["pre_dw"], cache[0:1], x)
        new_cache.extend(c)
        i = 1
        for (up_dw, up_pw, blocks), sp in zip(self.stages, params["stages"]):
            x, c = up_dw.step(sp["up_dw"], cache[i:i + 1], self._act(x))
            new_cache.extend(c)
            i += 1
            x = up_pw.apply(sp["up_pw"], x)
            for blk, bp in zip(blocks, sp["blocks"]):
                n = len(blk.blocks)
                x, c = blk.step(bp, cache[i:i + n], x)
                new_cache.extend(c)
                i += n
            if self.stage_scale is not None:
                x = L.scale_as(x, self.stage_scale)
        x, c = self.conv_post.step(params["conv_post"], cache[i:i + 1],
                                   self._act(x))
        new_cache.extend(c)
        if self.inout_norm and not folded:
            x = L.scale_as(x, self.wav_std)
        return self._final_act(x), new_cache

    def fold_params(self, params: Params) -> Params:
        out: Params = {"pre_pw": self.pre_pw.fold(params["pre_pw"]),
                       "pre_dw": self.pre_dw.fold(params["pre_dw"]),
                       "stages": []}
        for (up_dw, up_pw, blocks), sp in zip(self.stages, params["stages"]):
            out["stages"].append({
                "up_dw": up_dw.fold(sp["up_dw"]),
                "up_pw": up_pw.fold(sp["up_pw"]),
                "blocks": [b.fold(p) for b, p in zip(blocks, sp["blocks"])],
            })
        cp = self.conv_post.fold(params["conv_post"])
        if self.inout_norm:
            cp["w"] = cp["w"] * self.wav_std
            if cp.get("b") is not None:
                cp["b"] = cp["b"] * self.wav_std
        out["conv_post"] = cp
        return out


@dataclasses.dataclass(frozen=True)
class HILCodec:
    """Encoder + decoder of the causal HILCodec; the quantizer is attached
    separately (see ops/rvq.py and models/codec.py)."""
    sample_rate: int = 24000
    channels_audio: int = 1
    channels_enc: int = 64
    channels_dec: int = 96
    n_fft_base: int = 64
    n_residual_enc: int = 2
    n_residual_dec: int = 3
    res_scale_enc: Optional[float] = 0.5773502691896258
    res_scale_dec: Optional[float] = 0.5773502691896258
    strides: Tuple[int, ...] = (8, 5, 4, 2)
    activation: str = "ELU"
    activation_kwargs: Optional[dict] = None
    norm: str = R.WEIGHT_NORM
    kernel_size: int = 5
    last_kernel_size: int = 5
    residual_kernel_size: int = 5
    dilation_base: int = 1
    skip: str = "identity"
    final_activation: Optional[str] = "Tanh"
    vq_dim: int = 128
    act_all: bool = False
    expansion: int = 1
    groups: int = -1
    encoder_l2norm: bool = True
    bias: bool = True
    spec: str = "stft"
    spec_compression: str = "log"
    spec_learnable: bool = False
    pad_mode: str = "constant"
    causal: bool = True
    zero_init: bool = True
    inout_norm: bool = True

    def __post_init__(self):
        if not self.causal:
            raise ValueError("only the causal HILCodec is implemented")
        if self.pad_mode not in ("constant", "zeros"):
            raise ValueError(
                f"HILCodec pad_mode={self.pad_mode!r} is not supported: "
                "the causal streaming cache is equivalent to zero padding")
        enc = Encoder(
            self.channels_audio, self.vq_dim, self.channels_enc,
            self.n_fft_base, self.n_residual_enc, tuple(self.strides),
            self.activation, self.activation_kwargs, self.norm,
            self.kernel_size, self.last_kernel_size,
            self.residual_kernel_size, self.dilation_base, self.skip,
            act_all=self.act_all, expansion=self.expansion,
            groups=self.groups, l2norm=self.encoder_l2norm, bias=self.bias,
            spec=self.spec, spec_compression=self.spec_compression,
            spec_learnable=self.spec_learnable,
            res_scale=self.res_scale_enc, zero_init=self.zero_init,
            inout_norm=self.inout_norm)
        dec = Decoder(
            self.channels_audio, self.vq_dim, self.channels_dec,
            self.n_residual_dec, tuple(self.strides), self.activation,
            self.activation_kwargs, self.norm, self.kernel_size,
            self.last_kernel_size, self.residual_kernel_size,
            self.dilation_base, self.skip,
            final_activation=self.final_activation, act_all=self.act_all,
            expansion=self.expansion, groups=self.groups, bias=self.bias,
            res_scale=self.res_scale_dec, zero_init=self.zero_init,
            inout_norm=self.inout_norm)
        object.__setattr__(self, "encoder", enc)
        object.__setattr__(self, "decoder", dec)
        object.__setattr__(self, "hop_length", enc.hop_length)

    @classmethod
    def from_config(cls, model_kwargs: Dict[str, Any]) -> "HILCodec":
        """Build from a YAML `model_kwargs` dict."""
        kw = dict(model_kwargs)
        vq_kwargs = kw.pop("vq_kwargs", {})
        mapped = dict(channels_enc=kw.pop("channels_enc", 64),
                      channels_dec=kw.pop("channels_dec", 96),
                      vq_dim=vq_kwargs.get("dim", 128))
        for k in ("n_fft_base", "n_residual_enc", "n_residual_dec",
                  "res_scale_enc", "res_scale_dec", "kernel_size",
                  "last_kernel_size", "residual_kernel_size",
                  "dilation_base", "skip", "final_activation", "act_all",
                  "encoder_l2norm", "causal", "zero_init", "inout_norm",
                  "pad_mode", "spec", "spec_compression", "spec_learnable",
                  "norm"):
            if k in kw:
                mapped[k] = kw.pop(k)
        if "strides" in kw:
            mapped["strides"] = tuple(kw.pop("strides"))
        return cls(**mapped)

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        """Seeded init: draws on the CPU from `gen`, then moves to device."""
        p = {"encoder": self.encoder.init(gen),
             "decoder": self.decoder.init(gen)}
        return params_to(p, device)

    def init_cache(self, batch: int, dtype=torch.float32, device="cpu"
                   ) -> Tuple[Cache, Cache]:
        return (self.encoder.init_cache(batch, dtype, device),
                self.decoder.init_cache(batch, dtype, device))

    def fold_params(self, params: Params) -> Params:
        return {"encoder": self.encoder.fold_params(params["encoder"]),
                "decoder": self.decoder.fold_params(params["decoder"])}
