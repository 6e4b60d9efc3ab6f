"""The Avocodo family (`hilcodec_tpu/models/avocodo.py`): the HILCodec
encoder with a multi-scale decoder, and the CoMBD + SBD discriminators.

The decoder is HILCodec's SEANet decoder with an output head after each
stage i >= 1 ([scale -> act -> conv(ch -> 1) -> wav_std -> final act]),
so `apply` gives the waveform at three scales, [1/8, 1/2, 1] x the full
rate; streaming (`init_cache` / `step`) runs the full-rate head only, the
deployment graph. `AvocodoModel` is the generator (the codec the registry
wraps in `CodecModel`), `AvocodoFullRate` the same generator with the
full-rate head only (the `train.trainer: hilcodec` ablation). CoMBD runs a
hierarchical path over the three scales and a multi-scale path over PQMF
bands of the full-rate output with shared blocks; `pqmf_targets` makes the
real multi-scale targets. Both PQMF uses take the unscaled ParallelWaveGAN
bank (`ops/pqmf.analysis(..., orthonormal=False)`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import pqmf as P
from ..ops import reparam as R
from . import layers as L
from .discriminators import SBD, _init_conv
from .hilcodec import WAV_STD, Encoder, params_to

Params = Dict[str, Any]
Cache = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AvocodoDecoder:
    """HILCodec-style decoder with multi-scale output heads: after stage
    i >= 1 a head gives the output at that scale; ys = [1/8, 1/2, 1] x
    the full rate."""
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

    def __post_init__(self):
        object.__setattr__(self, "hop_length", int(np.prod(self.ratios)))
        act, act_p = self.activation, self.activation_params
        mult = int(2 ** len(self.ratios))
        pre_pw = L.Conv1d(self.dimension, mult * self.n_filters, 1,
                          norm=self.norm, bias=False)
        pre_dw = L.Conv1d(mult * self.n_filters, mult * self.n_filters,
                          self.kernel_size, groups=mult * self.n_filters,
                          norm=self.norm, bias=self.bias)
        stages, heads = [], []
        for i, ratio in enumerate(self.ratios):
            up_dw = L.ConvTranspose1d(
                mult * self.n_filters, mult * self.n_filters, ratio * 2,
                stride=ratio, groups=mult * self.n_filters, norm=self.norm,
                bias=False, nonlinearity="relu")
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
                           res_scale=self.res_scale, idx=j, zero_init=True)
                for j in range(self.n_residual_layers))
            stages.append((up_dw, up_pw, blocks))
            mult //= 2
            if i >= 1:
                heads.append(L.Conv1d(mult * self.n_filters, self.channels,
                                      self.last_kernel_size, norm=self.norm,
                                      bias=self.bias, nonlinearity="relu"))
        object.__setattr__(self, "pre_pw", pre_pw)
        object.__setattr__(self, "pre_dw", pre_dw)
        object.__setattr__(self, "stages", tuple(stages))
        object.__setattr__(self, "heads", tuple(heads))
        object.__setattr__(self, "_act", L.activation(act, act_p))
        object.__setattr__(
            self, "_final_act",
            L.activation(self.final_activation or "Identity", None))
        rs = 1.0 if self.res_scale is None else self.res_scale
        object.__setattr__(self, "stage_scale",
                           (1 + self.n_residual_layers * rs ** 2) ** -0.5)

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"pre_pw": self.pre_pw.init(gen),
                     "pre_dw": self.pre_dw.init(gen), "stages": [],
                     "heads": []}
        for up_dw, up_pw, blocks in self.stages:
            p["stages"].append({"up_dw": up_dw.init(gen),
                                "up_pw": up_pw.init(gen),
                                "blocks": [b.init(gen) for b in blocks]})
        p["heads"] = [h.init(gen) for h in self.heads]
        return p

    def _head(self, head, hp: Params, x: torch.Tensor) -> torch.Tensor:
        y = head.apply(hp, self._act(x * self.stage_scale))
        return self._final_act(y * self.wav_std).float()

    def apply(self, params: Params, x: torch.Tensor,
              return_list: bool = True):
        """x: [B, dimension, T'] -> the three scales' outputs (a list), or
        the full-rate one [B, 1, T'*hop] only."""
        x = self.pre_pw.apply(params["pre_pw"], x)
        x = self.pre_dw.apply(params["pre_dw"], x)
        ys = []
        for i, ((up_dw, up_pw, blocks), sp) in enumerate(
                zip(self.stages, params["stages"])):
            if i > 0:
                x = x * self.stage_scale
            x = up_dw.apply(sp["up_dw"], self._act(x))
            x = up_pw.apply(sp["up_pw"], x)
            for blk, bp in zip(blocks, sp["blocks"]):
                x = blk.apply(bp, x)
            if i >= 1:
                ys.append(self._head(self.heads[i - 1],
                                     params["heads"][i - 1], x))
        return ys if return_list else ys[-1]

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        """[pre_dw] + per stage [up_dw, resblock caches...] + [the
        full-rate head]."""
        out: Cache = list(self.pre_dw.init_cache(batch, dtype, device))
        for up_dw, _pw, blocks in self.stages:
            out.extend(up_dw.init_cache(batch, dtype, device))
            for b in blocks:
                out.extend(b.init_cache(batch, dtype, device))
        out.extend(self.heads[-1].init_cache(batch, dtype, device))
        return out

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        """Streaming, full-rate head only: x [B, dimension, L] ->
        ([B, 1, L*hop], new_cache)."""
        new_cache: Cache = []
        x = self.pre_pw.apply(params["pre_pw"], x)
        x, c = self.pre_dw.step(params["pre_dw"], cache[0:1], x)
        new_cache.extend(c)
        i = 1
        for si, ((up_dw, up_pw, blocks), sp) in enumerate(
                zip(self.stages, params["stages"])):
            if si > 0:
                x = x * self.stage_scale
            x, c = up_dw.step(sp["up_dw"], cache[i:i + 1], self._act(x))
            new_cache.extend(c)
            i += 1
            x = up_pw.apply(sp["up_pw"], x)
            for blk, bp in zip(blocks, sp["blocks"]):
                n = len(blk.blocks)
                x, c = blk.step(bp, cache[i:i + n], x)
                new_cache.extend(c)
                i += n
        x, c = self.heads[-1].step(params["heads"][-1], cache[i:i + 1],
                                   self._act(x * self.stage_scale))
        new_cache.extend(c)
        return self._final_act(x * self.wav_std), new_cache


@dataclasses.dataclass(frozen=True)
class AvocodoModel:
    """Encoder (HILCodec SEANet) + multi-scale decoder."""
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
    kernel_size: int = 5
    last_kernel_size: int = 5
    residual_kernel_size: int = 5
    dilation_base: int = 1
    skip: str = "identity"
    final_activation: Optional[str] = "Tanh"
    act_all: bool = False
    encoder_l2norm: bool = True
    spec: str = "stft"
    spec_compression: str = "log"
    spec_learnable: bool = False
    norm: str = R.WEIGHT_NORM
    vq_dim: int = 128

    def __post_init__(self):
        enc = Encoder(
            self.channels_audio, self.vq_dim, self.channels_enc,
            self.n_fft_base, self.n_residual_enc, tuple(self.strides),
            "ELU", None, self.norm, self.kernel_size, self.last_kernel_size,
            self.residual_kernel_size, self.dilation_base, self.skip,
            act_all=self.act_all, l2norm=self.encoder_l2norm,
            spec=self.spec, spec_compression=self.spec_compression,
            spec_learnable=self.spec_learnable,
            res_scale=self.res_scale_enc)
        dec = AvocodoDecoder(
            self.channels_audio, self.vq_dim, self.channels_dec,
            self.n_residual_dec, tuple(self.strides), "ELU", None,
            self.norm, self.kernel_size, self.last_kernel_size,
            self.residual_kernel_size, self.dilation_base, self.skip,
            self.final_activation, self.act_all,
            res_scale=self.res_scale_dec)
        object.__setattr__(self, "encoder", enc)
        object.__setattr__(self, "decoder", dec)
        object.__setattr__(self, "hop_length", enc.hop_length)

    @classmethod
    def from_config(cls, model_kwargs: Dict[str, Any]) -> "AvocodoModel":
        kw = dict(model_kwargs)
        vq_kwargs = kw.pop("vq_kwargs", None) or {}
        keep = {f.name for f in dataclasses.fields(cls)}
        mapped = {k: v for k, v in kw.items() if k in keep}
        if "strides" in mapped:
            mapped["strides"] = tuple(mapped["strides"])
        mapped["vq_dim"] = vq_kwargs.get("dim", 128)
        return cls(**mapped)

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        """Seeded init: draws on the CPU from `gen`, then moves to device."""
        return params_to({"encoder": self.encoder.init(gen),
                          "decoder": self.decoder.init(gen)}, device)

    def init_cache(self, batch: int, dtype=torch.float32, device="cpu"
                   ) -> Tuple[Cache, Cache]:
        return (self.encoder.init_cache(batch, dtype, device),
                self.decoder.init_cache(batch, dtype, device))

    def fold_params(self, params: Params) -> Params:
        """Deployment fold: HILCodec's for the encoder; the decoder applies
        stage_scale and wav_std itself, so plain weight-norm folding."""
        return {"encoder": self.encoder.fold_params(params["encoder"]),
                "decoder": R.fold_tree(params["decoder"], self.norm)}


@dataclasses.dataclass(frozen=True)
class _FullRateDecoder:
    """AvocodoDecoder whose `apply` gives the full-rate output only (the
    codec protocol: decoder.apply(params, x) -> wav)."""
    dec: AvocodoDecoder

    def init(self, gen: torch.Generator) -> Params:
        return self.dec.init(gen)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.dec.apply(params, x, return_list=False)

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        return self.dec.init_cache(batch, dtype, device)

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        return self.dec.step(params, cache, x)


@dataclasses.dataclass(frozen=True)
class AvocodoFullRate:
    """The Avocodo generator with its full-rate head only: the
    `train.trainer: hilcodec` ablation, the Avocodo architecture under the
    HILCodec trainer (balancer, MFBD + MSTFTD, hinge, normalized FM)."""
    base: AvocodoModel

    def __post_init__(self):
        object.__setattr__(self, "encoder", self.base.encoder)
        object.__setattr__(self, "decoder",
                           _FullRateDecoder(self.base.decoder))
        object.__setattr__(self, "hop_length", self.base.hop_length)

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        return self.base.init(gen, device)

    def init_cache(self, batch: int, dtype=torch.float32, device="cpu"):
        return self.base.init_cache(batch, dtype, device)

    def fold_params(self, params: Params) -> Params:
        return self.base.fold_params(params)


# ---------------------------------------------------------------------------
# CoMBD
# ---------------------------------------------------------------------------

def _pqmf_band0(x: torch.Tensor, cfg) -> torch.Tensor:
    """The first band of the ParallelWaveGAN PQMF `cfg` = (subbands, taps,
    cutoff, beta) of x."""
    sub, taps, cutoff, beta = cfg
    return P.analysis(x, sub, taps, cutoff, beta, orthonormal=False)[:, :1]


@dataclasses.dataclass(frozen=True)
class CoMBDBlock:
    h_u: Tuple[int, ...]
    d_k: Tuple[int, ...]
    d_s: Tuple[int, ...]
    d_d: Tuple[int, ...]
    d_g: Tuple[int, ...]
    d_p: Tuple[int, ...]
    op_f: int
    op_k: int
    op_g: int
    norm: str = R.WEIGHT_NORM

    def init(self, gen: torch.Generator) -> Params:
        convs, c_in = [], 1
        for ch, k, g in zip(self.h_u, self.d_k, self.d_g):
            convs.append(_init_conv(gen, (ch, c_in // g, k), self.norm))
            c_in = ch
        return {"convs": convs,
                "proj": _init_conv(gen, (self.op_f, c_in // self.op_g,
                                         self.op_k), self.norm)}

    def apply(self, params: Params, x: torch.Tensor):
        fmap = []
        for p, s, d, g, pad in zip(params["convs"], self.d_s, self.d_d,
                                   self.d_g, self.d_p):
            x = F.leaky_relu(F.conv1d(x, R.compute_weight(p, self.norm),
                                      p.get("b"), stride=s, padding=pad,
                                      dilation=d, groups=g), 0.2)
            fmap.append(x)
        p = params["proj"]
        x = F.conv1d(x, R.compute_weight(p, self.norm), p.get("b"),
                     groups=self.op_g)
        return x, fmap


@dataclasses.dataclass(frozen=True)
class CoMBD:
    """Collaborative multi-band discriminator: a hierarchical path over the
    generator's outputs at increasing rates, and a multi-scale path over
    PQMF bands of the full-rate output through the same blocks."""
    combd_h_u: Tuple[Tuple[int, ...], ...]
    combd_d_k: Tuple[Tuple[int, ...], ...]
    combd_d_s: Tuple[Tuple[int, ...], ...]
    combd_d_d: Tuple[Tuple[int, ...], ...]
    combd_d_g: Tuple[Tuple[int, ...], ...]
    combd_d_p: Tuple[Tuple[int, ...], ...]
    combd_op_f: Tuple[int, ...]
    combd_op_k: Tuple[int, ...]
    combd_op_g: Tuple[int, ...]
    pqmf_config: Dict[str, Tuple]
    norm: str = R.WEIGHT_NORM

    def __post_init__(self):
        object.__setattr__(self, "blocks", tuple(
            CoMBDBlock(tuple(hu), tuple(dk), tuple(ds), tuple(dd),
                       tuple(dg), tuple(dp), of, ok, og, self.norm)
            for hu, dk, ds, dd, dg, dp, of, ok, og in zip(
                self.combd_h_u, self.combd_d_k, self.combd_d_s,
                self.combd_d_d, self.combd_d_g, self.combd_d_p,
                self.combd_op_f, self.combd_op_k, self.combd_op_g)))

    def init(self, gen: torch.Generator) -> Params:
        return {"blocks": [b.init(gen) for b in self.blocks]}

    def apply(self, params: Params, ys: List[torch.Tensor]):
        """ys: waveforms at increasing rates (the last at the full rate)."""
        logits, fmaps = [], []
        for x, b, p in zip(ys, self.blocks, params["blocks"]):
            lg, fm = b.apply(p, x)
            logits.append(lg)
            fmaps.extend(fm)
        ms = [_pqmf_band0(ys[-1], self.pqmf_config["lv2"]),
              _pqmf_band0(ys[-1], self.pqmf_config["lv1"])]
        for x, b, p in zip(ms, self.blocks[:-1], params["blocks"][:-1]):
            lg, fm = b.apply(p, x)
            logits.append(lg)
            fmaps.extend(fm)
        return logits, fmaps


def _sbd_pqmf(cfg) -> Optional[Dict[str, Any]]:
    if cfg is None or isinstance(cfg, dict):
        return cfg
    sub, taps, cutoff, beta = cfg
    return {"subbands": sub, "taps": taps, "cutoff_freq": cutoff,
            "beta": beta}


@dataclasses.dataclass(frozen=True)
class AvocodoDiscriminators:
    """{combd, sbd} as their `use:` flags select, over the generator's
    multi-scale output list (SBD sees the full-rate output)."""
    combd_kwargs: Optional[Dict[str, Any]] = None
    sbd_kwargs: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        discs = {}
        if self.combd_kwargs and self.combd_kwargs.get("use", False):
            h = dict(self.combd_kwargs["h"])
            discs["combd"] = CoMBD(
                combd_h_u=tuple(map(tuple, h["combd_h_u"])),
                combd_d_k=tuple(map(tuple, h["combd_d_k"])),
                combd_d_s=tuple(map(tuple, h["combd_d_s"])),
                combd_d_d=tuple(map(tuple, h["combd_d_d"])),
                combd_d_g=tuple(map(tuple, h["combd_d_g"])),
                combd_d_p=tuple(map(tuple, h["combd_d_p"])),
                combd_op_f=tuple(h["combd_op_f"]),
                combd_op_k=tuple(h["combd_op_k"]),
                combd_op_g=tuple(h["combd_op_g"]),
                pqmf_config={k: tuple(v)
                             for k, v in h["pqmf_config"].items()})
        if self.sbd_kwargs and self.sbd_kwargs.get("use", False):
            h = dict(self.sbd_kwargs["h"])
            pqmf_cfg = h.get("pqmf_config", {})
            discs["sbd"] = SBD(
                channels=tuple(map(tuple, h["sbd_filters"])),
                strides=tuple(map(tuple, h["sbd_strides"])),
                kernel_sizes=tuple(
                    tuple(map(tuple, k)) for k in h["sbd_kernel_sizes"]),
                dilations=tuple(
                    tuple(map(tuple, d)) for d in h["sbd_dilations"]),
                band_ranges=tuple(map(tuple, h["sbd_band_ranges"])),
                transpose=tuple(h["sbd_transpose"]),
                pqmf_kwargs=_sbd_pqmf(pqmf_cfg.get(
                    "sbd", h.get("pqmf_kwargs"))) or {},
                f_pqmf_kwargs=_sbd_pqmf(pqmf_cfg.get(
                    "fsbd", h.get("f_pqmf_kwargs"))),
                segment_size=h.get("segment_size"),
                pqmf_orthonormal=False)
        object.__setattr__(self, "discs", discs)

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        """Seeded init: draws on the CPU from `gen`, then moves to device."""
        return params_to({name: d.init(gen)
                          for name, d in self.discs.items()}, device)

    def apply(self, params: Params, ys: List[torch.Tensor]):
        logits, fmaps = {}, {}
        for name, d in self.discs.items():
            x = ys if name == "combd" else ys[-1]
            logits[name], fmaps[name] = d.apply(params[name], x)
        return logits, fmaps


def pqmf_targets(wav: torch.Tensor, pqmf_config: Dict[str, Tuple]
                 ) -> List[torch.Tensor]:
    """The real multi-scale targets [band 0 of the lv2 PQMF, band 0 of the
    lv1 PQMF, wav]."""
    return [_pqmf_band0(wav, pqmf_config["lv2"]),
            _pqmf_band0(wav, pqmf_config["lv1"]), wav]
