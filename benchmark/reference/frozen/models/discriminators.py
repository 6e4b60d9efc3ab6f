"""GAN discriminators (`hilcodec_tpu/models/discriminators.py`): the
multi-filter-bank (MFBD), multi-STFT (MSTFTD), HiFi-GAN's multi-period
(MPD) and multi-scale (MSD) discriminators, the sub-band discriminator
(SBD, with its MDC blocks, which Avocodo's discriminators use too,
`models/avocodo.py`), and the `Discriminators` aggregate of the flagship
trainer.

Each `apply(params, x)` maps x [B, 1, T] to (logits, feature maps);
`Discriminators.apply` gathers them into the `{name: [tensors]}` dicts the
losses consume. The filter-bank discriminator runs one lowering: every conv
of its stack has a 1-tap height, so the PQMF bands fold into the batch and
the stack runs as conv1d (the JAX package's `bands1d`, the same math as its
`conv2d`). Weights keep the JAX shapes ([Cout, Cin, 1, k]). Init is torch's
default conv init under weight norm (MSD's first scale: spectral norm,
whose `u` buffer is drawn too), from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import pqmf as P
from ..ops import reparam as R
from ..ops import stft as S
from .hilcodec import params_to

Params = Dict[str, Any]
LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size - 1) * dilation // 2


def _init_conv(gen: torch.Generator, shape: Tuple[int, ...], norm: str,
               with_bias: bool = True) -> Params:
    w, b = R.torch_default_conv_init(gen, shape, with_bias)
    return R.init_reparam(w, norm, bias=b, gen=gen)


# ---------------------------------------------------------------------------
# STFT discriminator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class STFTDiscriminator:
    filters: int
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    max_filters: int = 1024
    filters_scale: int = 1
    kernel_size: Tuple[int, int] = (3, 9)
    dilations: Tuple[int, ...] = (1, 2, 4)
    stride: Tuple[int, int] = (1, 2)
    normalized: bool = True
    norm: str = R.WEIGHT_NORM
    magnitude: bool = False
    log_magnitude: bool = False
    eps: float = 1e-5
    activation_slope: float = 0.2

    def _layer_shapes(self) -> List[Tuple[Tuple[int, ...], Any, Any, Any]]:
        """[(weight shape, stride, dilation, (pad_h, pad_w))] per conv."""
        kh, kw = self.kernel_size
        out: List = [((self.filters, 1 if self.magnitude else 2, kh, kw),
                      (1, 1), (1, 1), (get_padding(kh), get_padding(kw)))]
        in_chs = min(self.filters, self.max_filters)
        for i, d in enumerate(self.dilations):
            out_chs = min(self.filters_scale ** i * self.filters,
                          self.max_filters)
            out.append(((out_chs, in_chs, kh, kw), tuple(self.stride),
                        (d, 1), (get_padding(kh, d), get_padding(kw))))
            in_chs = out_chs
        out_chs = min(self.filters_scale ** len(self.dilations)
                      * self.filters, self.max_filters)
        sq = (get_padding(kh), get_padding(kh))
        out.append(((out_chs, in_chs, kh, kh), (1, 1), (1, 1), sq))
        out.append(((1, out_chs, kh, kh), (1, 1), (1, 1), sq))  # conv_post
        return out

    def init(self, gen: torch.Generator) -> Params:
        return {"convs": [_init_conv(gen, s[0], self.norm)
                          for s in self._layer_shapes()]}

    def apply(self, params: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: [B, 1, T] -> (logits [B, 1, H, W], fmaps); the complex STFT
        enters as [B, 2, Time, Freq]."""
        spec = _stft_nopad(x, self.n_fft, self.hop_length, self.win_length)
        if self.normalized:
            n = np.arange(self.win_length)
            win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / self.win_length)
            spec = spec / math.sqrt(float((win ** 2).sum()))
        if self.magnitude:
            z = torch.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2)
            z = z.transpose(1, 2)[:, None]              # [B, 1, Time, Freq]
            if self.log_magnitude:
                z = torch.log(z + self.eps)
        else:
            z = spec.permute(0, 3, 2, 1)                # [B, 2, Time, Freq]
        fmap = []
        shapes = self._layer_shapes()
        for i, (p, (_, stride, dil, pad)) in enumerate(
                zip(params["convs"], shapes)):
            z = F.conv2d(z, R.compute_weight(p, self.norm), p.get("b"),
                         stride, pad, dil)
            if i < len(shapes) - 1:     # all but conv_post: act + fmap
                z = F.leaky_relu(z, self.activation_slope)
                fmap.append(z)
        return z, fmap


def _stft_nopad(x: torch.Tensor, n_fft: int, hop: int,
                win: int) -> torch.Tensor:
    """torchaudio Spectrogram(center=False, pad=0, power=None): the framed
    rfft from sample 0 -> [B, F, L, 2] (re, im)."""
    if x.ndim == 3:
        x = x.squeeze(1)
    window = S.hann_window(win, x.device)
    if win < n_fft:
        window = F.pad(window, ((n_fft - win) // 2, (n_fft - win + 1) // 2))
    frames = S.frame(x, n_fft, hop) * window
    spec = torch.fft.rfft(frames.float(), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)   # [B, L, F, 2]
    return out.to(x.dtype).transpose(1, 2)              # [B, F, L, 2]


@dataclasses.dataclass(frozen=True)
class MultiSTFTDiscriminator:
    filters: int
    n_ffts: Tuple[int, ...] = (1024, 2048, 512, 256, 128)
    hop_lengths: Tuple[int, ...] = (256, 512, 128, 64, 32)
    win_lengths: Tuple[int, ...] = (1024, 2048, 512, 256, 128)
    filters_scale: int = 1
    magnitude: bool = False
    log_magnitude: bool = False   # only applies to the magnitude branch
    eps: float = 1e-5
    norm: str = R.WEIGHT_NORM

    def __post_init__(self):
        object.__setattr__(self, "discs", tuple(
            STFTDiscriminator(self.filters, n_fft=n, hop_length=h,
                              win_length=w, filters_scale=self.filters_scale,
                              magnitude=self.magnitude,
                              log_magnitude=self.log_magnitude,
                              eps=self.eps, norm=self.norm)
            for n, h, w in zip(self.n_ffts, self.hop_lengths,
                               self.win_lengths)))

    def init(self, gen: torch.Generator) -> Params:
        return {"discs": [d.init(gen) for d in self.discs]}

    def apply(self, params: Params, x: torch.Tensor):
        return _gather(self.discs, params["discs"], x)


def _gather(discs, params, x):
    logits, fmaps = [], []
    for d, p in zip(discs, params):
        lg, fm = d.apply(p, x)
        logits.append(lg)
        fmaps.extend(fm)
    return logits, fmaps


# ---------------------------------------------------------------------------
# Filter-bank discriminator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FilterBankDiscriminator:
    """One PQMF bank of `period` bands, (1, k) convs strided along time."""
    period: int
    taps: int = 0
    beta: float = 0.0
    cutoff_freq: float = 0.0
    kernel_sizes: Tuple[int, ...] = (5, 5, 5, 5, 5)
    strides: Tuple[int, ...] = (3, 3, 3, 3, 1)
    channels: Tuple[int, ...] = (32, 128, 512, 1024, 1024)
    norm: str = R.WEIGHT_NORM

    def init(self, gen: torch.Generator) -> Params:
        convs, c_in = [], 1
        for ch, k in zip(self.channels, self.kernel_sizes):
            convs.append(_init_conv(gen, (ch, c_in, 1, k), self.norm))
            c_in = ch
        return {"convs": convs,
                "post": _init_conv(gen, (1, c_in, 1, 3), self.norm)}

    def apply(self, params: Params, x: torch.Tensor):
        """x: [B, 1, T] -> (logits [B, H*W'], fmaps [B, C, H, W'] each),
        H = period bands of T/period samples."""
        if self.period == 1:
            z = x[:, None]                          # [B, 1, 1, T]
        else:
            z = P.analysis(x, self.period, self.taps, self.cutoff_freq,
                           self.beta)[:, None]      # [B, 1, period, T']
        B, _, H, W = z.shape

        def to4d(y):
            return y.reshape(B, H, y.shape[1], y.shape[2]).transpose(1, 2)

        y = z.transpose(1, 2).reshape(B * H, 1, W)
        fmap = []
        for p, k, s in zip(params["convs"], self.kernel_sizes, self.strides):
            w = R.compute_weight(p, self.norm)
            y = F.leaky_relu(F.conv1d(y, w[:, :, 0, :], p.get("b"), s,
                                      get_padding(k)), LRELU_SLOPE)
            fmap.append(to4d(y))
        w = R.compute_weight(params["post"], self.norm)
        z = to4d(F.conv1d(y, w[:, :, 0, :], params["post"].get("b"), 1, 1))
        fmap.append(z)
        return z.reshape(B, -1), fmap


@dataclasses.dataclass(frozen=True)
class MultiFilterBankDiscriminator:
    periods: Tuple[int, ...] = (1, 2, 3, 5, 7, 11)
    taps: int = 256
    beta: float = 8.0
    cutoff_freqs: Tuple[float, ...] = (0, 0.253881, 0.170546, 0.103881,
                                       0.075310, 0.049338)
    kernel_sizes: Tuple[int, ...] = (5, 5, 5, 5, 5)
    strides: Tuple[int, ...] = (3, 3, 3, 3, 1)
    channels: Tuple[int, ...] = (32, 128, 512, 1024, 1024)
    norm: str = R.WEIGHT_NORM

    def __post_init__(self):
        object.__setattr__(self, "discs", tuple(
            FilterBankDiscriminator(p, self.taps, self.beta, c,
                                    tuple(self.kernel_sizes),
                                    tuple(self.strides),
                                    tuple(self.channels), self.norm)
            for p, c in zip(self.periods, self.cutoff_freqs)))

    def init(self, gen: torch.Generator) -> Params:
        return {"discs": [d.init(gen) for d in self.discs]}

    def apply(self, params: Params, x: torch.Tensor):
        return _gather(self.discs, params["discs"], x)



# ---------------------------------------------------------------------------
# Multi-period discriminator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PeriodDiscriminator:
    """HiFi-GAN's period discriminator: x reflect-padded to a multiple of
    `period`, folded to [B, c, T/period, period], (k, 1) conv2ds strided
    along time. As in JAX, the four strided convs pad by
    get_padding(5) whatever `kernel_size` is, the fifth by 2."""
    period: int
    kernel_size: int = 5
    stride: int = 3
    norm: str = R.WEIGHT_NORM

    _CHANNELS = (32, 128, 512, 1024, 1024)

    def init(self, gen: torch.Generator) -> Params:
        convs, c_in = [], 1
        for ch in self._CHANNELS:
            convs.append(_init_conv(gen, (ch, c_in, self.kernel_size, 1),
                                    self.norm))
            c_in = ch
        return {"convs": convs,
                "post": _init_conv(gen, (1, c_in, 3, 1), self.norm)}

    def apply(self, params: Params, x: torch.Tensor):
        B, c, t = x.shape
        if t % self.period:
            pad = self.period - t % self.period
            x = F.pad(x, (0, pad), mode="reflect")
            t += pad
        z = x.reshape(B, c, t // self.period, self.period)
        fmap = []
        for i, p in enumerate(params["convs"]):
            s, pad_h = (self.stride, get_padding(5)) if i < 4 else (1, 2)
            z = F.leaky_relu(F.conv2d(z, R.compute_weight(p, self.norm),
                                      p.get("b"), (s, 1), (pad_h, 0)),
                             LRELU_SLOPE)
            fmap.append(z)
        p = params["post"]
        z = F.conv2d(z, R.compute_weight(p, self.norm), p.get("b"), 1,
                     (1, 0))
        fmap.append(z)
        return z.reshape(B, -1), fmap


@dataclasses.dataclass(frozen=True)
class MultiPeriodDiscriminator:
    kernel_size: int = 5
    stride: int = 3
    norm: str = R.WEIGHT_NORM
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)

    def __post_init__(self):
        object.__setattr__(self, "discs", tuple(
            PeriodDiscriminator(p, self.kernel_size, self.stride, self.norm)
            for p in self.periods))

    def init(self, gen: torch.Generator) -> Params:
        return {"discs": [d.init(gen) for d in self.discs]}

    def apply(self, params: Params, x: torch.Tensor):
        return _gather(self.discs, params["discs"], x)


# ---------------------------------------------------------------------------
# Multi-scale discriminator
# ---------------------------------------------------------------------------

_MSD_SPECS = (
    # (cout, k, stride, groups, pad)
    (128, 15, 1, 1, 7),
    (128, 41, 2, 4, 20),
    (256, 41, 2, 16, 20),
    (512, 41, 4, 16, 20),
    (1024, 41, 4, 16, 20),
    (1024, 41, 1, 16, 20),
    (1024, 5, 1, 1, 2),
)


@dataclasses.dataclass(frozen=True)
class ScaleDiscriminator:
    norm: str = R.WEIGHT_NORM

    def init(self, gen: torch.Generator) -> Params:
        convs, c_in = [], 1
        for ch, k, _s, g, _p in _MSD_SPECS:
            convs.append(_init_conv(gen, (ch, c_in // g, k), self.norm))
            c_in = ch
        return {"convs": convs,
                "post": _init_conv(gen, (1, c_in, 3), self.norm)}

    def apply(self, params: Params, x: torch.Tensor):
        fmap, z = [], x
        for p, (_ch, _k, s, g, pad) in zip(params["convs"], _MSD_SPECS):
            z = F.leaky_relu(F.conv1d(z, R.compute_weight(p, self.norm),
                                      p.get("b"), s, pad, groups=g),
                             LRELU_SLOPE)
            fmap.append(z)
        p = params["post"]
        z = F.conv1d(z, R.compute_weight(p, self.norm), p.get("b"),
                     padding=1)
        fmap.append(z)
        return z.reshape(z.shape[0], -1), fmap


def _avg_pool1d(x: torch.Tensor) -> torch.Tensor:
    """torch AvgPool1d(4, 2, padding=1): the pads count in the mean."""
    return F.avg_pool1d(x, 4, 2, padding=1, count_include_pad=True)


@dataclasses.dataclass(frozen=True)
class MultiScaleDiscriminator:
    """Three scale discriminators on x, x pooled once and twice (or, with
    use_pqmf, the first band of a 2- and a 4-band PQMF); norm None gives
    the scales [spectral, weight, weight] norm."""
    norm: Optional[str] = None
    use_pqmf: bool = False

    def __post_init__(self):
        norms = ([R.SPECTRAL_NORM, R.WEIGHT_NORM, R.WEIGHT_NORM]
                 if self.norm is None else [self.norm] * 3)
        object.__setattr__(self, "discs",
                           tuple(ScaleDiscriminator(n) for n in norms))

    def init(self, gen: torch.Generator) -> Params:
        return {"discs": [d.init(gen) for d in self.discs]}

    def _pool(self, x: torch.Tensor, idx: int) -> torch.Tensor:
        if idx == 0:
            return x
        if self.use_pqmf:
            return P.analysis(x, 2 ** idx, 256, 0.25 / 2 ** (idx - 1),
                              8.0)[:, :1]
        y = _avg_pool1d(x)
        return _avg_pool1d(y) if idx == 2 else y

    def apply(self, params: Params, x: torch.Tensor):
        logits, fmaps = [], []
        for i, (d, p) in enumerate(zip(self.discs, params["discs"])):
            lg, fm = d.apply(p, self._pool(x, i))
            logits.append(lg)
            fmaps.extend(fm)
        return logits, fmaps


# ---------------------------------------------------------------------------
# Sub-band discriminator
# ---------------------------------------------------------------------------

def _lrelu02(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


@dataclasses.dataclass(frozen=True)
class MDC:
    """Multi-dilation conv block: parallel dilated convs summed, then a
    strided post conv. As in the reference, the post conv pads with the
    *last* dilated conv's padding."""
    in_channels: int
    out_channels: int
    strides: int
    kernel_size: Tuple[int, ...]
    dilations: Tuple[int, ...]
    norm: str = R.WEIGHT_NORM

    def init(self, gen: torch.Generator) -> Params:
        return {"convs": [_init_conv(gen, (self.out_channels,
                                           self.in_channels, k), self.norm)
                          for k in self.kernel_size],
                "post": _init_conv(gen, (self.out_channels,
                                         self.out_channels, 3), self.norm)}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        out = None
        for p, k, d in zip(params["convs"], self.kernel_size,
                           self.dilations):
            y = _lrelu02(F.conv1d(x, R.compute_weight(p, self.norm),
                                  p.get("b"), dilation=d,
                                  padding=get_padding(k, d)))
            out = y if out is None else out + y
        pad = get_padding(self.kernel_size[-1], self.dilations[-1])
        p = params["post"]
        return _lrelu02(F.conv1d(out, R.compute_weight(p, self.norm),
                                 p.get("b"), stride=self.strides,
                                 padding=pad))


@dataclasses.dataclass(frozen=True)
class SBDBlock:
    segment_dim: int
    strides: Tuple[int, ...]
    filters: Tuple[int, ...]
    kernel_size: Tuple[Tuple[int, ...], ...]
    dilations: Tuple[Tuple[int, ...], ...]
    norm: str = R.WEIGHT_NORM

    def __post_init__(self):
        mdcs, c_in = [], self.segment_dim
        for s, f, k, d in zip(self.strides, self.filters, self.kernel_size,
                              self.dilations):
            mdcs.append(MDC(c_in, f, s, tuple(k), tuple(d), self.norm))
            c_in = f
        object.__setattr__(self, "mdcs", tuple(mdcs))

    def init(self, gen: torch.Generator) -> Params:
        return {"mdcs": [m.init(gen) for m in self.mdcs],
                "post": _init_conv(gen, (1, self.filters[-1], 3),
                                   self.norm)}

    def apply(self, params: Params, x: torch.Tensor):
        fmap = []
        for m, p in zip(self.mdcs, params["mdcs"]):
            x = m.apply(p, x)
            fmap.append(x)
        p = params["post"]
        x = F.conv1d(x, R.compute_weight(p, self.norm), p.get("b"),
                     padding=1)
        return x, fmap


@dataclasses.dataclass(frozen=True)
class SBD:
    """Sub-band discriminator over the PQMF bands `band_ranges` of x; a
    `transpose` block takes time-bands of a finer PQMF (`f_pqmf_kwargs`)
    instead, its segment axis as channels, so its input must be
    `segment_size` samples long."""
    channels: Tuple[Tuple[int, ...], ...]
    strides: Tuple[Tuple[int, ...], ...]
    kernel_sizes: Tuple[Tuple[Tuple[int, ...], ...], ...]
    dilations: Tuple[Tuple[Tuple[int, ...], ...], ...]
    band_ranges: Tuple[Tuple[int, int], ...]
    transpose: Tuple[bool, ...]
    pqmf_kwargs: Dict[str, Any]
    f_pqmf_kwargs: Optional[Dict[str, Any]] = None
    segment_size: Optional[int] = None
    norm: str = R.WEIGHT_NORM
    # the orthonormal PQMF (x sqrt(subbands)), or Avocodo's unscaled
    # ParallelWaveGAN bank (False)
    pqmf_orthonormal: bool = True

    def __post_init__(self):
        blocks = []
        for c, k, d, s, br, tr in zip(self.channels, self.kernel_sizes,
                                      self.dilations, self.strides,
                                      self.band_ranges, self.transpose):
            seg = (self.segment_size // br[1] - br[0] if tr
                   else br[1] - br[0])
            blocks.append(SBDBlock(seg, tuple(s), tuple(c),
                                   tuple(tuple(x) for x in k),
                                   tuple(tuple(x) for x in d), self.norm))
        object.__setattr__(self, "blocks", tuple(blocks))

    def init(self, gen: torch.Generator) -> Params:
        return {"blocks": [b.init(gen) for b in self.blocks]}

    def _pqmf(self, x: torch.Tensor, kwargs: Dict[str, Any]) -> torch.Tensor:
        return P.analysis(x, kwargs.get("subbands", 4),
                          kwargs.get("taps", 62),
                          kwargs.get("cutoff_freq",
                                     kwargs.get("cutoff_ratio", 0.142)),
                          kwargs.get("beta", 9.0),
                          orthonormal=self.pqmf_orthonormal)

    def apply(self, params: Params, x: torch.Tensor):
        logits, fmaps = [], []
        y_in = self._pqmf(x, self.pqmf_kwargs)
        y_in_f = None
        for b, p, br, tr in zip(self.blocks, params["blocks"],
                                self.band_ranges, self.transpose):
            if tr:
                if y_in_f is None:
                    y_in_f = self._pqmf(x, self.f_pqmf_kwargs or {})
                z = y_in_f[:, br[0]:br[1], :].transpose(1, 2)
            else:
                z = y_in[:, br[0]:br[1], :]
            lg, fm = b.apply(p, z)
            logits.append(lg)
            fmaps.extend(fm)
        return logits, fmaps


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------

def _clean(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Drop `use`; YAML lists -> tuples for the hashable dataclasses."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    return {k: tup(v) for k, v in kwargs.items() if k != "use"}


@dataclasses.dataclass(frozen=True)
class Discriminators:
    """The families switched on by their `use:` flags, keyed mfbd, mpd,
    msd, mstftd and sbd, in that order."""
    mfbd_kwargs: Optional[Dict[str, Any]] = None
    mpd_kwargs: Optional[Dict[str, Any]] = None
    msd_kwargs: Optional[Dict[str, Any]] = None
    mstftd_kwargs: Optional[Dict[str, Any]] = None
    sbd_kwargs: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        discs = {}
        for name, kw, cls in (
                ("mfbd", self.mfbd_kwargs, MultiFilterBankDiscriminator),
                ("mpd", self.mpd_kwargs, MultiPeriodDiscriminator),
                ("msd", self.msd_kwargs, MultiScaleDiscriminator),
                ("mstftd", self.mstftd_kwargs, MultiSTFTDiscriminator),
                ("sbd", self.sbd_kwargs, SBD)):
            if kw and kw.get("use", False):
                discs[name] = cls(**_clean(kw))
        object.__setattr__(self, "discs", discs)

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        """Seeded init: draws on the CPU from `gen`, then moves to device."""
        return params_to({name: d.init(gen)
                          for name, d in self.discs.items()}, device)

    def apply(self, params: Params, x: torch.Tensor
              ) -> Tuple[Dict[str, List[torch.Tensor]],
                         Dict[str, List[torch.Tensor]]]:
        logits, fmaps = {}, {}
        for name, d in self.discs.items():
            logits[name], fmaps[name] = d.apply(params[name], x)
        return logits, fmaps
