"""Training losses (`hilcodec_tpu/models/losses.py`): multi-resolution mel
(and its memory-lean `MelGradLoss`), Avocodo's single-resolution HiFi-GAN
mel, GAN hinge / least-squares, feature matching.

The GAN and feature losses take dicts `{name: [tensors]}` of the
discriminators' logits or feature maps and return the loss dict keyed
`freq`, `{name}_g`, `{name}_fm` that the balancer consumes.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops import mel as M
from ..ops import stft as S

DiscOutput = Dict[str, List[torch.Tensor]]
LossOutput = Dict[str, torch.Tensor]


def mel_scale_htk(f: float) -> float:
    return 2595.0 * math.log10(1.0 + f / 700.0)


@lru_cache(maxsize=None)
def _basis(sr: int, n_fft: int, n_mels: int,
           device: torch.device) -> torch.Tensor:
    """Slaney-normed HTK mel basis [n_mels, n_fft//2+1], once per device."""
    return torch.from_numpy(M.mel_filterbank(
        sr, n_fft, n_mels, norm="slaney", htk=True)).to(device)


def _mel_spec_power(x: torch.Tensor, n_fft: int, hop: int,
                    basis: torch.Tensor) -> torch.Tensor:
    """torchaudio MelSpectrogram(center=False, power=2): no padding,
    hann(n_fft), power spectrum, mel matmul. [B, 1, T] -> [B, n_mels, L]."""
    if x.ndim == 3:
        x = x.squeeze(1)
    frames = S.frame(x, n_fft, hop) * S.hann_window(n_fft, x.device)
    spec = torch.fft.rfft(frames.float(), dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(-1, -2)  # [B, F, L]
    return torch.einsum("mf,bfl->bml", basis, power)


@dataclasses.dataclass(frozen=True)
class MelLoss:
    """Multi-resolution L1 + MSE log-mel loss: n_fft = 2^5 .. 2^10, hop
    n_fft/4, HTK mel scale with Slaney norm, power-2 spectrogram. The
    generated side's clamp at clip_val is straight-through: clipped bins
    take the value clip_val and pass the gradient unchanged."""
    sampling_rate: int
    clip_val: float = 1.0e-5
    no_zero: bool = True
    n_mels_max: int = 80

    def __post_init__(self):
        transforms = []
        for i in range(5, 11):
            s = 2 ** i
            if self.no_zero:
                n_mels = int(min(
                    self.n_mels_max,
                    2 * mel_scale_htk(self.sampling_rate / 2)
                    / mel_scale_htk(self.sampling_rate / s) - 1,
                    s // 4))
            else:
                n_mels = min(self.n_mels_max, s // 4)
            transforms.append((s, s // 4, n_mels))
        object.__setattr__(self, "transforms", tuple(transforms))

    def basis(self, n_fft: int, n_mels: int,
              device: torch.device) -> torch.Tensor:
        return _basis(self.sampling_rate, n_fft, n_mels, device)

    def __call__(self, wav_g: torch.Tensor,
                 wav_r: torch.Tensor) -> LossOutput:
        loss = torch.zeros((), device=wav_g.device)
        for n_fft, hop, n_mels in self.transforms:
            basis = self.basis(n_fft, n_mels, wav_g.device)
            mel_g = _mel_spec_power(wav_g, n_fft, hop, basis)
            mel_g = torch.where(mel_g >= self.clip_val, mel_g,
                                mel_g - mel_g.detach() + self.clip_val)
            mel_g = torch.log(mel_g)
            with torch.no_grad():
                mel_r = torch.log(torch.clamp(
                    _mel_spec_power(wav_r, n_fft, hop, basis),
                    min=self.clip_val))
            diff = mel_g - mel_r
            loss = loss + torch.mean(torch.square(diff)) \
                + torch.mean(torch.abs(diff))
        return {"freq": loss}


class _MelGradTerm(torch.autograd.Function):
    """L1 + MSE of the clipped log-mels, whose gradient with respect to
    the generated side's *linear* mel is (log_mel_g - log_mel_r) / numel
    times the incoming gradient (JAX's `custom_vjp`): deliberately not the
    gradient through the log."""

    @staticmethod
    def forward(ctx, mel_g, mel_r, clip_val):
        lg = torch.log(torch.clamp(mel_g, min=clip_val))
        lr = torch.log(torch.clamp(mel_r, min=clip_val))
        d = lg - lr
        ctx.save_for_backward(d / d.numel())
        return torch.mean(torch.abs(d)) + torch.mean(torch.square(d))

    @staticmethod
    def backward(ctx, grad):
        (g,) = ctx.saved_tensors
        return grad * g, None, None


@dataclasses.dataclass(frozen=True)
class MelGradLoss:
    """The memory-lean multi-resolution mel loss: MelLoss's value on a
    magnitude (power-1) STFT and a Slaney-scale mel basis (`mel_norm`
    configurable, none by default), with `_MelGradTerm`'s gradient.
    n_fft = 2^5 .. 2^10, hop n_fft/4, the loss STFT (`ops/stft.stft`,
    center=False); the real side takes no gradient."""
    sampling_rate: int
    clip_val: float = 1.0e-5
    n_mels_max: int = 80
    mel_norm: Optional[str] = None

    def __post_init__(self):
        transforms = []
        for i in range(5, 11):
            s = 2 ** i
            n_mels = int(min(
                self.n_mels_max,
                2 * mel_scale_htk(self.sampling_rate / 2)
                / mel_scale_htk(self.sampling_rate / s) - 1,
                s // 4))
            transforms.append((s, s // 4, n_mels))
        object.__setattr__(self, "transforms", tuple(transforms))

    def basis(self, n_fft: int, n_mels: int,
              device: torch.device) -> torch.Tensor:
        return _mel_grad_basis(self.sampling_rate, n_fft, n_mels,
                               self.mel_norm, device)

    def _mel(self, x: torch.Tensor, n_fft: int, hop: int,
             basis: torch.Tensor) -> torch.Tensor:
        mag = S.stft(x, n_fft, hop, n_fft, center=False, magnitude=True)
        return torch.einsum("mf,bfl->bml", basis.to(mag.dtype), mag)

    def __call__(self, wav_g: torch.Tensor,
                 wav_r: torch.Tensor) -> LossOutput:
        loss = torch.zeros((), device=wav_g.device)
        for n_fft, hop, n_mels in self.transforms:
            basis = self.basis(n_fft, n_mels, wav_g.device)
            mel_g = self._mel(wav_g, n_fft, hop, basis)
            with torch.no_grad():
                mel_r = self._mel(wav_r, n_fft, hop, basis)
            loss = loss + _MelGradTerm.apply(mel_g, mel_r, self.clip_val)
        return {"freq": loss}


@lru_cache(maxsize=None)
def _mel_grad_basis(sr: int, n_fft: int, n_mels: int, norm: Optional[str],
                    device: torch.device) -> torch.Tensor:
    """Slaney-scale mel basis with `norm`, once per device."""
    return torch.from_numpy(M.mel_filterbank(
        sr, n_fft, n_mels, norm=norm, htk=False)).to(device)


@lru_cache(maxsize=None)
def _slaney_basis(sr: int, n_fft: int, n_mels: int, fmin: float,
                  fmax, device: torch.device) -> torch.Tensor:
    """Slaney-scale, Slaney-normed mel basis [n_mels, n_fft//2+1], once
    per device."""
    return torch.from_numpy(M.mel_filterbank(
        sr, n_fft, n_mels, fmin, fmax, norm="slaney", htk=False)).to(device)


@dataclasses.dataclass(frozen=True)
class HifiGANMelLoss:
    """Single-resolution L1 log-mel loss: the reference loss STFT
    (`ops/stft.stft`, magnitude), a Slaney mel basis, log of the mel
    clamped at clip_val."""
    sampling_rate: int
    clip_val: float
    n_fft: int
    num_mels: int
    hop_size: int
    win_size: int
    fmin: float = 0.0
    fmax: Optional[float] = None

    def _logmel(self, x: torch.Tensor) -> torch.Tensor:
        mag = S.stft(x, self.n_fft, self.hop_size, self.win_size,
                     center=False, magnitude=True)
        basis = _slaney_basis(self.sampling_rate, self.n_fft, self.num_mels,
                              self.fmin, self.fmax, x.device)
        mel = torch.einsum("mf,bfl->bml", basis.to(mag.dtype), mag)
        return torch.log(torch.clamp(mel, min=self.clip_val))

    def __call__(self, wav_g: torch.Tensor,
                 wav_r: torch.Tensor) -> LossOutput:
        return {"freq": torch.mean(torch.abs(self._logmel(wav_g)
                                             - self._logmel(wav_r)))}


def discriminator_loss(logits_g: DiscOutput, logits_r: DiscOutput,
                       normalize: bool = True) -> torch.Tensor:
    """Hinge loss over all logit tensors (mean over them if normalize)."""
    loss, n = 0.0, 0
    for name in logits_g:
        for lg, lr in zip(logits_g[name], logits_r[name]):
            loss = loss + torch.mean(F.relu(1.0 - lr)) \
                + torch.mean(F.relu(1.0 + lg))
            n += 1
    return loss / n if normalize else loss


def discriminator_loss_lsgan(logits_g: DiscOutput, logits_r: DiscOutput,
                             normalize: bool = True) -> torch.Tensor:
    loss, n = 0.0, 0
    for name in logits_g:
        for lg, lr in zip(logits_g[name], logits_r[name]):
            loss = loss + torch.mean(torch.square(1.0 - lr)) \
                + torch.mean(torch.square(lg))
            n += 1
    return loss / n if normalize else loss


def generator_loss(logits: DiscOutput, normalize: bool = True) -> LossOutput:
    out: LossOutput = {}
    for name, lgs in logits.items():
        loss = sum(torch.mean(F.relu(1.0 - lg)) for lg in lgs)
        out[f"{name}_g"] = loss / len(lgs) if normalize else loss
    return out


def generator_loss_lsgan(logits: DiscOutput,
                         normalize: bool = True) -> LossOutput:
    out: LossOutput = {}
    for name, lgs in logits.items():
        loss = sum(torch.mean(torch.square(1.0 - lg)) for lg in lgs)
        out[f"{name}_g"] = loss / len(lgs) if normalize else loss
    return out


def feature_loss(fmaps_g: DiscOutput, fmaps_r: DiscOutput,
                 normalize: bool = True) -> LossOutput:
    out: LossOutput = {}
    for name in fmaps_g:
        loss = sum(torch.mean(torch.abs(g - r.detach()))
                   for g, r in zip(fmaps_g[name], fmaps_r[name]))
        out[f"{name}_fm"] = loss / len(fmaps_g[name]) if normalize else loss
    return out


def feature_loss_normalized(fmaps_g: DiscOutput, fmaps_r: DiscOutput,
                            normalize: bool = True) -> LossOutput:
    """L1 feature matching, each map divided by the real activations'
    mean |.|."""
    out: LossOutput = {}
    for name in fmaps_g:
        loss = 0.0
        for g, r in zip(fmaps_g[name], fmaps_r[name]):
            r = r.detach()
            denom = torch.clamp(torch.mean(torch.abs(r)), min=1e-12)
            loss = loss + torch.mean(torch.abs(g - r)) / denom
        out[f"{name}_fm"] = loss / len(fmaps_g[name]) if normalize else loss
    return out

