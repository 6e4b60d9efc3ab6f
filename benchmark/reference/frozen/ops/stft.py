"""STFT helpers (`hilcodec_tpu/ops/stft.py`).

`causal_stft_mag` is the SpecBlocks' causal magnitude STFT: framing plus
one matmul against the windowed cos/sin DFT basis, in f32. `pad=True`
left-pads n_fft-1 zeros (batch mode); `pad=False` expects the caller to
supply the n_fft-1 samples of history (streaming mode). `hann_window` and
`frame` serve the training losses and the STFT discriminator; `stft` is
the reference loss STFT (reflect-padded, Hann-windowed framed rfft) of
Avocodo's single-resolution mel loss. `causal_stft_mag_learnable` is the
SpecBlock's STFT as a strided conv with an explicit (learnable) basis
(`spec_learnable: True`), and `istft` the centred inverse STFT with the
window-square normalization of the overlap-add (no ported path calls it;
it is kept with its JAX counterpart).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .conv import conv1d, row_matmul


def hann_window_np(win_size: int) -> np.ndarray:
    """Periodic Hann (numpy), matching torch.hann_window(win_size)."""
    n = np.arange(win_size)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(
        np.float32)


@lru_cache(maxsize=None)
def hann_window(win_size: int, device: torch.device = torch.device("cpu")
                ) -> torch.Tensor:
    """Periodic f32 Hann, matching torch.hann_window(win_size); made once
    per device and shared, so callers must not write to it."""
    return torch.from_numpy(hann_window_np(win_size)).to(device)


def frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., L, frame_length] overlapping frames from sample 0."""
    if x.shape[-1] < frame_length:
        raise ValueError(
            f"input length {x.shape[-1]} shorter than frame_length "
            f"{frame_length}; use longer segments (the configs use 24000)")
    return x.unfold(-1, frame_length, hop)


def _padded_window(win_size: int, n_fft: int, device) -> torch.Tensor:
    """The periodic Hann of win_size centred in n_fft zeros."""
    window = hann_window(win_size, device)
    if win_size < n_fft:
        pad = n_fft - win_size
        window = F.pad(window, (pad // 2, pad - pad // 2))
    return window


def stft(x: torch.Tensor, n_fft: int, hop: int, win_size: int,
         center: bool = False, magnitude: bool = True) -> torch.Tensor:
    """The reference loss STFT of [B, T] or [B, 1, T]: reflect-pad
    n_fft // 2 (center) or (n_fft - hop) // 2 on both sides, frame from
    sample 0, periodic Hann of win_size centred in n_fft, rfft in f32.
    Returns [B, F, L] magnitudes or [B, F, L, 2] (re, im)."""
    if x.ndim == 3:
        x = x.squeeze(1)
    p = n_fft // 2 if center else (n_fft - hop) // 2
    x = F.pad(x[:, None], (p, p), mode="reflect")[:, 0]
    window = _padded_window(win_size, n_fft, x.device)
    frames = frame(x, n_fft, hop) * window.to(x.dtype)
    spec = torch.fft.rfft(frames.float(), dim=-1)
    if magnitude:
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2)
        return mag.to(x.dtype).transpose(-1, -2)
    out = torch.stack([spec.real, spec.imag], dim=-1)       # [B, L, F, 2]
    return out.to(x.dtype).transpose(1, 2)                  # [B, F, L, 2]


def causal_stft_basis(n_fft: int, win_size: Optional[int] = None,
                      norm: str = "backward") -> np.ndarray:
    """The [n_fft+2, 1, n_fft] windowed cos/sin conv basis."""
    window = hann_window_np(win_size or n_fft)
    window = np.pad(window, ((n_fft - window.shape[0]) // 2,
                             (n_fft - window.shape[0] + 1) // 2))
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_fft // 2 + 1)[:, None]
    ang = -2.0 * np.pi / n_fft * k * n
    basis = np.concatenate([np.cos(ang), np.sin(ang)], axis=0) * window
    if norm == "forward":
        basis /= n_fft
    elif norm == "ortho":
        basis /= math.sqrt(n_fft)
    return basis[:, None, :].astype(np.float32)


def _causal_basis_t_np(n_fft: int, win_size: Optional[int]) -> np.ndarray:
    """[n_fft, n_fft+2] transposed windowed cos/sin DFT basis."""
    return causal_stft_basis(n_fft, win_size)[:, 0, :].T.copy()


@lru_cache(maxsize=None)
def causal_basis_t(n_fft: int, win_size: Optional[int],
                   device: torch.device) -> torch.Tensor:
    """The transposed basis as a tensor, made once per device."""
    return torch.from_numpy(_causal_basis_t_np(n_fft, win_size)).to(device)


def causal_stft_mag(x: torch.Tensor, n_fft: int, hop: int,
                    win_size: Optional[int] = None, pad: bool = True,
                    eps: float = 1e-12) -> torch.Tensor:
    """[B, T] or [B, 1, T] wav -> [B, n_fft//2+1, L] magnitudes, where
    frame l sees samples (l*hop - n_fft + 1 .. l*hop] of the padded input."""
    if x.ndim == 3:
        x = x.squeeze(1)
    if pad:
        x = F.pad(x, (n_fft - 1, 0))
    if x.shape[-1] < n_fft:
        raise ValueError(f"input length {x.shape[-1]} shorter than "
                         f"frame_length {n_fft}")
    frames = x.float().unfold(-1, n_fft, hop)           # [B, L, n_fft]
    spec = row_matmul(frames, causal_basis_t(n_fft, win_size, x.device))
    f = n_fft // 2 + 1
    re, im = spec[..., :f], spec[..., f:]
    mag = torch.sqrt(torch.clamp(re ** 2 + im ** 2, min=eps))
    return mag.to(x.dtype).transpose(-1, -2)             # [B, F, L]


def causal_stft_mag_learnable(x: torch.Tensor, weight: torch.Tensor,
                              hop: int, pad: bool = True,
                              eps: float = 1e-12) -> torch.Tensor:
    """The causal magnitude STFT through an explicit conv basis
    `weight` [n_fft+2, 1, n_fft] (cos rows, then sin rows; learnable):
    [B, T] or [B, 1, T] -> [B, n_fft//2+1, L] in x's dtype."""
    if x.ndim == 2:
        x = x[:, None, :]
    n_fft = weight.shape[-1]
    if pad:
        x = F.pad(x, (n_fft - 1, 0))
    y = conv1d(x, weight, None, stride=hop)
    B, C, L = y.shape
    y = y.reshape(B, 2, C // 2, L)
    return torch.sqrt(torch.clamp(torch.sum(y * y, dim=1), min=eps))


def istft(spec: torch.Tensor, n_fft: int, hop: int, win_size: int,
          center: bool = True) -> torch.Tensor:
    """The centred inverse STFT: irfft of each frame, Hann-windowed
    overlap-add, divided by the overlap-added squared window (at least
    1e-11). spec: [B, F, L, 2] (re, im) -> [B, (L-1)*hop] f32, as
    torch.istft."""
    if not center:
        raise NotImplementedError("use center=True for istft (the "
                                  "reference's istft is centred only)")
    window = _padded_window(win_size, n_fft, spec.device)
    z = torch.complex(spec[..., 0].float(), spec[..., 1].float())
    frames = torch.fft.irfft(z.transpose(1, 2), n=n_fft, dim=-1) * window
    B, L, _ = frames.shape
    out_len = n_fft + hop * (L - 1)
    idx = (torch.arange(L, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    sig = frames.new_zeros((B, out_len)).index_add_(
        1, idx, frames.reshape(B, -1))
    wsq = frames.new_zeros(out_len).index_add_(
        0, idx, (window ** 2).repeat(L))
    start, end = n_fft // 2, out_len - n_fft // 2
    return sig[:, start:end] / torch.clamp(wsq[start:end], min=1e-11)
