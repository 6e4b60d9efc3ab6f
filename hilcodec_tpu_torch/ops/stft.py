"""STFT helpers (`hilcodec_tpu/ops/stft.py`).

`causal_stft_mag` is the SpecBlocks' causal magnitude STFT: framing plus
one matmul against the windowed cos/sin DFT basis, in f32. `pad=True`
left-pads n_fft-1 zeros (batch mode); `pad=False` expects the caller to
supply the n_fft-1 samples of history (streaming mode). `hann_window` and
`frame` serve the training losses and the STFT discriminator.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .conv import row_matmul


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
