"""MDCT / short-time DCT transforms (`hilcodec_tpu/ops/mdct.py`).

The DCT-II short-time transform (`stdct` / `istdct`) with a windowed
filterbank and the window-square normalization of its overlap-add, and the
MDCT / IMDCT pair with the cos((pi/N)(n + 0.5 + N/2)(k + 0.5)) basis. The
filterbanks are numpy constants (`dct_filter`, `mdct_filter`); the
transforms are framed matmuls in f32 and overlap-adds. No ported path calls
them: they are kept with their JAX counterparts.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stft import frame, hann_window_np


@lru_cache(maxsize=None)
def dct_filter(N: int, win_size: Optional[int] = None,
               win_type: Optional[str] = "hann"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """([N, N] windowed orthonormal DCT-II basis, [N] window): the Hann of
    win_size centred in N, or ones for win_type None."""
    if win_size is None:
        win_size = N
    if win_type is None:
        window = np.ones(N, np.float32)
    else:
        window = hann_window_np(win_size)
        pad = N - win_size
        window = np.pad(window, (pad // 2, pad - pad // 2))
    n = np.arange(N)[None, :]
    k = np.arange(N)[:, None]
    basis = np.cos(math.pi / N * k * (n + 0.5)) * math.sqrt(2.0 / N)
    basis[0] /= math.sqrt(2)
    return ((basis * window[None, :]).astype(np.float32),
            window.astype(np.float32))


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[B, T, N] frames at stride hop -> [B, hop*(T-1) + N]."""
    B, T, N = frames.shape
    idx = (torch.arange(T, device=frames.device)[:, None] * hop
           + torch.arange(N, device=frames.device)[None, :]).reshape(-1)
    return frames.new_zeros((B, hop * (T - 1) + N)).index_add_(
        1, idx, frames.reshape(B, -1))


def stdct(y: torch.Tensor, N: int, hop_size: int,
          win_size: Optional[int] = None, center: bool = False,
          win_type: Optional[str] = "hann") -> torch.Tensor:
    """Short-time DCT-II: [B, 1, hop*T] (or [B, hop*T]) -> [B, N, T]."""
    if y.ndim == 3:
        y = y.squeeze(1)
    basis, _ = dct_filter(N, win_size, win_type)
    pad = N // 2 if center else (N - hop_size) // 2
    y = F.pad(y, (pad, pad))
    frames = frame(y, N, hop_size).float()                # [B, T, N]
    out = torch.einsum("btn,kn->bkt", frames,
                       torch.from_numpy(basis).to(y.device))
    return out.to(y.dtype)


def istdct(y: torch.Tensor, N: int, hop_size: int,
           win_size: Optional[int] = None, center: bool = False,
           win_type: Optional[str] = "hann") -> torch.Tensor:
    """Inverse STDCT with the window-square normalization of the
    overlap-add: [B, N, T] -> [B, 1, hop*T']."""
    basis, window = dct_filter(N, win_size, win_type)
    pad = N // 2 if center else (N - hop_size) // 2
    T = y.shape[-1]
    frames = torch.einsum("bkt,kn->btn", y.float(),
                          torch.from_numpy(basis).to(y.device))
    sig = _overlap_add(frames, hop_size)
    out_len = sig.shape[-1]
    idx = (np.arange(T)[:, None] * hop_size + np.arange(N)[None, :]).ravel()
    wsq = np.zeros(out_len, np.float64)
    np.add.at(wsq, idx, np.tile(window.astype(np.float64) ** 2, T))
    sig = sig[:, pad:out_len - pad]
    wsq = wsq[pad:out_len - pad]
    if not (wsq != 0).all():
        raise ValueError("the window violates NOLA: an output sample has "
                         "no window weight")
    return (sig / torch.from_numpy(wsq.astype(np.float32)).to(y.device)
            )[:, None, :]


@lru_cache(maxsize=None)
def mdct_filter(N: int) -> np.ndarray:
    """[N, 2N] MDCT basis cos(pi/N (n + 0.5 + N/2)(k + 0.5))."""
    k = np.arange(N)[:, None]
    n = np.arange(2 * N)[None, :]
    return np.cos(math.pi / N * (n + 0.5 + N / 2) * (k + 0.5)).astype(
        np.float32)


def mdct(y: torch.Tensor, N: int, normalize: bool = False) -> torch.Tensor:
    """[B, 1, N*T] -> [B, N, T+1] (pad N both sides, stride N)."""
    if y.ndim == 3:
        y = y.squeeze(1)
    basis = mdct_filter(N)
    if normalize:
        basis = basis / math.sqrt(N)
    y = F.pad(y, (N, N))
    frames = frame(y, 2 * N, N).float()
    out = torch.einsum("btn,kn->bkt", frames,
                       torch.from_numpy(basis).to(y.device))
    return out.to(y.dtype)


def imdct(y: torch.Tensor, N: int, normalize: bool = False) -> torch.Tensor:
    """[B, N, T+1] -> [B, 1, N*T] by the transposed overlap-add (the
    reference's conv_transpose1d at stride N, padding N)."""
    basis = mdct_filter(N)
    basis = basis / math.sqrt(N) if normalize else basis / N
    frames = torch.einsum("bkt,kn->btn", y.float(),
                          torch.from_numpy(basis).to(y.device))
    sig = _overlap_add(frames, N)
    return sig[:, N:sig.shape[-1] - N][:, None, :]
