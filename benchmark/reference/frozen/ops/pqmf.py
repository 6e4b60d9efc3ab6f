"""Pseudo-QMF cosine-modulated filterbank (`hilcodec_tpu/ops/pqmf.py`).

Kaiser-window prototype design in numpy; analysis is a strided conv1d with
padding taps//2 on each side, synthesis the matching transposed conv. The
filter-bank discriminator splits the waveform into bands with `analysis`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal.windows import kaiser


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.142,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-window lowpass prototype (taps+1 coefficients)."""
    if taps % 2 or not 0.0 < cutoff_ratio < 1.0:
        raise ValueError(f"need even taps and 0 < cutoff_ratio < 1, got "
                         f"{taps}, {cutoff_ratio}")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio
    return h_i * kaiser(taps + 1, beta)


@lru_cache(maxsize=None)
def pqmf_filter(subbands: int, taps: int = 62, cutoff_ratio: float = 0.142,
                beta: float = 9.0, orthonormal: bool = True) -> np.ndarray:
    """[subbands, 1, taps+1] cosine-modulated analysis bank; orthonormal
    multiplies by sqrt(subbands) (the discriminators' convention)."""
    h = design_prototype_filter(taps, cutoff_ratio, beta)[None, :]
    k = np.arange(subbands, dtype=np.float64)[:, None]
    n = np.arange(taps + 1, dtype=np.float64)[None, :]
    bank = (2.0 * h * np.cos(
        (2 * k + 1) * np.pi / (2 * subbands) * (n - taps / 2)
        + (-1.0) ** k * np.pi / 4))
    if orthonormal:
        bank = bank * subbands ** 0.5
    return bank[:, None, :].astype(np.float32)


@lru_cache(maxsize=None)
def _bank_on(device: torch.device, subbands: int, taps: int,
             cutoff_ratio: float, beta: float,
             orthonormal: bool) -> torch.Tensor:
    return torch.from_numpy(pqmf_filter(subbands, taps, cutoff_ratio, beta,
                                        orthonormal)).to(device)


def _bank(x: torch.Tensor, subbands: int, taps: int, cutoff_ratio: float,
          beta: float, orthonormal: bool = True) -> torch.Tensor:
    """The analysis bank on x's device, made once per device."""
    return _bank_on(x.device, subbands, taps, float(cutoff_ratio),
                    float(beta), orthonormal).to(x.dtype)


def analysis(x: torch.Tensor, subbands: int, taps: int = 62,
             cutoff_ratio: float = 0.142, beta: float = 9.0,
             orthonormal: bool = True) -> torch.Tensor:
    """x: [B, 1, T] (or [B, T]) -> [B, subbands, (T - 1) // subbands + 1]."""
    if x.ndim == 2:
        x = x[:, None, :]
    w = _bank(x, subbands, taps, cutoff_ratio, beta, orthonormal)
    return F.conv1d(x, w, stride=subbands, padding=taps // 2)


def synthesis(x: torch.Tensor, subbands: int, taps: int = 62,
              cutoff_ratio: float = 0.142, beta: float = 9.0) -> torch.Tensor:
    """x: [B, subbands, T'] -> [B, 1, T'*subbands]; conv_transpose1d with
    padding taps//2 and output_padding subbands-1."""
    w = _bank(x, subbands, taps, cutoff_ratio, beta)
    return F.conv_transpose1d(x, w, stride=subbands, padding=taps // 2,
                              output_padding=subbands - 1)
