"""Mel filterbanks in numpy (`hilcodec_tpu/ops/mel.py`).

librosa-compatible triangular filterbanks (Slaney or HTK mel scale, optional
Slaney area norm) and the `no_zero_at_mel_filter` search for the largest
n_mels whose filters are all nonzero. The banks are constants that the
losses move to their device once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def hz_to_mel(f, htk: bool = False):
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    return np.where(above,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    mels)


def mel_to_hz(mels, htk: bool = False):
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    return np.where(above,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None,
                   norm: Optional[str] = "slaney",
                   htk: bool = False) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular filterbank == librosa.filters.mel."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min, mel_max = hz_to_mel(fmin, htk), hz_to_mel(fmax, htk)
    mel_f = mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2), htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported norm: {norm}")
    return weights.astype(np.float32)


def n_mels_without_zero_filters(sr: int, n_fft: int, n_mels_max: int,
                                fmin: float = 0.0,
                                fmax: Optional[float] = None,
                                norm: Optional[str] = "slaney") -> int:
    """Largest n_mels <= n_mels_max such that every mel filter is nonzero."""
    n_mels = min(n_mels_max, n_fft // 2 + 1)
    while n_mels > 1:
        fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, norm)
        if (fb.sum(axis=1) > 0).all():
            return n_mels
        n_mels -= 1
    return n_mels
