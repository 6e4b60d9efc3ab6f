"""ViSQOL-style MOS-LQO (NSIM over an ERB-band spectrogram) in pure numpy:
the port's own copy of `hilcodec_tpu/train/visqol_np.py`, the in-env
oracle for ViSQOL (16 kHz speech, 48 kHz audio) when neither the `visqol`
package nor its binary is present.

A structural reimplementation of the ViSQOL v3 similarity pipeline: a
32-band ERB spectrogram (an STFT power spectrogram integrated into ERB
bands, in place of a gammatone filterbank), the reference cut into
patches, each scored against the aligned degraded patch with NSIM, and
the mean NSIM mapped to MOS-LQO by a monotone logistic calibrated on an
AWGN SNR ladder (not the visqol package's SVR model). No patch alignment
search: inputs are assumed sample-aligned. Values are comparable within
this repo and track ViSQOL in ordering; they are not validated against
the upstream binary.
"""

from __future__ import annotations

import numpy as np

N_BANDS = 32
F_MIN = 50.0
WIN_S = 0.080            # ViSQOL analysis window (80 ms)
HOP_S = 0.020            # 20 ms hop
PATCH_FRAMES = 30        # ViSQOL patch length in frames
NSIM_WIN = 3             # local moving-average window for NSIM stats
_FLOOR_DB = -80.0        # neurogram dynamic range below the global peak
# SSIM-style stabilizers scaled to the dB dynamic range L = 80 (the
# standard (0.01 L)^2 / (0.03 L)^2 choice); NSIM runs directly on the
# dB image — unit-rescaling it first makes the structure term cliff-like
# (measured during calibration: the AWGN response collapses 1.0 -> 0.3
# inside a 10 dB SNR window instead of degrading smoothly)
_C1 = (0.01 * -_FLOOR_DB) ** 2
_C2 = (0.03 * -_FLOOR_DB) ** 2


def _erb(f):
    return 21.4 * np.log10(1.0 + 0.00437 * np.asarray(f, np.float64))


def _inv_erb(e):
    return (10.0 ** (np.asarray(e, np.float64) / 21.4) - 1.0) / 0.00437


def _band_matrix(sr: int, n_fft: int) -> np.ndarray:
    """[N_BANDS, n_fft//2+1] rectangular ERB-band integration matrix."""
    edges = _inv_erb(np.linspace(_erb(F_MIN), _erb(sr / 2.0), N_BANDS + 1))
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mat = np.zeros((N_BANDS, freqs.size))
    for b in range(N_BANDS):
        lo, hi = edges[b], edges[b + 1]
        sel = (freqs >= lo) & (freqs < hi)
        if not sel.any():                      # narrow band: nearest bin
            sel = np.zeros_like(sel)
            sel[np.argmin(np.abs(freqs - 0.5 * (lo + hi)))] = True
        mat[b, sel] = 1.0 / sel.sum()
    return mat


def _neurogram(x: np.ndarray, sr: int) -> np.ndarray:
    """[N_BANDS, T] ERB spectrogram in dB, top-referenced to the global
    peak and floored _FLOOR_DB below it, then shifted to [0, -_FLOOR_DB]
    (a positive range so the NSIM luminance term is well-defined)."""
    win = int(round(WIN_S * sr))
    hop = int(round(HOP_S * sr))
    n_fft = 1 << int(np.ceil(np.log2(win)))
    if x.size < win:
        x = np.pad(x, (0, win - x.size))
    n_frames = 1 + (x.size - win) // hop
    idx = (np.arange(win)[None, :]
           + hop * np.arange(n_frames)[:, None])
    frames = x[idx] * np.hamming(win)[None, :]
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2  # [T, F]
    bands = _band_matrix(sr, n_fft) @ spec.T                   # [B, T]
    db = 10.0 * np.log10(np.maximum(bands, 1e-20))
    return np.maximum(db - db.max(), _FLOOR_DB) - _FLOOR_DB


def _box_mean(img: np.ndarray, k: int) -> np.ndarray:
    """Same-size k x k moving average (reflect padding)."""
    p = k // 2
    padded = np.pad(img, p, mode="reflect")
    c = np.cumsum(np.cumsum(padded, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    h, w = img.shape
    return (c[k:k + h, k:k + w] - c[:h, k:k + w]
            - c[k:k + h, :w] + c[:h, :w]) / (k * k)


def nsim(r: np.ndarray, d: np.ndarray) -> float:
    """Mean NSIM between two equal-shape dB-domain neurograms (range
    [0, -_FLOOR_DB]): luminance x structure with k x k local moments
    (Hines & Harte 2012, alpha = beta = 1)."""
    mu_r, mu_d = _box_mean(r, NSIM_WIN), _box_mean(d, NSIM_WIN)
    var_r = np.maximum(_box_mean(r * r, NSIM_WIN) - mu_r ** 2, 0.0)
    var_d = np.maximum(_box_mean(d * d, NSIM_WIN) - mu_d ** 2, 0.0)
    cov = _box_mean(r * d, NSIM_WIN) - mu_r * mu_d
    lum = (2 * mu_r * mu_d + _C1) / (mu_r ** 2 + mu_d ** 2 + _C1)
    struct = (cov + _C2) / (np.sqrt(var_r) * np.sqrt(var_d) + _C2)
    return float(np.mean(lum * np.clip(struct, -1.0, 1.0)))


def _mean_patch_nsim(ref: np.ndarray, deg: np.ndarray, sr: int) -> float:
    n = min(ref.size, deg.size)
    ref, deg = np.asarray(ref, np.float64)[:n], np.asarray(deg, np.float64)[:n]
    # ViSQOL normalizes the degraded level to the reference before
    # similarity (global scale must not read as distortion)
    rp, dp = np.sqrt(np.mean(ref ** 2) + 1e-20), np.sqrt(
        np.mean(deg ** 2) + 1e-20)
    if dp > 0:
        deg = deg * (rp / dp)
    ng_r, ng_d = _neurogram(ref, sr), _neurogram(deg, sr)
    t = ng_r.shape[1]
    scores = []
    for start in range(0, t, PATCH_FRAMES):
        stop = min(start + PATCH_FRAMES, t)
        if stop - start < max(2, PATCH_FRAMES // 6):
            break                      # ignore a tail sliver patch
        scores.append(nsim(ng_r[:, start:stop], ng_d[:, start:stop]))
    if not scores:
        scores = [nsim(ng_r, ng_d)]
    return float(np.mean(scores))


# fitted monotone logistic NSIM -> MOS-LQO. Calibration (broadband
# harmonic probe + AWGN, this module's dB-NSIM): id 1.0 | 35 dB 0.827 |
# 30 dB 0.777 | 20 dB 0.644 | 10 dB 0.540 | 0 dB 0.458; the logistic is
# fitted so 35 dB -> ~4.3 and 10 dB -> ~2.2, the published ViSQOL
# speech-mode AWGN response shape. Anchors pinned in
# tests/test_visqol_np.py.
_MOS_MAX = {"speech": 5.0, "audio": 4.732}
_A, _B = 8.4, 0.64       # slope / midpoint of the logistic in NSIM


def nsim_to_mos(s: float, mode: str = "speech") -> float:
    lo, hi = 1.0, _MOS_MAX.get(mode, 5.0)
    val = lo + (hi - lo) / (1.0 + np.exp(-_A * (s - _B)))
    # pin the perfect-similarity point exactly at the cap
    if s >= 0.9999:
        val = hi
    return float(np.clip(val, lo, hi))


def visqol_np(ref: np.ndarray, deg: np.ndarray, sr: int,
              mode: str = "speech") -> float:
    """MOS-LQO in [1, 5] (speech) / [1, 4.75] (audio)."""
    return nsim_to_mos(_mean_patch_nsim(ref, deg, sr), mode)
