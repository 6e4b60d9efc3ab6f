"""YIN pitch tracker in numpy (`hilcodec_tpu/data/pitch_np.py`): the
pitch feature of `data/datasets.extract_pitch` where praat-parselmouth is
not installed.

YIN (de Cheveigne & Kawahara 2002): the difference function, its
cumulative-mean normalization, an absolute threshold and parabolic
interpolation, per hop. The contract is the praat backend's: per-hop
frames, 0 Hz on unvoiced frames; extract_pitch applies the same
unvoiced interpolation to both backends.
"""

from __future__ import annotations

import numpy as np

YIN_THRESHOLD = 0.15      # published "absolute threshold" operating range


def _difference_function(frame: np.ndarray, tau_max: int) -> np.ndarray:
    """d(tau) for one frame via the FFT autocorrelation identity:
    d(tau) = r_t(0) + r_{t+tau}(0) - 2 * ac(tau)."""
    w = frame.size
    n_fft = 1 << int(np.ceil(np.log2(2 * w)))
    spec = np.fft.rfft(frame, n_fft)
    ac = np.fft.irfft(spec * np.conj(spec), n_fft)[:tau_max]
    sq = np.concatenate([[0.0], np.cumsum(frame * frame)])
    # energy of x[0:w-tau] and x[tau:w]
    e_head = sq[w - np.arange(tau_max)] - sq[0]
    e_tail = sq[w] - sq[np.arange(tau_max)]
    d = e_head + e_tail - 2.0 * ac
    return np.maximum(d, 0.0)


def _cmnd(d: np.ndarray) -> np.ndarray:
    """Cumulative-mean-normalized difference d'(tau); d'(0) = 1."""
    out = np.ones_like(d)
    csum = np.cumsum(d[1:])
    with np.errstate(divide="ignore", invalid="ignore"):
        out[1:] = d[1:] * np.arange(1, d.size) / np.where(csum > 0, csum, 1.0)
    return out


def yin_frame(frame: np.ndarray, sr: int, fmin: float, fmax: float,
              threshold: float = YIN_THRESHOLD) -> float:
    """f0 of one frame, or 0.0 if unvoiced."""
    tau_min = max(2, int(sr / fmax))
    tau_max = int(sr / fmin) + 2
    if frame.size < tau_max + 2:
        return 0.0
    if float(np.dot(frame, frame)) < 1e-10 * frame.size:
        return 0.0                         # (near-)silent frame: unvoiced
        # (all-zero d makes the normalized difference identically 0,
        # which would otherwise read as a perfect dip at tau_min)
    dp = _cmnd(_difference_function(frame, tau_max))
    below = np.nonzero(dp[tau_min:] < threshold)[0]
    if below.size:
        tau = tau_min + below[0]
        # walk down to the local minimum of this dip
        while tau + 1 < tau_max and dp[tau + 1] < dp[tau]:
            tau += 1
    else:
        return 0.0                         # unvoiced: no dip clears it
    # parabolic interpolation around tau
    if 1 <= tau < tau_max - 1:
        a, b, c = dp[tau - 1], dp[tau], dp[tau + 1]
        denom = a - 2 * b + c
        if abs(denom) > 1e-12:
            tau = tau + 0.5 * (a - c) / denom
    f0 = sr / tau
    return float(f0) if fmin * 0.9 <= f0 <= fmax * 1.1 else 0.0


def pitch_np(wav: np.ndarray, sr: int, hop: int,
             fmin: float = 75.0, fmax: float = 600.0,
             threshold: float = YIN_THRESHOLD) -> np.ndarray:
    """Per-hop f0 track (0 = unvoiced), len(wav)//hop + 1 frames —
    the same frame count the praat time_step=hop/sr call yields on the
    padded input extract_pitch constructs."""
    wav = np.asarray(wav, np.float64)
    win = int(3 * sr / fmin)               # 3 fmin periods, YIN's choice
    n_frames = len(wav) // hop + 1
    half = win // 2
    padded = np.pad(wav, (half, half + win))
    out = np.zeros(n_frames, np.float64)
    for k in range(n_frames):
        start = k * hop                    # window centered at k*hop
        out[k] = yin_frame(padded[start:start + win], sr, fmin, fmax,
                           threshold)
    return out.astype(np.float32)
