"""PESQ-wb (ITU-T P.862.2-style) in pure numpy: the port's own copy of
`hilcodec_tpu/train/pesq_np.py`, the in-env oracle for PESQ-wb at 16 kHz
when the `pesq` package is absent.

A structural reimplementation of the P.862 perceptual model with the
P.862.2 wideband mapping (level alignment, 100 Hz high-pass, 32 ms Hann
power spectra, Bark-band pitch power densities, partial frequency and
short-term gain compensation, Zwicker loudness, asymmetric disturbance,
L6 / L2 aggregation, the wideband logistic MOS map), with two deliberate
deviations: no time-alignment search (a causal codec returns aligned
audio) and band edges from the analytic Bark warp z = 7*asinh(f/650)
(49 bands to 8 kHz). Values are comparable within this repo and track
PESQ-wb in ordering; they are not validated against the ITU binary.
"""

from __future__ import annotations

import numpy as np

SR = 16000
FRAME = 512          # 32 ms @ 16 kHz
HOP = 256            # 50% overlap
N_BARK = 49
TARGET_POWER = 1e7   # P.862 fixed listening-level alignment
ZWICKER_GAMMA = 0.23
# Sp/Sl analogues: the spec scales pitch power densities into
# hearing-threshold-relative power units and loudness into sone-like
# units before the fixed constants (deadzone, +50/+1000 offsets, the 45
# frame cap, the 0.1/0.0309 MOS slopes) apply. The ITU values belong to
# its band table; these are calibrated for the analytic Bark bands so a
# white-noise SNR ladder reproduces published PESQ-wb behavior (see
# tests/test_pesq_np.py::test_snr_ladder_anchors).
SP = 3e-7            # power scale: strong speech bands land ~1e3..1e5
SL = 1.0             # loudness scale
# calibrated ladder (harmonic test signal + AWGN, tests/test_pesq_np.py):
# clean 4.64 | 35dB 4.62 | 30dB 4.56 | 20dB 3.70 | 10dB 2.00 | 0dB 1.66
# — tracks published PESQ-wb AWGN behavior in slope and anchors


def _bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, np.float64) / 650.0)


def _inv_bark(z):
    return 650.0 * np.sinh(np.asarray(z, np.float64) / 7.0)


def _band_edges():
    """49 bands equally spaced on the Bark warp over [0, 8000] Hz."""
    z = np.linspace(_bark(0.0), _bark(SR / 2), N_BARK + 1)
    return _inv_bark(z)


_EDGES = _band_edges()
_CENTERS = 0.5 * (_EDGES[:-1] + _EDGES[1:])
_WIDTH_HZ = np.diff(_EDGES)
# band width on the Bark axis — the spec's band weights for the L2/L1
# norms over frequency are proportional to bark widths (uniform here by
# construction, but keep the explicit vector for clarity)
_WIDTH_BARK = np.diff(np.linspace(_bark(0.0), _bark(SR / 2), N_BARK + 1))


def _abs_threshold():
    """Absolute hearing threshold per band (power units), from the
    terhardt-style threshold curve used by the P.862 description:
    3.64 f^-0.8 - 6.5 exp(-0.6 (f-3.3)^2) + 1e-3 f^4   [dB SPL, f in kHz]
    mapped to internal power with the 10^(dB/10) convention."""
    f_khz = np.maximum(_CENTERS, 20.0) / 1000.0
    db = (3.64 * f_khz ** -0.8
          - 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2)
          + 1e-3 * f_khz ** 4)
    return 10.0 ** (db / 10.0)


_P0 = _abs_threshold()


def _level_align(x):
    """Scale to the fixed listening level using the 325-3250 Hz band power
    over the whole file (P.862 aligns on the band-passed global power)."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / SR)
    band = (freqs >= 325.0) & (freqs <= 3250.0)
    p = (np.abs(spec[band]) ** 2).sum() / max(len(x), 1) / len(x) * 2.0
    return x * np.sqrt(TARGET_POWER / max(p, 1e-20))


def _highpass_100hz(x):
    """Zero-phase 100 Hz high-pass (the wideband input filter that
    replaces the narrowband IRS receive characteristic)."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / SR)
    # 2nd-order butterworth magnitude response
    h = 1.0 / np.sqrt(1.0 + (100.0 / np.maximum(freqs, 1e-9)) ** 4)
    return np.fft.irfft(spec * h, len(x))


def _frames_power_spectrum(x):
    """[T, FRAME//2+1] Hann-windowed power spectra."""
    n = (len(x) - FRAME) // HOP + 1
    if n < 1:
        raise ValueError(f"input too short for one {FRAME}-sample frame")
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    fr = x[idx] * np.hanning(FRAME)[None, :]
    return np.abs(np.fft.rfft(fr, axis=-1)) ** 2


def _pitch_power_density(ps):
    """Power spectra [T, F] -> Bark pitch power densities [T, N_BARK]."""
    freqs = np.fft.rfftfreq(FRAME, 1.0 / SR)
    band_of = np.clip(np.searchsorted(_EDGES, freqs, side="right") - 1,
                      0, N_BARK - 1)
    ppd = np.zeros((ps.shape[0], N_BARK))
    np.add.at(ppd.T, band_of, ps.T)
    # normalize by band width so a flat spectrum maps to a flat density,
    # then scale into threshold-relative units (SP)
    bins_per_band = np.maximum(np.bincount(band_of, minlength=N_BARK), 1)
    return ppd / bins_per_band * SP


def _loudness(ppd):
    """Zwicker-law specific loudness per band (sone-like units)."""
    ratio = ppd / _P0[None, :]
    s = ((_P0[None, :] / 0.5) ** ZWICKER_GAMMA
         * ((0.5 + 0.5 * ratio) ** ZWICKER_GAMMA - 1.0))
    return np.where(ratio > 1.0, s, 0.0) * SL


def pesq_wb(ref: np.ndarray, deg: np.ndarray, sr: int = SR) -> float:
    """P.862.2-style wideband MOS-LQO for sample-aligned 16 kHz signals.

    Returns a value in [1.04, 4.64] (the wideband mapping's range)."""
    if sr != SR:
        raise ValueError(f"pesq_wb expects {SR} Hz input, got {sr}")
    n = min(len(ref), len(deg))
    ref = np.asarray(ref[:n], np.float64)
    deg = np.asarray(deg[:n], np.float64)

    ref = _highpass_100hz(_level_align(ref))
    deg = _highpass_100hz(_level_align(deg))

    ppd_r = _pitch_power_density(_frames_power_spectrum(ref))
    ppd_d = _pitch_power_density(_frames_power_spectrum(deg))
    frame_pow_r = ppd_r.mean(axis=1)
    frame_pow_d = ppd_d.mean(axis=1)

    # ---- partial frequency compensation (linear filtering in the system
    # under test is not a degradation): scale the REFERENCE bands by the
    # clipped deg/ref ratio of mean densities over speech-active frames
    active = frame_pow_r > (frame_pow_r.max() * 1e-3 + 1e-12)
    if not active.any():
        active = np.ones_like(active)
    mean_r = ppd_r[active].mean(axis=0)
    mean_d = ppd_d[active].mean(axis=0)
    bandgain = np.clip((mean_d + 1000.0) / (mean_r + 1000.0), 0.01, 100.0)
    ppd_r_c = ppd_r * bandgain[None, :]

    # ---- short-term gain compensation of the DEGRADED signal: smoothed,
    # clipped frame-power ratio (tracks AGC-like gain wander)
    raw_gain = (ppd_r_c.sum(axis=1) + 5e3) / (ppd_d.sum(axis=1) + 5e3)
    gain = np.empty_like(raw_gain)
    g = 1.0
    for t in range(len(raw_gain)):          # first-order smoother
        g = 0.8 * g + 0.2 * raw_gain[t]
        gain[t] = g
    gain = np.clip(gain, 3e-4, 5.0)
    ppd_d_c = ppd_d * gain[:, None]

    L_r = _loudness(ppd_r_c)
    L_d = _loudness(ppd_d_c)

    # ---- disturbance with center clipping (the masking deadzone)
    diff = L_d - L_r
    m = 0.25 * np.minimum(L_d, L_r)
    d = np.where(diff > m, diff - m,
                 np.where(diff < -m, diff + m, 0.0))

    # ---- asymmetry: additive spectral components (codec artifacts) hurt
    # more than omissions
    af = ((ppd_d_c + 50.0) / (ppd_r_c + 50.0)) ** 1.2
    af = np.where(af < 3.0, 0.0, np.minimum(af, 12.0))
    d_asym = d * af

    # ---- frame disturbances: L2 over bands (symmetric), L1 (asymmetric)
    w = _WIDTH_BARK[None, :]
    D_fr = np.sqrt((d ** 2 * w).sum(axis=1))
    DA_fr = np.abs(d_asym * w).sum(axis=1)
    D_fr = np.minimum(D_fr, 45.0)
    DA_fr = np.minimum(DA_fr, 45.0)

    # ---- weight frames by reference loudness (quiet frames matter less)
    fw = ((frame_pow_r * N_BARK + 1e5) / 1e7) ** 0.04
    D_fr = np.minimum(D_fr / fw, 45.0)
    DA_fr = np.minimum(DA_fr / fw, 45.0)

    # ---- aggregate: L6 over 20-frame syllable intervals, L2 over time
    def _l6_l2(x):
        T = len(x)
        step, width = 10, 20                 # 50%-overlapped ~320 ms
        starts = np.arange(0, max(T - width, 0) + 1, step)
        if len(starts) == 0:
            starts = np.array([0])
        ivals = [np.mean(x[s:s + width] ** 6) ** (1 / 6) for s in starts]
        return float(np.sqrt(np.mean(np.square(ivals))))

    D = _l6_l2(D_fr)
    DA = _l6_l2(DA_fr)

    raw = 4.5 - 0.1 * D - 0.0309 * DA
    # P.862.2 wideband logistic mapping
    mos_lqo = 0.999 + (4.999 - 0.999) / (1.0 + np.exp(-1.3669 * raw
                                                      + 3.8224))
    return float(mos_lqo)
