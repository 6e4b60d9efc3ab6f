"""Objective quality metrics: STOI, SI-SDR, MCD, PESQ and ViSQOL (the port's
own copy of `hilcodec_tpu/train/metrics.py`, numpy and scipy only).

Backends:
  * STOI, SI-SDR, MCD: pure numpy here (MCD on `ops/mel.mel_filterbank`).
  * PESQ: the `pesq` package when importable, else the numpy P.862.2-style
    oracle (train/pesq_np.py).
  * ViSQOL: the `visqol` python API, else the `visqol` binary in a
    subprocess, else the numpy NSIM oracle (train/visqol_np.py).

`Metrics` is the training loop's initialize / submit / retrieve pipeline:
STOI, SI-SDR and MCD inline, PESQ and ViSQOL in a process pool whose
workers are spawned, not forked, so that none inherits the trainer's CUDA
context or threads (they import this module and numpy, never CUDA).
"""

from __future__ import annotations

import math
import multiprocessing
import os
import subprocess
import tempfile
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from scipy.signal import resample_poly


# ---------------------------------------------------------------------------
# STOI (Taal et al. 2011) — pure numpy
# ---------------------------------------------------------------------------

def _thirdoct(fs: int, n_fft: int, num_bands: int, min_freq: float
              ) -> np.ndarray:
    """One-third octave band matrix [num_bands, n_fft//2+1]."""
    f = np.linspace(0, fs, n_fft + 1)[: n_fft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = 2.0 ** ((2 * k - 1) / 6.0) * min_freq
    hi = 2.0 ** ((2 * k + 1) / 6.0) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_idx:hi_idx] = 1.0
    return obm


def _stft_frames(x: np.ndarray, frame: int, hop: int,
                 n_fft: int) -> np.ndarray:
    w = np.hanning(frame + 2)[1:-1]
    n = 1 + (len(x) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    return np.fft.rfft(x[idx] * w, n_fft, axis=-1)


def stoi(clean: np.ndarray, processed: np.ndarray, fs: int = 10000,
         extended: bool = False) -> float:
    """Short-time objective intelligibility, 10 kHz protocol."""
    if fs != 10000:
        g = math.gcd(fs, 10000)
        clean = resample_poly(clean, 10000 // g, fs // g)
        processed = resample_poly(processed, 10000 // g, fs // g)
        fs = 10000
    frame, hop, n_fft, num_bands, min_freq = 256, 128, 512, 15, 150.0
    N, beta, dyn_range = 30, -15.0, 40.0

    m = min(len(clean), len(processed))
    clean, processed = clean[:m], processed[:m]

    # remove silent frames (energy 40 dB below the loudest frame)
    w = np.hanning(frame + 2)[1:-1]
    n = 1 + (m - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    frames_c = clean[idx] * w
    energies = 20 * np.log10(np.linalg.norm(frames_c, axis=1) + 1e-12)
    mask = energies > energies.max() - dyn_range
    if mask.sum() < N:
        return float("nan")
    frames_p = processed[idx] * w
    clean = _overlap_add(frames_c[mask], hop)
    processed = _overlap_add(frames_p[mask], hop)

    X = np.abs(_stft_frames(clean, frame, hop, n_fft))
    Y = np.abs(_stft_frames(processed, frame, hop, n_fft))
    obm = _thirdoct(fs, n_fft, num_bands, min_freq)
    Xb = np.sqrt(obm @ (X.T ** 2))       # [bands, frames]
    Yb = np.sqrt(obm @ (Y.T ** 2))

    vals = []
    for mf in range(N, Xb.shape[1] + 1):
        xs = Xb[:, mf - N:mf]
        ys = Yb[:, mf - N:mf]
        if extended:
            xn = (xs - xs.mean(1, keepdims=True)) / \
                (np.linalg.norm(xs - xs.mean(1, keepdims=True), axis=1,
                                keepdims=True) + 1e-12)
            yn = (ys - ys.mean(1, keepdims=True)) / \
                (np.linalg.norm(ys - ys.mean(1, keepdims=True), axis=1,
                                keepdims=True) + 1e-12)
            vals.append(np.sum(xn * yn) / num_bands)
        else:
            alpha = np.linalg.norm(xs, axis=1, keepdims=True) / \
                (np.linalg.norm(ys, axis=1, keepdims=True) + 1e-12)
            ys_a = ys * alpha
            clip = xs * (1 + 10 ** (-beta / 20.0))
            ys_a = np.minimum(ys_a, clip)
            xm = xs - xs.mean(1, keepdims=True)
            ym = ys_a - ys_a.mean(1, keepdims=True)
            d = np.sum(xm * ym, axis=1) / (
                np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1)
                + 1e-12)
            vals.append(d.mean())
    return float(np.mean(vals))


def _overlap_add(frames: np.ndarray, hop: int) -> np.ndarray:
    n, frame = frames.shape
    out = np.zeros(frame + (n - 1) * hop)
    for i in range(n):
        out[i * hop:i * hop + frame] += frames[i]
    return out


# ---------------------------------------------------------------------------
# SI-SDR and mel-cepstral distortion — pure numpy, always available
# ---------------------------------------------------------------------------

def sisdr(clean: np.ndarray, processed: np.ndarray) -> float:
    """Scale-invariant SDR in dB (Le Roux et al. 2019, eq. 5).

    Zero-mean both, project `processed` onto `clean`, and compare the
    target projection against the residual. Invariant to rescaling of
    `processed` by construction."""
    m = min(len(clean), len(processed))
    s = clean[:m].astype(np.float64)
    x = processed[:m].astype(np.float64)
    s = s - s.mean()
    x = x - x.mean()
    alpha = np.dot(x, s) / (np.dot(s, s) + 1e-12)
    target = alpha * s
    err = x - target
    return float(10.0 * np.log10(
        (np.dot(target, target) + 1e-12) / (np.dot(err, err) + 1e-12)))


def _mel_cepstra(x: np.ndarray, sr: int, n_fft: int, hop: int,
                 n_mels: int, n_mcep: int) -> np.ndarray:
    """log-mel spectrogram -> DCT-II cepstra [frames, n_mcep+1]."""
    from scipy.fftpack import dct

    from ..ops.mel import mel_filterbank
    w = np.hanning(n_fft + 1)[:-1]
    n = max(1 + (len(x) - n_fft) // hop, 1)
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = np.abs(np.fft.rfft(x[idx] * w, axis=-1)) ** 2
    fb = mel_filterbank(sr, n_fft, n_mels).astype(np.float64)
    logmel = np.log10(spec @ fb.T + 1e-10)
    # 80 dB dynamic-range clamp below the utterance's own peak (librosa
    # top_db convention): keeps empty bands / silence from dominating the
    # distortion, and makes MCD exactly gain-invariant (the clamp level
    # shifts with the signal, so a pure gain is a constant log-mel shift
    # absorbed entirely by the excluded c0)
    logmel = np.maximum(logmel, logmel.max() - 8.0)
    return dct(logmel, type=2, axis=-1, norm="ortho")[:, : n_mcep + 1]


def mcd(clean: np.ndarray, processed: np.ndarray, sr: int = 16000,
        n_mcep: int = 13) -> float:
    """Mel-cepstral distortion in dB (Kubichek 1993), frame-aligned
    (no DTW — codec reconstruction is time-aligned by construction),
    c0 (loudness) excluded: MCD = (10*sqrt(2)/ln 10) * mean_t ||dc_t||."""
    n_fft, hop, n_mels = 1024, 256, 80
    m = min(len(clean), len(processed))
    cr = _mel_cepstra(clean[:m], sr, n_fft, hop, n_mels, n_mcep)
    cd = _mel_cepstra(processed[:m], sr, n_fft, hop, n_mels, n_mcep)
    diff = cr[:, 1:] - cd[:, 1:]
    frame_d = np.sqrt((diff ** 2).sum(axis=1))
    return float((10.0 * math.sqrt(2.0) / math.log(10.0)) * frame_d.mean())


# ---------------------------------------------------------------------------
# optional backends
# ---------------------------------------------------------------------------

def _pesq_backend(ref: np.ndarray, deg: np.ndarray, sr: int) -> float:
    """PESQ-wb @16 kHz (reference metrics.py:16-21). Prefers the ITU
    `pesq` package when importable; otherwise the in-env numpy P.862.2
    oracle (train/pesq_np.py — structural reimplementation, calibrated,
    NOT bit-validated against the ITU binary; see its module docstring)."""
    try:
        from pesq import pesq as _pesq  # gated: package may be absent
        return float(_pesq(16000, ref, deg, "wb"))
    except ImportError:
        from .pesq_np import pesq_wb
        return pesq_wb(ref, deg, 16000)


def _visqol_python(ref: np.ndarray, deg: np.ndarray, sr: int,
                   mode: str) -> float:
    """In-process ViSQOL via the pip `visqol` python API — the reference's
    pybind variant (utils/visqol_python.py). Gated on the package; raises
    ImportError when absent so measure_visqol falls through to the
    subprocess binding."""
    from visqol import visqol_lib_py
    from visqol.pb2 import visqol_config_pb2

    config = visqol_config_pb2.VisqolConfig()
    if mode == "speech":
        config.audio.sample_rate = 16000
        config.options.use_speech_scoring = True
        model = "lattice_tcditugenmeetpackhref_ls2_nl60_lr12_bs2048_learn.005_ep2400_train1_7_raw.tflite"
    else:
        config.audio.sample_rate = 48000
        config.options.use_speech_scoring = False
        model = "libsvm_nu_svr_model.txt"
    config.options.svr_model_path = os.path.join(
        os.path.dirname(visqol_lib_py.__file__), "model", model)
    api = visqol_lib_py.VisqolApi()
    api.Create(config)
    out = api.Measure(ref.astype(np.float64), deg.astype(np.float64))
    return float(out.moslqo)


def measure_visqol(ref: np.ndarray, deg: np.ndarray, sr: int,
                   mode: str = "speech",
                   binary: Optional[str] = None) -> float:
    """MOS-LQO via the python API when the `visqol` package is importable
    (reference utils/visqol_python.py), else the subprocess binding to the
    bazel binary (utils/visqol_cli.py:30-36; selector
    utils/measure_visqol.py:1-4), else the in-env numpy NSIM oracle
    (train/visqol_np.py — structural reimplementation, calibrated,
    same-ordering; see its docstring for the deviations)."""
    try:
        return _visqol_python(ref, deg, sr, mode)
    except ImportError:
        pass
    from ..utils.wavio import write_wav
    binary = binary or os.environ.get("VISQOL_BIN", "visqol")
    import shutil
    if shutil.which(binary) is None:
        from .visqol_np import visqol_np
        return visqol_np(ref, deg, sr, mode)
    with tempfile.TemporaryDirectory() as d:
        rp, dp = os.path.join(d, "ref.wav"), os.path.join(d, "deg.wav")
        write_wav(rp, ref, sr)
        write_wav(dp, deg, sr)
        args = [binary, "--reference_file", rp, "--degraded_file", dp]
        if mode == "speech":
            args += ["--use_speech_mode"]
        out = subprocess.run(args, capture_output=True, text=True,
                             timeout=300)
        for line in out.stdout.splitlines():
            if "MOS-LQO" in line:
                return float(line.split(":")[-1])
    raise RuntimeError("visqol produced no MOS-LQO")


# ---------------------------------------------------------------------------
# the training-time pipeline
# ---------------------------------------------------------------------------

_RESAMPLE_RATES = {"pesq": 16000, "stoi": 10000, "visqol": 16000,
                   "visqol_audio": 48000, "sisdr": None, "mcd": 16000}

# metrics where smaller is better (best-tracking flips the comparison)
_LOWER_IS_BETTER = {"mcd"}

# metrics computed inline on the calling thread (pure numpy, no pool):
# stoi per the reference's hang-bug workaround; sisdr/mcd because they
# are cheap closed-form numpy
_INLINE = {"stoi", "sisdr", "mcd"}


class Metrics:
    """initialize/submit/retrieve protocol (metrics.py:24-149).

    submit() resamples on host and fans PESQ/ViSQOL out to a process pool
    (they crash/hang the trainer in-process — metrics.py:53-55 keeps STOI
    inline for the same reason, reproduced here); retrieve() aggregates
    means across hosts and tracks bests.
    """

    def __init__(self, metrics_to_calculate: Dict[str, bool],
                 sampling_rate: int = 24000, num_workers: int = 4,
                 world_size: int = 1, rank: int = 0):
        self.enabled = {k for k, v in metrics_to_calculate.items() if v}
        self.sampling_rate = sampling_rate
        self.world_size = world_size
        self.rank = rank
        self.num_workers = num_workers
        self.best: Dict[str, float] = {}
        self._futures: List[Tuple[str, Any]] = []
        self._inline: Dict[str, List[float]] = {}
        self._executor: Optional[ProcessPoolExecutor] = None
        self._index = 0

    def initialize(self) -> None:
        self._futures = []
        self._inline = {k: [] for k in self.enabled}
        self._index = 0
        if (self.enabled - _INLINE) and self._executor is None:
            self._executor = ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"))

    def submit(self, wav_r: np.ndarray, wav_g: np.ndarray) -> None:
        """wav_r/wav_g: [B, T] float32 batches (already on host)."""
        for b in range(wav_r.shape[0]):
            # world-size-strided indexing (metrics.py:87): each rank only
            # measures its own shard
            if self._index % self.world_size != self.rank:
                self._index += 1
                continue
            self._index += 1
            r, g = wav_r[b], wav_g[b]
            for name in self.enabled:
                sr_t = _RESAMPLE_RATES[name]
                if sr_t is None:        # rate-agnostic metric
                    r_t, g_t, sr_t = r, g, self.sampling_rate
                else:
                    gcd = math.gcd(self.sampling_rate, sr_t)
                    r_t = resample_poly(r, sr_t // gcd,
                                        self.sampling_rate // gcd)
                    g_t = resample_poly(g, sr_t // gcd,
                                        self.sampling_rate // gcd)
                if name == "stoi":      # inline (hang-bug workaround)
                    self._inline["stoi"].append(stoi(r_t, g_t, sr_t))
                elif name == "sisdr":   # pure numpy, inline
                    self._inline["sisdr"].append(sisdr(r_t, g_t))
                elif name == "mcd":
                    self._inline["mcd"].append(mcd(r_t, g_t, sr_t))
                elif name == "pesq":
                    self._futures.append(("pesq", self._executor.submit(
                        _pesq_backend, r_t, g_t, sr_t)))
                elif name in ("visqol", "visqol_audio"):
                    mode = "speech" if name == "visqol" else "audio"
                    self._futures.append((name, self._executor.submit(
                        measure_visqol, r_t, g_t, sr_t, mode)))

    def retrieve(self, reduce_fn=None) -> Dict[str, float]:
        """Means per metric; cross-host reduction via `reduce_fn` (e.g.
        multihost allgather+mean); best tracking (metrics.py:112-162)."""
        sums: Dict[str, List[float]] = {k: list(v)
                                        for k, v in self._inline.items()}
        for name, fut in self._futures:
            try:
                sums.setdefault(name, []).append(fut.result(timeout=600))
            except Exception:
                continue
        out = {}
        for name, vals in sums.items():
            vals = [v for v in vals if np.isfinite(v)]
            if not vals:
                continue
            mean = float(np.mean(vals))
            if reduce_fn is not None:
                mean = reduce_fn(mean, len(vals))
            out[name] = mean
            better = (mean < self.best.get(name, math.inf)
                      if name in _LOWER_IS_BETTER
                      else mean > self.best.get(name, -math.inf))
            if better:
                self.best[name] = mean
        self._futures = []
        self._inline = {}
        return out

    def close(self) -> None:
        """Shut the worker pool down (initialize starts a new one)."""
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    def state_dict(self) -> Dict[str, float]:
        return dict(self.best)

    def load_state_dict(self, state: Dict[str, float]) -> None:
        self.best = dict(state)
