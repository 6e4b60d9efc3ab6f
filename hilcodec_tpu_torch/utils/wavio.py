"""WAV file I/O on the Python stdlib (`hilcodec_tpu/utils/wavio.py`).

Reads PCM WAVs (8/16/32-bit, mono or multichannel) to float32 in [-1, 1),
with `start`/`frames` for random-access segment reads, and writes float32
as PCM16.
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str, start: int = 0, frames: Optional[int] = None,
             mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 array in [-1, 1), sample_rate).

    ``start``/``frames`` allow random-access segment reads without decoding
    the whole file.
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        total = w.getnframes()
        if start:
            w.setpos(min(start, total))
        n = total - start if frames is None else min(frames, total - start)
        raw = w.readframes(max(n, 0))
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch)
        if mono:
            data = data.mean(axis=1)
        else:
            data = data.T
    return data, sr


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write float32 [-1, 1] (1-D mono or [C, T]) as PCM16 WAV."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data.T  # [T, C] interleaved
    pcm = np.clip(np.round(data * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def wav_info(path: str) -> Tuple[int, int, int]:
    """(num_frames, sample_rate, channels) without reading data."""
    with wave.open(path, "rb") as w:
        return w.getnframes(), w.getframerate(), w.getnchannels()
