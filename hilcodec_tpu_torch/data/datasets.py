"""Datasets (`hilcodec_tpu/data/datasets.py`): the directory-walk training
set and the filelist evaluation sets, on numpy and the port's `wavio`.

Class-probability sampling with optional mixing, RandomGain in dB, random
fixed-size segment reads by seeking in the WAV file, peak renormalization
above 1.0, length-sorted batch grouping and an epoch-seeded shuffle for
filelist sets. WAV only.
"""

from __future__ import annotations

import math
import os
import random
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.wavio import read_wav, wav_info

AUDIO_EXT = (".wav", ".WAV")


def _rngs(rng: Optional[np.random.Generator]
          ) -> Tuple[np.random.Generator, random.Random]:
    """(numpy Generator, stdlib Random) pair for one __getitem__ call.

    The loader passes a per-item Generator derived from (seed, epoch,
    shard, batch, position) so sampling is reproducible run-to-run and
    thread-safe (no global RNG state is ever touched from pool workers).
    Direct calls without a Generator fall back to fresh OS entropy."""
    if rng is None:
        rng = np.random.default_rng()
    return rng, random.Random(int(rng.integers(1 << 62)))


class RandomGain:
    """Uniform gain in dB."""

    def __init__(self, low_db: float, high_db: float):
        self.low_db = low_db
        self.high_db = high_db

    def __call__(self, wav: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        r = rng or np.random
        gain_db = r.uniform(self.low_db, self.high_db)
        return wav * (10.0 ** (gain_db / 20.0))


def make_transforms(transforms_cfg) -> List[Any]:
    out = []
    if not transforms_cfg:
        return out
    for name, kwargs in transforms_cfg.items():
        if name == "RandomGain":
            out.append(RandomGain(kwargs["low_db"], kwargs["high_db"]))
        else:
            raise ValueError(f"unknown transform {name}")
    return out


class Directories:
    """Recursive walk of include-dirs minus excludes; uniform file choice
   ."""

    def __init__(self, directories_to_include: Sequence[str],
                 directories_to_exclude: Sequence[str] = (),
                 extension: str = "",
                 mix: Optional[Dict[str, float]] = None,
                 files_to_exclude: Sequence[str] = ()):
        self.extension = extension
        self.names_to_mix: List[str] = []
        self.mix_probabilities: List[float] = []
        if mix:
            for name, prob in mix.items():
                self.names_to_mix.append(name)
                self.mix_probabilities.append(prob)
            self.names_to_mix.append("")
            self.mix_probabilities.append(1.0 - sum(self.mix_probabilities))

        excludes = [Path(d) for d in directories_to_exclude]
        file_excludes = {Path(f) for f in files_to_exclude}
        self.files: List[str] = []
        for directory in directories_to_include:
            found = []
            for root, _dirs, files in os.walk(directory):
                rp = Path(root)
                if any(e == rp or e in rp.parents for e in excludes):
                    continue
                for f in files:
                    full = rp / f
                    if full in file_excludes:
                        continue
                    if extension:
                        if f.endswith(extension):
                            found.append(str(full))
                    elif f.endswith(AUDIO_EXT):
                        found.append(str(full))
            if not found:
                raise RuntimeError(f"no audio files under {directory}")
            non_wav = [f for f in found if not f.endswith(AUDIO_EXT)]
            if non_wav:
                raise RuntimeError(f"cannot decode {non_wav[0]!r}: only "
                                   "WAV is read; convert the corpus")
            found.sort()
            self.files.extend(found)

    def choice(self, rng: random.Random) -> str:
        return self.files[rng.randrange(len(self.files))]


class DirectoriesDataset:
    """Training dataset used by the shipped configs
   : virtual length, per-item class sampling,
    random segment via direct wave seek, mixing, RandomGain, peak renorm."""

    def __init__(self, hp, keys: Sequence[str], mode: str = "train",
                 batch_size: int = 1, verbose: bool = True):
        assert hp.segment_size % 2 == 0
        self.keys = list(keys)
        self.segment_size: int = hp.segment_size
        self.sampling_rate: int = hp.sampling_rate
        self.length: int = hp.length
        self.transforms = make_transforms(getattr(hp, "transforms", None))

        files_to_exclude: List[str] = []
        for filelist in getattr(hp, "files_to_exclude", []) or []:
            with open(filelist) as f:
                files_to_exclude.extend(l.strip() for l in f)

        self.loaders: Dict[str, Directories] = {}
        self.class_names: List[str] = []
        self.probabilities: List[float] = []
        for name, kwargs in hp.classes.items():
            self.loaders[name] = Directories(
                kwargs["directories_to_include"],
                kwargs.get("directories_to_exclude", []) or [],
                kwargs.get("extension", ""),
                kwargs.get("mix", None),
                files_to_exclude)
            self.class_names.append(name)
            self.probabilities.append(kwargs["probability"])
        assert math.isclose(sum(self.probabilities), 1.0)

    def __len__(self) -> int:
        return self.length

    def shuffle(self, epoch: int) -> None:  # sampling is stochastic already
        pass

    def _load_segment(self, path: str, rng: random.Random) -> np.ndarray:
        """Random fixed-size segment; short files are center-padded
       ."""
        n_frames, sr, _ch = wav_info(path)
        assert sr == self.sampling_rate, (path, sr)
        if n_frames == 0:
            raise RuntimeError(f"empty audio {path}")
        if n_frames < self.segment_size:
            wav, _ = read_wav(path)
            pad = self.segment_size - len(wav)
            return np.pad(wav, (pad // 2, pad - pad // 2))
        start = rng.randint(0, n_frames - self.segment_size)
        wav, _ = read_wav(path, start=start, frames=self.segment_size)
        return wav

    def load_wav(self, dirs: Directories,
                 rng: random.Random) -> Tuple[np.ndarray, str]:
        last_error = None
        for _ in range(10):
            path = dirs.choice(rng)
            try:
                return self._load_segment(path, rng), path
            except Exception as e:  # retry with a different file
                last_error = e
        raise RuntimeError(f"10 failed loads: {last_error}")

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, Any]:
        np_rng, py_rng = _rngs(rng)
        name = np_rng.choice(self.class_names, p=self.probabilities)
        dirs = self.loaders[str(name)]
        wav, path = self.load_wav(dirs, py_rng)
        for t in self.transforms:
            wav = t(wav, np_rng)

        if dirs.names_to_mix:
            mix_name = str(np_rng.choice(dirs.names_to_mix,
                                         p=dirs.mix_probabilities))
            if mix_name:
                wav2, path2 = self.load_wav(self.loaders[mix_name], py_rng)
                for t in self.transforms:
                    wav2 = t(wav2, np_rng)
                wav = wav + wav2
                path = f"{path} | {path2}"

        peak = np.abs(wav).max()
        if peak > 1.0:
            wav = wav / (peak + 1e-12)

        data: Dict[str, Any] = {"wav": wav.astype(np.float32)}
        if "filename" in self.keys:
            data["filename"] = path
        return data


class FilelistDataset:
    """`Dataset`: filelist-driven eval
    sets with optional length filtering + sorted batch grouping and
    deterministic epoch shuffle."""

    def __init__(self, hp, keys: Sequence[str], mode: str = "valid",
                 batch_size: int = 1, verbose: bool = True):
        self.hp = hp
        self.keys = list(keys)
        self.mode = mode
        self.wav_dir = getattr(hp, "wav_dir", "")
        self.segment_size = (None if mode in ("infer", "pesq")
                             else getattr(hp, "segment_size", None))
        self.sampling_rate = hp.sampling_rate

        # normalize modes:
        #   'max'         -> peak-normalize in every mode
        #   'random_gain' -> random gain in train mode, no-op otherwise
        #   'null'/None   -> no-op
        method = getattr(hp, "normalize_method", "max")
        self.random_gain_low = self.random_gain_high = 1.0
        if method == "max":
            self.normalize = "max"
        elif method in ("null", None):
            self.normalize = None
        elif method == "random_gain":
            if mode == "train":
                self.normalize = "random_gain"
                self.random_gain_low = hp.random_gain_low
                self.random_gain_high = hp.random_gain_high
            else:
                self.normalize = None
        else:
            raise RuntimeError(
                f"hps.data.normalize_method {method} is not supported.")

        filelist = hp.filelists[mode]
        entries = []
        with open(filelist, encoding="utf-8") as f:
            entries = [l.strip().split("|") for l in f if l.strip()]
        if mode == "infer":
            entries = entries[:hp.num_infer]
        ext = getattr(hp, "extension", "")
        self.wav_idx = [re.sub(rf"\.{ext}$", "", e[0]) if ext else e[0]
                       for e in entries]

        do_filter = bool(getattr(hp, "filter", {}).get(mode, False))
        if do_filter:
            self.batch_size = batch_size
            lengths = []
            kept = []
            for name in self.wav_idx:
                try:
                    n, sr, _ = wav_info(self._path(name))
                    lengths.append(n / sr)
                    kept.append(name)
                except Exception:
                    continue
            order = np.argsort(lengths)
            self.wav_idx = [kept[i] for i in order]
        else:
            self.batch_size = 1
        self.wav_idx = np.array(self.wav_idx)

    def _path(self, name: str) -> str:
        ext = f".{self.hp.extension}" if getattr(self.hp, "extension", "") \
            else ""
        return os.path.join(self.wav_dir, f"{name}{ext}")

    def shuffle(self, seed: int) -> None:
        """Deterministic epoch shuffle of whole batches."""
        rng = np.random.default_rng(seed)
        bs = self.batch_size
        n = len(self.wav_idx) // bs
        perm = np.arange(n)
        rng.shuffle(perm)
        head = self.wav_idx[:n * bs].reshape(n, bs)[perm].reshape(-1)
        self.wav_idx = np.concatenate([head, self.wav_idx[n * bs:]])

    def __len__(self) -> int:
        return len(self.wav_idx)

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, Any]:
        np_rng, py_rng = _rngs(rng)
        data: Dict[str, Any] = {}
        name = str(self.wav_idx[idx])
        if "filename" in self.keys:
            data["filename"] = name
        wav, sr = read_wav(self._path(name))
        if sr != self.sampling_rate:
            wav = _resample(wav, sr, self.sampling_rate)

        if self.normalize == "max":
            wav = 0.99 * wav / np.abs(wav).max()
        elif self.normalize == "random_gain":
            high = min(self.random_gain_high,
                       0.99 / (np.abs(wav).max() + 1e-12))
            low = min(self.random_gain_low, high)
            wav = np_rng.uniform(low, high) * wav

        if self.segment_size is None:
            hop = getattr(self.hp, "hop_size", 1)
            discard = len(wav) - len(wav) // hop * hop
            if discard:
                wav = wav[:-discard]
        else:
            if len(wav) >= self.segment_size:
                start = py_rng.randint(0, len(wav) - self.segment_size)
                wav = wav[start:start + self.segment_size]
            else:
                wav = np.pad(wav, (0, self.segment_size - len(wav)))

        if "wav" in self.keys:
            data["wav"] = wav.astype(np.float32)
        if "wav_len" in self.keys:
            data["wav_len"] = len(wav)
        return data


def _resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    from scipy.signal import resample_poly
    g = math.gcd(sr_in, sr_out)
    return resample_poly(wav, sr_out // g, sr_in // g).astype(np.float32)


def collate(batch: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pad variable-length fields to the batch max and stack them into
    numpy arrays."""
    out: Dict[str, Any] = {}
    keys = batch[0].keys()
    for key in keys:
        vals = [b[key] for b in batch]
        if isinstance(vals[0], str):
            out[key] = vals
        elif np.isscalar(vals[0]) or np.ndim(vals[0]) == 0:
            out[key] = np.asarray(vals)
        else:
            max_len = max(v.shape[-1] for v in vals)
            padded = [np.pad(v, [(0, 0)] * (v.ndim - 1)
                             + [(0, max_len - v.shape[-1])]) for v in vals]
            out[key] = np.stack(padded)
    return out
