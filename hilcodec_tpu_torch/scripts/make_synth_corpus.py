"""Generate a synthetic training corpus (the port's copy of the JAX
package's numpy-only `scripts/make_synth_corpus.py`; it writes the same
files, filelists and bytes for the same arguments): speech-like utterances
(formant-filtered harmonic pulses with pitch / energy contours), a NOISE
class (colored noise, crackle, hum: the reference mixes such noise into
clean speech on the fly) and a MUSIC-like class (chord progressions and
percussive events, for the reference's clean 0.67 / music 0.33 class
sampling). 24 kHz mono wav through `hilcodec_tpu_torch.utils.wavio`.

Usage: python -m hilcodec_tpu_torch.scripts.make_synth_corpus OUTDIR
           [n_train=200] [n_eval=16]
Writes OUTDIR/{train,noise,music}/*.wav, OUTDIR/eval/*.wav (speech),
OUTDIR/music_eval/*.wav and OUTDIR/{valid,infer,pesq}.txt filelists
(relative to OUTDIR; the *_mixed lists interleave speech and music)."""

import os
import sys

import numpy as np

from ..utils.wavio import write_wav

SR = 24000


def synth_utterance(rng: np.random.Generator, seconds: float) -> np.ndarray:
    n = int(seconds * SR)
    t = np.arange(n) / SR
    # pitch contour: random walk around 80-300 Hz
    f0 = np.exp(np.interp(t, np.linspace(0, seconds, 8),
                          rng.uniform(np.log(80), np.log(300), 8)))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    # harmonic-rich source (approximate glottal pulses)
    src = np.zeros(n)
    for k in range(1, 24):
        src += np.sin(k * phase) / k
    # two formant resonators (biquad-ish via FFT shaping per utterance)
    spec = np.fft.rfft(src)
    freqs = np.fft.rfftfreq(n, 1 / SR)
    shape = np.zeros_like(freqs)
    for fc, bw, g in ((rng.uniform(300, 900), 200, 1.0),
                      (rng.uniform(1000, 2500), 350, 0.7),
                      (rng.uniform(2500, 4000), 500, 0.35)):
        shape += g * np.exp(-0.5 * ((freqs - fc) / bw) ** 2)
    voiced = np.fft.irfft(spec * (shape + 0.02), n)
    # amplitude contour (syllable-rate energy modulation + pauses)
    env = np.clip(np.interp(t, np.linspace(0, seconds, 24),
                            rng.uniform(0, 1, 24)) ** 2, 0.0, 1.0)
    sig = voiced * env
    # unvoiced segments: add band-limited noise bursts
    noise = rng.standard_normal(n)
    nspec = np.fft.rfft(noise)
    nshape = np.exp(-0.5 * ((freqs - rng.uniform(2000, 6000)) / 1500) ** 2)
    noise = np.fft.irfft(nspec * nshape, n)
    nenv = (rng.random(24) < 0.3).astype(float)
    sig += noise * np.interp(t, np.linspace(0, seconds, 24), nenv) * 0.3
    peak = np.abs(sig).max() + 1e-9
    return (sig / peak * rng.uniform(0.3, 0.9)).astype(np.float32)


def synth_noise(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Environmental-noise stand-in: 1/f^alpha colored noise + optional
    50/60 Hz hum + sparse crackle impulses, slowly amplitude-modulated."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    freqs = np.fft.rfftfreq(n, 1 / SR)
    spec = np.fft.rfft(rng.standard_normal(n))
    alpha = rng.uniform(0.0, 1.6)           # white .. brown-ish
    spec *= 1.0 / np.maximum(freqs, 10.0) ** (alpha / 2)
    sig = np.fft.irfft(spec, n)
    if rng.random() < 0.4:                   # mains hum + harmonics
        f = rng.choice([50.0, 60.0])
        for k in (1, 2, 3):
            sig += rng.uniform(0.05, 0.3) / k * np.sin(
                2 * np.pi * k * f * t + rng.uniform(0, 2 * np.pi))
    if rng.random() < 0.5:                   # crackle
        idx = rng.integers(0, n, size=max(1, int(seconds * 15)))
        imp = np.zeros(n)
        imp[idx] = rng.uniform(-1, 1, len(idx))
        k = np.exp(-np.arange(64) / 12.0)
        sig += np.convolve(imp, k, mode="same") * rng.uniform(0.2, 0.8)
    env = np.interp(t, np.linspace(0, seconds, 6),
                    rng.uniform(0.4, 1.0, 6))
    sig *= env
    peak = np.abs(sig).max() + 1e-9
    return (sig / peak * rng.uniform(0.3, 0.9)).astype(np.float32)


def synth_music(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Music-like: a chord progression of detuned saw/triangle partials
    with ADSR-enveloped note onsets on a tempo grid + a percussive layer
    (noise-burst 'hits' at beat subdivisions)."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    sig = np.zeros(n)
    tempo = rng.uniform(70, 150)             # bpm
    beat = 60.0 / tempo
    root = rng.uniform(55.0, 220.0)          # A1..A3
    scale = np.array([0, 2, 4, 5, 7, 9, 11])
    # chords: change every 2 beats
    n_chords = max(1, int(seconds / (2 * beat)))
    for c in range(n_chords):
        t0, t1 = c * 2 * beat, min((c + 1) * 2 * beat, seconds)
        if t0 >= seconds:
            break
        i0, i1 = int(t0 * SR), int(t1 * SR)
        deg = rng.integers(0, 7)
        for off in (0, 2, 4):                # triad
            semi = scale[(deg + off) % 7] + 12 * ((deg + off) // 7)
            f = root * 2 ** (semi / 12.0)
            seg_t = t[i0:i1] - t0
            note = np.zeros(i1 - i0)
            for k in (1, 2, 3, 4, 5):        # partials, detuned
                fk = f * k * (1 + rng.normal(0, 1e-3))
                if fk > SR / 2 - 100:
                    break
                note += np.sin(2 * np.pi * fk * seg_t
                               + rng.uniform(0, 2 * np.pi)) / k
            adsr = np.minimum(seg_t / 0.02, 1.0) * np.exp(-seg_t / (beat))
            sig[i0:i1] += note * adsr * rng.uniform(0.2, 0.5)
    # percussive layer on eighth notes
    k_dec = np.exp(-np.arange(int(0.05 * SR)) / (0.01 * SR))
    for b in np.arange(0, seconds, beat / 2):
        if rng.random() < 0.7:
            i0 = int(b * SR)
            burst = rng.standard_normal(len(k_dec)) * k_dec
            hi = min(n, i0 + len(burst))
            sig[i0:hi] += burst[:hi - i0] * rng.uniform(0.1, 0.45)
    peak = np.abs(sig).max() + 1e-9
    return (sig / peak * rng.uniform(0.3, 0.9)).astype(np.float32)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "data/synth"
    n_train = int(argv[1]) if len(argv) > 1 else 200
    n_eval = int(argv[2]) if len(argv) > 2 else 16
    rng = np.random.default_rng(1234)
    for d in ("train", "eval", "noise", "music", "music_eval"):
        os.makedirs(os.path.join(out, d), exist_ok=True)
    for i in range(n_train):
        write_wav(os.path.join(out, "train", f"u{i:04d}.wav"),
                  synth_utterance(rng, rng.uniform(1.2, 4.0)), SR)
    # noise / music classes at half the speech count (the reference's
    # jamendo/DNS dirs are also smaller than its clean set)
    for i in range(n_train // 2):
        write_wav(os.path.join(out, "noise", f"n{i:04d}.wav"),
                  synth_noise(rng, rng.uniform(1.5, 4.0)), SR)
        write_wav(os.path.join(out, "music", f"m{i:04d}.wav"),
                  synth_music(rng, rng.uniform(2.0, 5.0)), SR)
    evals = []
    for i in range(n_eval):
        name = f"eval/e{i:03d}.wav"
        write_wav(os.path.join(out, name),
                  synth_utterance(rng, rng.uniform(2.0, 4.0)), SR)
        evals.append(name)
    music_evals = []
    for i in range(max(4, n_eval // 2)):
        name = f"music_eval/me{i:03d}.wav"
        write_wav(os.path.join(out, name),
                  synth_music(rng, rng.uniform(2.0, 4.0)), SR)
        music_evals.append(name)
    half = len(evals) // 2
    with open(os.path.join(out, "valid.txt"), "w") as f:
        f.write("".join(e + "|\n" for e in evals[:half]))
    with open(os.path.join(out, "pesq.txt"), "w") as f:
        f.write("".join(e + "|\n" for e in evals[half:]))
    with open(os.path.join(out, "infer.txt"), "w") as f:
        f.write("".join(e + "|\n" for e in evals[:2]))
    with open(os.path.join(out, "valid_mixed.txt"), "w") as f:
        f.write("".join(e + "|\n" for e in evals[:half] + music_evals[::2]))
    with open(os.path.join(out, "pesq_mixed.txt"), "w") as f:
        f.write("".join(e + "|\n"
                        for e in evals[half:] + music_evals[1::2]))
    print(f"wrote {n_train} speech + {n_train // 2} noise + "
          f"{n_train // 2} music train files, {n_eval} speech + "
          f"{len(music_evals)} music eval files to {out}")


if __name__ == "__main__":
    main()
