"""The port's objective metrics (train/metrics.py, pesq_np.py,
visqol_np.py) against the JAX package's on seeded signals. They are the
same numpy code, so they must agree to 1e-9; the port's `Metrics` pool
runs in spawned workers."""

import math

import numpy as np
import pytest
from scipy.signal import resample_poly

from hilcodec_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from hilcodec_tpu.train import metrics as JM
from hilcodec_tpu.train.pesq_np import pesq_wb as jax_pesq_wb
from hilcodec_tpu.train.visqol_np import visqol_np as jax_visqol_np

from hilcodec_tpu_torch.ops.mel import mel_filterbank
from hilcodec_tpu_torch.train import metrics as M
from hilcodec_tpu_torch.train.pesq_np import pesq_wb
from hilcodec_tpu_torch.train.visqol_np import visqol_np

TOL = dict(rtol=1e-9, atol=1e-9)


def _speech(rng, n, sr):
    """Harmonics on a wandering f0 with a syllable envelope, plus noise."""
    t = np.arange(n) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(h * phase) / h for h in range(1, 12))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2
    return (0.2 * x + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    clean = _speech(rng, 16000, 16000)
    deg = (clean + 0.03 * rng.standard_normal(16000)).astype(np.float32)
    return clean, deg


@pytest.mark.parametrize("name", ["stoi", "sisdr", "mcd"])
def test_numpy_metrics_match_jax(pair, name):
    clean, deg = pair
    ours = getattr(M, name)(clean, deg, *(() if name == "sisdr"
                                          else (16000,)))
    theirs = getattr(JM, name)(clean, deg, *(() if name == "sisdr"
                                             else (16000,)))
    assert math.isfinite(ours)
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_pesq_and_visqol_oracles_match_jax(pair):
    clean, deg = pair
    np.testing.assert_allclose(pesq_wb(clean, deg, 16000),
                               jax_pesq_wb(clean, deg, 16000), **TOL)
    for mode in ("speech", "audio"):
        np.testing.assert_allclose(visqol_np(clean, deg, 16000, mode),
                                   jax_visqol_np(clean, deg, 16000, mode),
                                   **TOL)
    np.testing.assert_allclose(M._pesq_backend(clean, deg, 16000),
                               JM._pesq_backend(clean, deg, 16000), **TOL)
    np.testing.assert_allclose(
        M.measure_visqol(clean, deg, 16000, "speech"),
        JM.measure_visqol(clean, deg, 16000, "speech"), **TOL)


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 1024, 80),
                                             (24000, 1024, 128)])
def test_mel_filterbank_matches_jax(sr, n_fft, n_mels):
    np.testing.assert_array_equal(mel_filterbank(sr, n_fft, n_mels),
                                  jax_mel_filterbank(sr, n_fft, n_mels))


def test_resample_rates_match_jax():
    assert M._RESAMPLE_RATES == JM._RESAMPLE_RATES


def _batch(seed):
    rng = np.random.default_rng(seed)
    ref = np.stack([_speech(rng, 12000, 24000) for _ in range(2)])
    return ref, (ref + 0.02 * rng.standard_normal(ref.shape)
                 ).astype(np.float32)


def test_metrics_pipeline_matches_jax():
    """Inline metrics against JAX's Metrics; the pooled ones (PESQ,
    ViSQOL) against JAX's backends on the same resampled signals; best
    tracking and its state dict as JAX's."""
    enabled = {"stoi": True, "sisdr": True, "mcd": True, "pesq": True,
               "visqol": True, "visqol_audio": False}
    ours = M.Metrics(enabled, sampling_rate=24000, num_workers=2)
    inline = {k: v for k, v in enabled.items() if k in JM._INLINE}
    theirs = JM.Metrics(inline, sampling_rate=24000)
    try:
        for epoch in range(2):
            ref, deg = _batch(epoch)
            ours.initialize()
            theirs.initialize()
            ours.submit(ref, deg)
            theirs.submit(ref, deg)
            got, want = ours.retrieve(), theirs.retrieve()
            for name, rate in (("pesq", 16000), ("visqol", 16000)):
                vals = []
                for r, d in zip(ref, deg):
                    r16 = resample_poly(r, 2, 3)
                    d16 = resample_poly(d, 2, 3)
                    vals.append(JM._pesq_backend(r16, d16, rate)
                                if name == "pesq" else
                                JM.measure_visqol(r16, d16, rate, "speech"))
                want[name] = float(np.mean(vals))
            assert set(got) == set(want) == {
                "stoi", "sisdr", "mcd", "pesq", "visqol"}
            for k in want:
                np.testing.assert_allclose(got[k], want[k], **TOL,
                                           err_msg=k)
        assert set(ours.state_dict()) == set(got)
        for k in theirs.state_dict():
            np.testing.assert_allclose(ours.state_dict()[k],
                                       theirs.state_dict()[k], **TOL)
    finally:
        ours.close()


def test_metrics_without_enabled_metrics_is_a_no_op():
    m = M.Metrics({"pesq": False, "stoi": False}, sampling_rate=24000)
    assert not m.enabled
    m.initialize()
    assert m._executor is None and m.retrieve() == {}
