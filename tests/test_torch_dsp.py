"""The port's DSP primitives that no ported path calls, against the JAX
package on the CPU: `ops/mdct.py` (stdct / istdct, mdct / imdct, their
filterbanks) and `ops/stft.istft`, within 1e-5 of the reference's largest
magnitude (f32 framed matmuls and overlap-adds summed in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hilcodec_tpu.ops import mdct as JM
from hilcodec_tpu.ops import stft as JS

from hilcodec_tpu_torch.ops import mdct as TM
from hilcodec_tpu_torch.ops import stft as TS

TOL = 1e-5


def close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= TOL * scale, what


@pytest.mark.parametrize("win_size,center,win_type", [
    (None, False, "hann"), (48, True, "hann"), (None, False, None)])
def test_stdct_and_istdct_match_jax(win_size, center, win_type):
    rng = np.random.default_rng(0)
    y = rng.standard_normal((2, 1, 256)).astype(np.float32)
    basis_t, win_t = TM.dct_filter(64, win_size, win_type)
    basis_j, win_j = JM.dct_filter(64, win_size, win_type)
    np.testing.assert_array_equal(basis_t, basis_j)
    np.testing.assert_array_equal(win_t, win_j)
    spec = TM.stdct(torch.from_numpy(y), 64, 16, win_size, center, win_type)
    close(spec.numpy(), JM.stdct(jnp.asarray(y), 64, 16, win_size, center,
                                 win_type), "stdct")
    s = rng.standard_normal(tuple(spec.shape)).astype(np.float32)
    close(TM.istdct(torch.from_numpy(s), 64, 16, win_size, center,
                    win_type).numpy(),
          JM.istdct(jnp.asarray(s), 64, 16, win_size, center, win_type),
          "istdct")


@pytest.mark.parametrize("normalize", [False, True])
def test_mdct_and_imdct_match_jax(normalize):
    rng = np.random.default_rng(1)
    y = rng.standard_normal((2, 1, 32 * 8)).astype(np.float32)
    np.testing.assert_array_equal(TM.mdct_filter(32), JM.mdct_filter(32))
    spec = TM.mdct(torch.from_numpy(y), 32, normalize)
    assert spec.shape == (2, 32, 9)
    close(spec.numpy(), JM.mdct(jnp.asarray(y), 32, normalize), "mdct")
    back = TM.imdct(spec, 32, normalize)
    close(back.numpy(), JM.imdct(jnp.asarray(spec.numpy()), 32, normalize),
          "imdct")


@pytest.mark.parametrize("n_fft,hop,win", [(64, 16, 64), (64, 16, 48)])
def test_istft_matches_jax(n_fft, hop, win):
    """The centred inverse of the loss STFT, on random spectra and on the
    STFT of a signal (which it inverts)."""
    rng = np.random.default_rng(2)
    spec = rng.standard_normal((2, n_fft // 2 + 1, 12, 2)).astype(np.float32)
    close(TS.istft(torch.from_numpy(spec), n_fft, hop, win).numpy(),
          JS.istft(jnp.asarray(spec), n_fft, hop, win), "random spectra")
    x = rng.standard_normal((2, hop * 20)).astype(np.float32)
    s = TS.stft(torch.from_numpy(x), n_fft, hop, win, center=True,
                magnitude=False)
    got = TS.istft(s, n_fft, hop, win)
    close(got.numpy(), JS.istft(jnp.asarray(s.numpy()), n_fft, hop, win),
          "signal")
    close(got.numpy(), x[:, :got.shape[-1]], "inverse")
    with pytest.raises(NotImplementedError, match="center=True"):
        TS.istft(s, n_fft, hop, win, center=False)
