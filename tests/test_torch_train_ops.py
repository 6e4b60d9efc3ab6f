"""The port's training ops against the JAX package on the CPU: mel
filterbanks, MelLoss value and gradient (jax.vjp against autograd), PQMF
analysis and synthesis, the STFT and filter-bank discriminators and
`Discriminators` (against both JAX lowerings of the filter-bank
discriminator), and the GAN and feature-matching losses.

Tolerances: numpy-only code (filterbanks, PQMF design) is compared
exactly; forwards and loss values to 1e-4 of the reference's largest
magnitude (f32 through different conv / FFT libraries); gradients to
1e-4 relative L2, the mel loss's to 1e-3: its clamped bins pass their
gradient through log at 1/clip_val = 1e5, which scales the f32 rounding
of the spectra up with it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import discriminators as JD
from hilcodec_tpu.models import losses as JL
from hilcodec_tpu.ops import mel as JM
from hilcodec_tpu.ops import pqmf as JP
from hilcodec_tpu.ops import stft as JS
from hilcodec_tpu.utils.pytree import leaf_paths

from hilcodec_tpu_torch.models import discriminators as TD
from hilcodec_tpu_torch.models import losses as TL
from hilcodec_tpu_torch.ops import mel as TM
from hilcodec_tpu_torch.ops import pqmf as TP
from hilcodec_tpu_torch.ops import reparam as TR
from hilcodec_tpu_torch.ops import stft as TS
from hilcodec_tpu_torch.utils import params as P

FWD_TOL = 1e-4
GRAD_TOL = 1e-4
MEL_GRAD_TOL = 1e-3
MFBD_TINY = dict(periods=[1, 2, 3], taps=16, cutoff_freqs=[0.0, 0.25, 0.17],
                 channels=[4, 8], kernel_sizes=[5, 5], strides=[3, 1])
MSTFTD_TINY = dict(filters=4, n_ffts=[64, 128], hop_lengths=[16, 32],
                   win_lengths=[64, 96], filters_scale=2)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, tol=FWD_TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def wav(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.3).astype(np.float32)


def port_params(jparams):
    """A JAX param tree -> the port's tree with the same leaves."""
    return P.unflatten({p.replace("/", "."): t(x) for p, x in zip(
        leaf_paths(jparams), jax.tree.leaves(jparams))})


# --------------------------------------------------------------- mel / stft

@pytest.mark.parametrize("htk,norm", [(True, "slaney"), (False, "slaney"),
                                      (False, None)])
def test_mel_filterbank_matches(htk, norm):
    for sr, n_fft, n_mels in ((24000, 1024, 128), (24000, 64, 16),
                              (16000, 512, 80)):
        np.testing.assert_array_equal(
            TM.mel_filterbank(sr, n_fft, n_mels, norm=norm, htk=htk),
            JM.mel_filterbank(sr, n_fft, n_mels, norm=norm, htk=htk))
    f = np.linspace(0, 12000, 97)
    np.testing.assert_array_equal(TM.hz_to_mel(f, htk), JM.hz_to_mel(f, htk))
    np.testing.assert_array_equal(TM.mel_to_hz(TM.hz_to_mel(f, htk), htk),
                                  JM.mel_to_hz(JM.hz_to_mel(f, htk), htk))
    assert TM.n_mels_without_zero_filters(24000, 64, 80) == \
        JM.n_mels_without_zero_filters(24000, 64, 80)


def test_hann_and_frame_match():
    np.testing.assert_array_equal(TS.hann_window(96).numpy(),
                                  np.asarray(JS.hann_window(96)))
    x = wav(0, (2, 300))
    np.testing.assert_array_equal(TS.frame(t(x), 64, 16).numpy(),
                                  np.asarray(JS.frame(jnp.asarray(x), 64, 16)))
    with pytest.raises(ValueError):
        TS.frame(t(x), 400, 16)


@pytest.mark.parametrize("n_mels_max", [16, 128])
def test_mel_loss_value_and_gradient(n_mels_max):
    """Value and d loss / d wav_g against jax.vjp; the generated wav has a
    silent stretch, so the straight-through clamp is exercised."""
    wg, wr = wav(1, (2, 1, 2048)), wav(2, (2, 1, 2048))
    wg[:, :, 600:1700] *= 1e-4
    jl = JL.MelLoss(24000, n_mels_max=n_mels_max)
    tl = TL.MelLoss(24000, n_mels_max=n_mels_max)
    assert [s[:2] for s in tl.transforms] == [s[:2] for s in jl.transforms]
    jv, jg = jax.jit(jax.value_and_grad(
        lambda w, r: jl(w, r)["freq"]))(jnp.asarray(wg), jnp.asarray(wr))
    w = t(wg).requires_grad_(True)
    tv = tl(w, t(wr))["freq"]
    (tg,) = torch.autograd.grad(tv, w)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=FWD_TOL)
    assert rel_l2(tg.numpy(), jg) <= MEL_GRAD_TOL


# --------------------------------------------------------------------- pqmf

@pytest.mark.parametrize("period", range(1, 12))
def test_pqmf_analysis_matches(period):
    """The MFBD's bank (taps 256, beta 8) on a 24000-sample segment:
    output length (T - 1) // period + 1 and values as in JAX."""
    x = wav(period, (2, 1, 24000))
    cutoff = 0.5 / period
    np.testing.assert_array_equal(
        TP.pqmf_filter(period, 256, cutoff, 8.0),
        JP.pqmf_filter(period, 256, cutoff, 8.0))
    got = TP.analysis(t(x), period, 256, cutoff, 8.0).numpy()
    ref = np.asarray(JP.analysis(jnp.asarray(x), period, 256, cutoff, 8.0))
    assert got.shape == (2, period, (24000 - 1) // period + 1)
    close(got, ref, what=f"period {period}")


@pytest.mark.parametrize("subbands", [2, 4])
def test_pqmf_synthesis_matches(subbands):
    y = wav(7, (2, subbands, 100))
    close(TP.synthesis(t(y), subbands, 62, 0.142, 9.0).numpy(),
          np.asarray(JP.synthesis(jnp.asarray(y), subbands, 62, 0.142, 9.0)))


def test_torch_default_conv_init():
    gen = torch.Generator().manual_seed(0)
    w, b = TR.torch_default_conv_init(gen, (8, 4, 1, 5))
    bound = 1 / np.sqrt(20)
    assert w.shape == (8, 4, 1, 5) and b.shape == (8,)
    assert float(w.abs().max()) <= bound and float(b.abs().max()) <= bound
    assert float(w.std()) > bound / 3
    w2, b2 = TR.torch_default_conv_init(torch.Generator().manual_seed(0),
                                        (8, 4, 1, 5), with_bias=False)
    assert torch.equal(w, w2) and b2 is None


# ----------------------------------------------------------- discriminators

def _fwd_both(jmod, tmod, x, lowering="conv2d"):
    jparams = jmod.init(jax.random.PRNGKey(0))
    prev = JD._FBD_LOWERING
    try:
        JD.set_fbd_lowering(lowering)
        jl, jf = jax.jit(jmod.apply)(jparams, jnp.asarray(x))
    finally:
        JD.set_fbd_lowering(prev)
    tl, tf = tmod.apply(port_params(jparams), t(x))
    return (jl, jf), (tl, tf)


def _cmp_out(j, tt, what):
    jl, jf = j
    tl, tf = tt
    jl = jl if isinstance(jl, (list, dict)) else [jl]
    tl = tl if isinstance(tl, (list, dict)) else [tl]
    if isinstance(jl, dict):
        assert list(jl) == list(tl)
        for k in jl:
            _cmp_out((jl[k], jf[k]), (tl[k], tf[k]), f"{what}/{k}")
        return
    assert len(jl) == len(tl) and len(jf) == len(tf), what
    for i, (a, b) in enumerate(zip(tl, jl)):
        close(a.detach().numpy(), b, what=f"{what} logits {i}")
    for i, (a, b) in enumerate(zip(tf, jf)):
        close(a.detach().numpy(), b, what=f"{what} fmap {i}")


def test_stft_discriminator_matches():
    x = wav(3, (2, 1, 1024))
    for kw in (dict(n_fft=64, hop_length=16, win_length=64),
               dict(n_fft=128, hop_length=32, win_length=96,
                    filters_scale=2),
               dict(n_fft=64, hop_length=16, win_length=64, magnitude=True,
                    log_magnitude=True, eps=5e-2)):
        j, tt = _fwd_both(JD.STFTDiscriminator(4, **kw),
                          TD.STFTDiscriminator(4, **kw), x)
        _cmp_out(j, tt, str(kw))


@pytest.mark.parametrize("lowering", ["conv2d", "bands1d"])
def test_filterbank_discriminator_matches(lowering):
    x = wav(4, (2, 1, 1024))
    j, tt = _fwd_both(JD.MultiFilterBankDiscriminator(**MFBD_TINY),
                      TD.MultiFilterBankDiscriminator(**MFBD_TINY), x,
                      lowering)
    _cmp_out(j, tt, f"mfbd {lowering}")
    assert JD._FBD_LOWERING == "conv2d"


@pytest.mark.parametrize("lowering", ["conv2d", "bands1d"])
def test_discriminators_match(lowering):
    kw = dict(mfbd_kwargs=dict(use=True, **MFBD_TINY),
              mstftd_kwargs=dict(use=True, **MSTFTD_TINY),
              mpd_kwargs=dict(use=False))
    x = wav(5, (2, 1, 1024))
    j, tt = _fwd_both(JD.Discriminators(**kw), TD.Discriminators(**kw), x,
                      lowering)
    _cmp_out(j, tt, f"discriminators {lowering}")


def test_unported_discriminators_point_at_roadmap():
    """mpd, msd and sbd build in the aggregate (ported; no longer refused)
    and match JAX: MPD and MSD at their defaults, SBD at a tiny width."""
    sbd = dict(use=True, channels=[[4, 8]], strides=[[1, 3]],
               kernel_sizes=[[[5, 5], [5, 5]]],
               dilations=[[[1, 2], [1, 2]]], band_ranges=[[0, 2]],
               transpose=[False],
               pqmf_kwargs={"subbands": 4, "taps": 32, "cutoff_freq": 0.1,
                            "beta": 10.0})
    x = wav(8, (2, 1, 1024))
    for name, kw in (("mpd", {"use": True}), ("msd", {"use": True}),
                     ("sbd", sbd)):
        kwargs = {f"{name}_kwargs": kw}
        assert list(TD.Discriminators(**kwargs).discs) == [name]
        j, tt = _fwd_both(JD.Discriminators(**kwargs),
                          TD.Discriminators(**kwargs), x)
        _cmp_out(j, tt, name)


def test_discriminator_init_shapes_match_jax():
    kw = dict(mfbd_kwargs=dict(use=True, **MFBD_TINY),
              mstftd_kwargs=dict(use=True, **MSTFTD_TINY))
    jparams = JD.Discriminators(**kw).init(jax.random.PRNGKey(0))
    tparams = TD.Discriminators(**kw).init(torch.Generator().manual_seed(0))
    want = {p: np.shape(x) for p, x in zip(leaf_paths(jparams),
                                           jax.tree.leaves(jparams))}
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in P.flatten(tparams).items()}
    assert got == want


# ------------------------------------------------------------ GAN / FM losses

def test_gan_and_feature_losses_match():
    rng = np.random.default_rng(6)
    shapes = {"mfbd": [(2, 7), (2, 5)], "mstftd": [(2, 1, 4, 3)]}
    lg = {k: [rng.standard_normal(s).astype(np.float32) for s in v]
          for k, v in shapes.items()}
    lr = {k: [rng.standard_normal(s).astype(np.float32) for s in v]
          for k, v in shapes.items()}
    jt = lambda d: {k: [jnp.asarray(x) for x in v] for k, v in d.items()}
    tt = lambda d: {k: [t(x) for x in v] for k, v in d.items()}
    for fn in ("generator_loss", "generator_loss_lsgan"):
        for norm in (True, False):
            ref = getattr(JL, fn)(jt(lg), normalize=norm)
            got = getattr(TL, fn)(tt(lg), normalize=norm)
            assert set(ref) == set(got)
            for k in ref:
                np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                           rtol=1e-6, err_msg=fn)
    for fn in ("discriminator_loss", "discriminator_loss_lsgan"):
        for norm in (True, False):
            np.testing.assert_allclose(
                float(getattr(TL, fn)(tt(lg), tt(lr), normalize=norm)),
                float(getattr(JL, fn)(jt(lg), jt(lr), normalize=norm)),
                rtol=1e-6, err_msg=fn)
    for fn in ("feature_loss", "feature_loss_normalized"):
        ref_v, pull = jax.vjp(
            lambda g: getattr(JL, fn)(g, jt(lr))["mfbd_fm"], jt(lg))
        ref_g = pull(jnp.ones_like(ref_v))[0]
        g = {k: [t(x).requires_grad_(True) for x in v] for k, v in lg.items()}
        got = getattr(TL, fn)(g, tt(lr))
        np.testing.assert_allclose(float(got["mfbd_fm"]), float(ref_v),
                                   rtol=1e-6, err_msg=fn)
        grads = torch.autograd.grad(got["mfbd_fm"], g["mfbd"])
        for a, b in zip(grads, ref_g["mfbd"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-8, err_msg=fn)
