"""The port's Avocodo family against the JAX package's, on the CPU.

Both sides get the same seeded numpy inputs and the same parameters (the
JAX tree's leaves, zero-init scales set nonzero, through the port's
checkpoint bridge). Covered: the multi-scale decoder's three outputs and
its streaming step (outputs and caches), `CodecModel(AvocodoModel)`
offline and streaming, the deployment fold, MDC / SBDBlock / SBD (plain
and transposed bands) / CoMBD / AvocodoDiscriminators, `pqmf_targets`,
the loss STFT, HifiGANMelLoss (value and gradient), SimpleBalancer, and
the full-width configs/avocodo_music.yaml model's names, shapes and
caches.

Bars: tokens exact or a provable f32 tie
(`assert_token_parity_exact_or_fp_tie` of tests/test_rvq.py); waveforms,
caches, logits and feature maps <= ATOL absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import avocodo as JA
from hilcodec_tpu.models import discriminators as JD
from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.models.losses import HifiGANMelLoss as JaxHifiGANMelLoss
from hilcodec_tpu.models.registry import build_codec_model as jax_build
from hilcodec_tpu.ops import stft as JS
from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ
from hilcodec_tpu.train.balancer import SimpleBalancer as JaxSimpleBalancer
from hilcodec_tpu.utils.checkpoint import _flatten
from hilcodec_tpu.utils.hparams import load_config as jax_load_config
from hilcodec_tpu.utils.pytree import leaf_paths

from hilcodec_tpu_torch.models import avocodo as TA
from hilcodec_tpu_torch.models import discriminators as TD
from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.losses import HifiGANMelLoss
from hilcodec_tpu_torch.models.registry import build_codec_model
from hilcodec_tpu_torch.ops import stft as TS
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.train.balancer import SimpleBalancer
from hilcodec_tpu_torch.utils import params as P
from hilcodec_tpu_torch.utils.hparams import load_config

from test_rvq import assert_token_parity_exact_or_fp_tie
from torch_port_common import jax_tree, n, seeded_flat, t
from test_torch_train_loop import ROOT

ATOL = 1e-5
CPU = torch.device("cpu")
CONFIG = f"{ROOT}/configs/avocodo_music.yaml"
# strides put the three heads at 1/8, 1/2 and the full rate, as the
# shipped [8, 5, 4, 2] does; two residual layers exercise pre_scale
TINY = dict(channels_enc=8, channels_dec=8, n_fft_base=16,
            n_residual_enc=1, n_residual_dec=2, strides=(4, 2, 4, 2),
            vq_dim=16, res_scale_enc=0.577, res_scale_dec=0.577)
TINY_VQ = dict(dim=16, codebook_size=32, num_quantizers=4,
               kmeans_init=False)
PQMF = {"lv1": (2, 256, 0.25, 10.0), "lv2": (8, 256, 0.067, 10.0)}
# CoMBD at tiny widths, grouped convs included (the shipped groups reach
# 256 over 1024 channels)
COMBD = {"use": True, "h": {
    "combd_h_u": [[4, 8, 8], [4, 8, 8], [4, 8, 8]],
    "combd_d_k": [[7, 11, 5], [11, 21, 5], [15, 41, 5]],
    "combd_d_s": [[1, 4, 1], [1, 4, 1], [1, 4, 1]],
    "combd_d_d": [[1, 1, 1], [1, 1, 1], [1, 1, 1]],
    "combd_d_g": [[1, 4, 1], [1, 4, 1], [1, 4, 1]],
    "combd_d_p": [[3, 5, 2], [5, 10, 2], [7, 20, 2]],
    "combd_op_f": [1, 1, 1], "combd_op_k": [3, 3, 3],
    "combd_op_g": [1, 1, 1],
    "pqmf_config": {"lv1": [2, 256, 0.25, 10.0],
                    "lv2": [8, 256, 0.067, 10.0]}}}
SEGMENT = 2048
# SBD at tiny widths: three bands of a 4-band PQMF and, transposed, the
# time-bands of an 8-band one over a SEGMENT-sample input
SBD = {"use": True, "h": {
    "sbd_filters": [[4, 8], [4, 8], [4, 8]],
    "sbd_strides": [[1, 3], [1, 3], [1, 3]],
    "sbd_kernel_sizes": [[[7, 7, 7], [7, 7, 7]], [[5, 5, 5], [5, 5, 5]],
                         [[3, 3, 3], [3, 3, 3]]],
    "sbd_dilations": [[[5, 7, 11], [5, 7, 11]], [[1, 2, 3], [1, 2, 3]],
                      [[1, 2, 3], [2, 3, 5]]],
    "sbd_band_ranges": [[0, 2], [1, 4], [0, 8]],
    "sbd_transpose": [False, False, True],
    "pqmf_config": {"sbd": [4, 32, 0.1, 10.0], "fsbd": [8, 32, 0.1, 9.0]},
    "segment_size": SEGMENT}}


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=atol)


def _same_params(jax_mod, port_mod, seed=0):
    """(jax params, port params) of one module, equal leaf for leaf."""
    template = jax_mod.init(jax.random.PRNGKey(seed))
    flat = seeded_flat(template, seed)
    ref = port_mod.init(torch.Generator().manual_seed(0))
    return jax_tree(template, flat), P.from_flat(flat, ref)


def _wav(rng, shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    jm = JaxCodecModel(JA.AvocodoModel(**TINY), JaxResidualVQ(**TINY_VQ))
    tm = CodecModel(TA.AvocodoModel(**TINY), ResidualVQ(**TINY_VQ), CPU)
    jp, tp = _same_params(jm.codec, tm.codec)
    books = (np.random.default_rng(1).standard_normal((4, 32, 16)) * 0.5
             ).astype(np.float32)
    return jm, tm, jp, tp, books


def test_decoder_three_scales_match_jax(tiny, rng):
    jm, tm, jp, tp, _ = tiny
    z = rng.standard_normal((2, 16, 6)).astype(np.float32)
    ref = jm.codec.decoder.apply(jp["decoder"], jnp.asarray(z))
    ours = tm.codec.decoder.apply(tp["decoder"], t(z))
    hop = tm.hop_length
    assert [y.shape[-1] for y in ours] == [6 * hop // 8, 6 * hop // 2,
                                           6 * hop]
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close(a, b)
    _close(tm.codec.decoder.apply(tp["decoder"], t(z), return_list=False),
           ref[-1])


def test_decoder_step_matches_batch_and_jax(tiny, rng):
    """Three steps of two frames, each against JAX's step (output and every
    cache), and the whole against the full-rate head of apply."""
    jm, tm, jp, tp, _ = tiny
    dec_j, dec_t = jm.codec.decoder, tm.codec.decoder
    z = rng.standard_normal((2, 16, 6)).astype(np.float32)
    jc, tc = dec_j.init_cache(2), dec_t.init_cache(2)
    assert [tuple(c.shape) for c in tc] == [c.shape for c in jc]
    outs = []
    for i in range(3):
        zi = z[:, :, 2 * i:2 * i + 2]
        jy, jc = dec_j.step(jp["decoder"], jc, jnp.asarray(zi))
        ty, tc = dec_t.step(tp["decoder"], tc, t(zi))
        _close(ty, jy)
        for a, b in zip(tc, jc):
            _close(a, b)
        outs.append(ty)
    _close(torch.cat(outs, -1),
           dec_t.apply(tp["decoder"], t(z), return_list=False))


def test_codec_model_offline_and_streaming_match_jax(tiny, rng):
    """Tokens of encode / encode_stream / encode_decode_stream exact or
    ties; decode's three scales, decode_stream and the roundtrip wav
    <= ATOL; the stream's tokens equal the offline ones."""
    jm, tm, jp, tp, books = tiny
    vq = {"embed": jnp.asarray(books)}
    tvq = {"embed": t(books)}
    hop = tm.hop_length
    wav = _wav(rng, (2, 1, hop * 6))
    z = np.asarray(jm.codec.encoder.apply(jp["encoder"], jnp.asarray(wav)))
    _close(tm.codec.encoder.apply(tp["encoder"], t(wav)), z)
    latents = z.transpose(0, 2, 1)

    tok = tm.encode(tp, tvq, t(wav))
    assert_token_parity_exact_or_fp_tie(n(tok), latents, books, 4)
    ref_tok = jm.encode(jp, vq, jnp.asarray(wav))
    ref_ys = jm.decode(jp, vq, ref_tok)
    ys = tm.decode(tp, tvq, t(np.asarray(ref_tok)))
    for a, b in zip(ys, ref_ys):
        _close(a, b)

    ce, cd = tm.init_cache(2)
    stok, _ = tm.encode_stream(tp, tvq, t(wav), ce)
    assert torch.equal(stok, tok)
    # the streamed full-rate head on JAX's tokens: JAX's stream and the
    # offline head
    swav, _ = tm.decode_stream(tp, tvq, t(np.asarray(ref_tok)), cd)
    jwav, _ = jm.decode_stream(jp, vq, ref_tok, jm.init_cache(2)[1])
    _close(swav, jwav)
    _close(swav, ys[-1])
    ce, cd = tm.init_cache(2)
    rtok, rwav, _, _ = tm.encode_decode_stream(tp, tvq, t(wav), ce, cd,
                                               n=2, frames_per_step=2)
    assert rtok.shape == (2, 2, 6)
    assert torch.equal(rtok, tok[:2])
    jtok, jwav2, _, _ = jm.encode_decode_stream(
        jp, vq, jnp.asarray(wav), *jm.init_cache(2), n=2)
    assert np.array_equal(n(rtok), np.asarray(jtok))
    _close(rwav, jwav2)


def test_fold_params_matches_jax_and_streams_the_same(tiny, rng):
    jm, tm, jp, tp, books = tiny
    jf, tf = jm.codec.fold_params(jp), tm.fold_params(tp)
    jflat = _flatten(jf)
    tflat = P.to_flat(tf)
    assert set(jflat) == set(tflat)
    for k, v in jflat.items():
        np.testing.assert_allclose(tflat[k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    tvq = {"embed": t(books)}
    hop = tm.hop_length
    wav = _wav(rng, (1, 1, hop * 4))
    a = tm.encode_decode_stream(tp, tvq, t(wav), *tm.init_cache(1))
    b = tm.encode_decode_stream(tf, tvq, t(wav), *tm.init_cache(1))
    assert torch.equal(a[0], b[0])
    _close(a[1], b[1])


def _cmp_disc(out_j, out_t):
    (lj, fj), (lt, ft) = out_j, out_t
    assert len(lj) == len(lt) and len(fj) == len(ft)
    for a, b in zip(lt + ft, lj + fj):
        assert tuple(a.shape) == b.shape
        _close(a, b)


def test_mdc_and_sbd_block_match_jax(rng):
    """MDC pads its strided post conv with the last dilated conv's
    padding, as the reference does; an SBDBlock stacks them."""
    mj = JD.MDC(3, 5, 3, (7, 5, 3), (5, 2, 1))
    mt = TD.MDC(3, 5, 3, (7, 5, 3), (5, 2, 1))
    jp, tp = _same_params(mj, mt)
    x = _wav(rng, (2, 3, 40))
    y = mt.apply(tp, t(x))
    assert y.shape[-1] == (40 + 2 * 2 - 3) // 3 + 1
    _close(y, mj.apply(jp, jnp.asarray(x)))
    bj = JD.SBDBlock(3, (1, 3), (4, 6), ((7, 7, 7), (3, 3, 3)),
                     ((5, 7, 11), (1, 2, 3)))
    bt = TD.SBDBlock(3, (1, 3), (4, 6), ((7, 7, 7), (3, 3, 3)),
                     ((5, 7, 11), (1, 2, 3)))
    jp, tp = _same_params(bj, bt)
    lj, fj = bj.apply(jp, jnp.asarray(x))
    lt, ft = bt.apply(tp, t(x))
    _cmp_disc(([lj], fj), ([lt], ft))


@pytest.mark.parametrize("orthonormal", [False, True])
def test_sbd_matches_jax(orthonormal, rng):
    kw = dict(channels=((4, 8), (4, 8), (4, 8)),
              strides=((1, 3), (1, 3), (1, 3)),
              kernel_sizes=(((7, 7, 7), (7, 7, 7)), ((5, 5, 5), (5, 5, 5)),
                            ((3, 3, 3), (3, 3, 3))),
              dilations=(((5, 7, 11), (5, 7, 11)), ((1, 2, 3), (1, 2, 3)),
                         ((1, 2, 3), (2, 3, 5))),
              band_ranges=((0, 2), (1, 4), (0, 8)),
              transpose=(False, False, True),
              pqmf_kwargs={"subbands": 4, "taps": 32, "cutoff_freq": 0.1,
                           "beta": 10.0},
              f_pqmf_kwargs={"subbands": 8, "taps": 32, "cutoff_freq": 0.1,
                             "beta": 9.0},
              segment_size=SEGMENT, pqmf_orthonormal=orthonormal)
    dj, dt = JD.SBD(**kw), TD.SBD(**kw)
    jp, tp = _same_params(dj, dt)
    x = _wav(rng, (2, 1, SEGMENT))
    _cmp_disc(dj.apply(jp, jnp.asarray(x)), dt.apply(tp, t(x)))


def test_combd_and_avocodo_discriminators_match_jax(rng):
    """CoMBD's hierarchical path over three scales and its multi-scale
    path over PQMF bands of the full-rate one (5 logits), and the
    {combd, sbd} aggregate over the targets of a SEGMENT-sample wav."""
    wav = _wav(rng, (2, 1, SEGMENT))
    ys_j = JA.pqmf_targets(jnp.asarray(wav), PQMF)
    ys_t = TA.pqmf_targets(t(wav), PQMF)
    assert [y.shape[-1] for y in ys_t] == [256, 1024, 2048]
    for a, b in zip(ys_t, ys_j):
        _close(a, b)
    dj = JA.AvocodoDiscriminators(combd_kwargs=COMBD, sbd_kwargs=SBD)
    dt = TA.AvocodoDiscriminators(combd_kwargs=COMBD, sbd_kwargs=SBD)
    assert list(dt.discs) == ["combd", "sbd"]
    jp, tp = _same_params(dj, dt)
    (lj, fj), (lt, ft) = dj.apply(jp, ys_j), dt.apply(tp, ys_t)
    assert len(lt["combd"]) == 5 and len(lt["sbd"]) == 3
    for name in ("combd", "sbd"):
        _cmp_disc((lj[name], fj[name]), (lt[name], ft[name]))


@pytest.mark.parametrize("center,magnitude,win", [
    (False, True, 64), (True, True, 64), (False, False, 48)])
def test_stft_matches_jax(center, magnitude, win, rng):
    x = _wav(rng, (2, 1, 700))
    ref = JS.stft(jnp.asarray(x), 64, 16, win, center=center,
                  magnitude=magnitude)
    ours = TS.stft(t(x), 64, 16, win, center=center, magnitude=magnitude)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(n(ours), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def test_hifigan_mel_loss_and_gradient_match_jax(rng):
    """The Avocodo trainer's mel loss at its shape (n_fft 1024, 80 mels,
    the model hop 320) on half a second: the loss <= 1e-5 relative and
    its gradient for the generated wav <= 1e-4 relative in L2."""
    g, r = _wav(rng, (2, 1, 12000)), _wav(rng, (2, 1, 12000))
    jl = JaxHifiGANMelLoss(24000, 1e-5, 1024, 80, 320, 1024)
    tl = HifiGANMelLoss(24000, 1e-5, 1024, 80, 320, 1024)
    ref, jgrad = jax.value_and_grad(
        lambda w: jl(w, jnp.asarray(r))["freq"])(jnp.asarray(g))
    w = t(g).requires_grad_(True)
    ours = tl(w, t(r))["freq"]
    (grad,) = torch.autograd.grad(ours, w)
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-5)
    jgrad = np.asarray(jgrad, np.float64)
    assert (np.linalg.norm(n(grad) - jgrad) / np.linalg.norm(jgrad)
            <= 1e-4)


def test_simple_balancer_matches_jax():
    cfg = {"weights": {"freq": 45, "combd_g": 1.0, "combd_fm": 2.0},
           "weight_others": 0.01, "ema_decay": 0.99}
    jb, tb = JaxSimpleBalancer.from_config(cfg), SimpleBalancer.from_config(
        cfg)
    assert tb.weights == jb.weights and tb.weight_others == 0.01
    losses = {"freq": 0.7, "combd_g": 2.5, "combd_fm": 1.25}
    ref = jb.total({k: jnp.asarray(v) for k, v in losses.items()},
                   jnp.asarray(0.3))
    ours = tb.total({k: torch.tensor(v) for k, v in losses.items()},
                    torch.tensor(0.3))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def test_full_width_config_names_shapes_and_caches():
    """configs/avocodo_music.yaml: encoder 64 / decoder 96, RVQ 12 x 1024
    x 128; the port's leaf names and shapes, unfolded and folded, and its
    caches are JAX's."""
    hps, jhps = load_config(CONFIG), jax_load_config(CONFIG)
    tm = build_codec_model(hps.model, hps.model_kwargs.to_dict(),
                           device="cpu")
    jm = jax_build(jhps.model, jhps.model_kwargs.to_dict())
    assert isinstance(tm.codec, TA.AvocodoModel) and tm.hop_length == 320
    assert (tm.vq.num_quantizers, tm.vq.codebook_size, tm.vq.dim) == (
        12, 1024, 128)
    assert tm.vq.dropout_index == (2, 4, 8, 12)
    # JAX's trees by shape only (eval_shape), not computed at full width
    jp = jax.eval_shape(jm.codec.init, jax.random.PRNGKey(0))
    for port, ref in ((tm.param_template(False), jp),
                      (tm.param_template(True),
                       jax.eval_shape(jm.codec.fold_params, jp))):
        want = dict(zip(leaf_paths(ref),
                        [x.shape for x in jax.tree.leaves(ref)]))
        got = {k: v.shape for k, v in P.to_flat(port).items()}
        assert got == want
    for a, b in zip(tm.init_cache(1), jm.codec.init_cache(1)):
        assert [tuple(c.shape) for c in a] == [c.shape for c in b]
    assert tm.cache_axes() == ([0] * len(tm.init_cache(1)[0]),
                               [0] * len(tm.init_cache(1)[1]))
