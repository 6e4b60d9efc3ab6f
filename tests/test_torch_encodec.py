"""The port's EnCodec family against the JAX package's, on the CPU.

Both sides get the same seeded numpy inputs and the same parameters (the
JAX tree's leaves, through the port's checkpoint bridge). Covered: reflect
padding (inputs shorter than the pad included), the LSTM (apply, and step
with its (h, c) carry), the residual block, the encoder and decoder in
apply and step at a tiny width with the shipped `pad_mode: reflect`, the
CodecModel drivers at 1 and 2 frames a step, the plain cascade at
n_q = 32 against JAX's staged RVQ kernel (K2) in Pallas interpret mode,
the deployment fold, and the full-width configs/encodec_24khz.yaml model
(leaf names and shapes, caches, a few streamed frames).

Bars: tokens exact or a provable f32 tie
(`assert_token_parity_exact_or_fp_tie` of tests/test_rvq.py); waveforms,
latents and caches <= WAVE_ATOL absolute (measured <= 1e-6 here: the
LSTM's cell is the same f32 sum on both sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import encodec as JE
from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.models.registry import build_codec_model as jax_build
from hilcodec_tpu.ops import conv as JC
from hilcodec_tpu.ops.pallas_rvq import quantize_pallas
from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ
from hilcodec_tpu.utils.checkpoint import _flatten
from hilcodec_tpu.utils.hparams import load_config as jax_load_config

from hilcodec_tpu_torch.models import encodec as TE
from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.registry import build_codec_model
from hilcodec_tpu_torch.ops import conv as TC
from hilcodec_tpu_torch.ops import rvq as TQ
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.utils import params as P
from hilcodec_tpu_torch.utils.hparams import load_config

from test_rvq import assert_token_parity_exact_or_fp_tie
from torch_port_common import jax_tree, n, seeded_flat, t
from test_torch_train_loop import ROOT

WAVE_ATOL = 1e-5
CPU = torch.device("cpu")
# two stages, a 2-layer LSTM of width 32, reflect padding (the default)
TINY = dict(channels_enc=8, channels_dec=8, strides=(4, 2), lstm=2,
            vq_dim=16, n_residual_layers=1)
TINY_VQ = dict(dim=16, codebook_size=32, num_quantizers=4,
               kmeans_init=False)
CONFIG = f"{ROOT}/configs/encodec_24khz.yaml"


def _close(a, b, atol=WAVE_ATOL):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=atol)


def _same_params(jax_mod, port_mod, seed=0):
    """(jax params, port params) of one module, equal leaf for leaf."""
    template = jax_mod.init(jax.random.PRNGKey(seed))
    flat = seeded_flat(template, seed)
    ref = port_mod.init(torch.Generator().manual_seed(0))
    return jax_tree(template, flat), P.from_flat(flat, ref)


@pytest.fixture(scope="module")
def tiny():
    jm = JaxCodecModel(JE.EncodecModel(**TINY), JaxResidualVQ(**TINY_VQ))
    tm = CodecModel(TE.EncodecModel(**TINY), ResidualVQ(**TINY_VQ), CPU)
    jp, tp = _same_params(jm.codec, tm.codec)
    books = (np.random.default_rng(1).standard_normal((4, 32, 16)) * 0.5
             ).astype(np.float32)
    return jm, tm, jp, tp, books


@pytest.mark.parametrize("length,k,stride,dilation", [
    (1, 7, 1, 1), (3, 7, 1, 1), (6, 7, 1, 1), (7, 7, 1, 1), (20, 7, 1, 1),
    (2, 3, 1, 2), (9, 3, 1, 4), (4, 8, 4, 1), (5, 8, 4, 1), (3, 4, 2, 1)])
def test_reflect_causal_conv1d_matches_jax(length, k, stride, dilation, rng):
    """numpy's reflect, which reflects again when the pad (k-1)d-(s-1) is
    as long as the input or longer (1-20 samples against pads of 3-8)."""
    x = rng.standard_normal((2, 3, length)).astype(np.float32)
    w = rng.standard_normal((4, 3, k)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    ref = JC.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           stride, dilation, pad_mode="reflect")
    ours = TC.causal_conv1d(t(x), t(w), t(b), stride, dilation,
                            pad_mode="reflect")
    assert ours.shape == ref.shape
    _close(ours, ref)


def test_reflect_index_is_numpys():
    for length in range(1, 6):
        for left in range(0, 13, 3):
            x = np.arange(length, dtype=np.float32)[None, None]
            want = np.pad(x, ((0, 0), (0, 0), (left, 2)), mode="reflect")
            got = TC.pad1d(t(x), (left, 2), "reflect")
            np.testing.assert_array_equal(n(got), want)


def test_slstm_apply_and_step_match_jax(rng):
    """apply over 12 steps, and 4 steps of 3 with the (h, c) carry."""
    jm, tm = JE.SLSTM(32, 2), TE.SLSTM(32, 2)
    jp, tp = _same_params(jm, tm)
    x = rng.standard_normal((2, 32, 12)).astype(np.float32)
    _close(tm.apply(tp, t(x)), jm.apply(jp, jnp.asarray(x)))
    jc, tc = jm.init_cache(2), tm.init_cache(2)
    for i in range(4):
        xi = x[:, :, 3 * i:3 * i + 3]
        jy, jc = jm.step(jp, jc, jnp.asarray(xi))
        ty, tc = tm.step(tp, tc, t(xi))
        _close(ty, jy)
        for a, b in zip(tc, jc):
            assert a.shape == b.shape == (2, 2, 32)
            _close(a, b)


def test_slstm_cache_tensors_are_distinct():
    """h and c are two tensors, so an in-place update of one (the slot
    engine's) leaves the other alone."""
    h, c = TE.SLSTM(8, 2).init_cache(3)
    assert h.data_ptr() != c.data_ptr()
    h += 1.0
    assert not c.any()


def test_resnet_block_matches_jax(rng):
    jm = JE.EncodecResnetBlock(8, dilations=(2, 1))
    tm = TE.EncodecResnetBlock(8, dilations=(2, 1))
    jp, tp = _same_params(jm, tm)
    x = rng.standard_normal((2, 8, 10)).astype(np.float32)
    _close(tm.apply(tp, t(x)), jm.apply(jp, jnp.asarray(x)))
    jc, tc = jm.init_cache(2), tm.init_cache(2)
    for i in range(2):
        xi = x[:, :, 5 * i:5 * i + 5]
        jy, jc = jm.step(jp, jc, jnp.asarray(xi))
        ty, tc = tm.step(tp, tc, t(xi))
        _close(ty, jy)
        for a, b in zip(tc, jc):
            _close(a, b)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_encoder_decoder_apply_and_step_match_jax(tiny, part, rng):
    jm, tm, jp, tp, _ = tiny
    jl, tl = getattr(jm.codec, part), getattr(tm.codec, part)
    hop = tm.hop_length
    if part == "encoder":
        x = (rng.standard_normal((2, 1, 6 * hop)) * 0.3).astype(np.float32)
        chunk = 2 * hop
    else:
        x = rng.standard_normal((2, 16, 6)).astype(np.float32)
        chunk = 2
    _close(tl.apply(tp[part], t(x)), jl.apply(jp[part], jnp.asarray(x)))
    jc, tc = jl.init_cache(2), tl.init_cache(2)
    assert [tuple(c.shape) for c in tc] == [c.shape for c in jc]
    for i in range(3):
        xi = x[:, :, i * chunk:(i + 1) * chunk]
        jy, jc = jl.step(jp[part], jc, jnp.asarray(xi))
        ty, tc = tl.step(tp[part], tc, t(xi))
        _close(ty, jy)
        for a, b in zip(tc, jc):
            _close(a, b)


def test_cache_axes_name_the_batch_axis(tiny):
    _, tm, _, _, _ = tiny
    for caches1, caches3, axes in zip(tm.init_cache(1), tm.init_cache(3),
                                      tm.cache_axes()):
        assert len(caches1) == len(caches3) == len(axes)
        for a, b, ax in zip(caches1, caches3, axes):
            assert a.shape[ax] == 1 and b.shape[ax] == 3
    enc_axes, dec_axes = tm.cache_axes()
    assert enc_axes.count(1) == 2 and dec_axes.count(1) == 2


def test_codec_offline_coding_matches_jax(tiny, rng):
    jm, tm, jp, tp, books = tiny
    wav = (rng.standard_normal((2, 1, 8 * tm.hop_length)) * 0.3
           ).astype(np.float32)
    jv, tv = {"embed": jnp.asarray(books)}, {"embed": t(books)}
    z = n(tm.codec.encoder.apply(tp["encoder"], t(wav)))
    tok = tm.encode(tp, tv, t(wav))
    assert tok.shape == (4, 2, 8)
    assert_token_parity_exact_or_fp_tie(n(tok), z.transpose(0, 2, 1),
                                        books, 4)
    np.testing.assert_array_equal(n(tok), n(jm.encode(jp, jv,
                                                      jnp.asarray(wav))))
    _close(tm.decode(tp, tv, tok), jm.decode(jp, jv, jnp.asarray(n(tok))))


@pytest.mark.parametrize("f", [1, 2])
def test_codec_streaming_matches_jax(tiny, f, rng):
    """encode_stream, decode_stream and encode_decode_stream at f frames a
    step, with the caches they hand back."""
    jm, tm, jp, tp, books = tiny
    jv, tv = {"embed": jnp.asarray(books)}, {"embed": t(books)}
    wav = (rng.standard_normal((2, 1, 6 * tm.hop_length)) * 0.3
           ).astype(np.float32)
    jce, jcd = jm.init_cache(2)
    tce, tcd = tm.init_cache(2)
    jtok, jce2 = jm.encode_stream(jp, jv, jnp.asarray(wav), jce,
                                  frames_per_step=f)
    ttok, tce2 = tm.encode_stream(tp, tv, t(wav), tce, frames_per_step=f)
    np.testing.assert_array_equal(n(ttok), n(jtok))
    for a, b in zip(tce2, jce2):
        _close(a, b)
    jout, _ = jm.decode_stream(jp, jv, jtok, jcd, frames_per_step=f)
    tout, _ = tm.decode_stream(tp, tv, ttok, tcd, frames_per_step=f)
    _close(tout, jout)
    r = jm.encode_decode_stream(jp, jv, jnp.asarray(wav), jce, jcd,
                                frames_per_step=f)
    s = tm.encode_decode_stream(tp, tv, t(wav), tce, tcd, frames_per_step=f)
    np.testing.assert_array_equal(n(s[0]), n(r[0]))
    _close(s[1], r[1])
    for a, b in zip(s[2] + s[3], r[2] + r[3]):
        _close(a, b)
    # the tokens are the stack's, up to fp ties, on the latents streamed
    z, _ = tm.codec.encoder.step(tp["encoder"], tm.init_cache(2)[0], t(wav))
    assert_token_parity_exact_or_fp_tie(n(s[0]), n(z).transpose(0, 2, 1),
                                        books, 4)


def test_megakernel_refuses_encodec(tiny):
    _, tm, _, tp, books = tiny
    wav = torch.zeros((1, 1, tm.hop_length))
    with pytest.raises(ValueError, match="HILCodec only"):
        tm.encode_stream(tp, {"embed": t(books)}, wav, tm.init_cache(1)[0],
                         megakernel=True)


def test_plain_cascade_at_32_stages_matches_staged_kernel(rng):
    """n_q = 32, the stack size for which the JAX package picks K2; K2 runs
    in Pallas interpret mode, as the JAX package's tests run it."""
    books = rng.standard_normal((32, 64, 16)).astype(np.float32)
    x = (rng.standard_normal((2, 9, 16)) * 2).astype(np.float32)
    ref = quantize_pallas(jnp.asarray(x), jnp.asarray(books),
                          interpret=True, staged=True)
    ours = TQ.quantize(t(x), t(books))
    assert ours.shape == (32, 2, 9)
    np.testing.assert_array_equal(n(ours), n(ref))
    assert_token_parity_exact_or_fp_tie(n(ours), x, books, 32)


def test_fold_params_matches_jax(tiny):
    jm, tm, jp, tp, _ = tiny
    ours = P.to_flat(tm.fold_params(tp))
    theirs = _flatten(jm.fold_params(jp))
    assert set(ours) == set(theirs)
    assert "encoder/lstm/layers/0/w_ih" in ours
    assert not any(k.endswith("/v") or k.endswith("/g") for k in ours)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], np.asarray(v), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert P.is_folded(ours) and not P.is_folded(P.to_flat(tp))


@pytest.fixture(scope="module")
def full():
    """configs/encodec_24khz.yaml at full width on both sides."""
    jm = jax_build("encodec",
                   jax_load_config(CONFIG).model_kwargs.to_dict())
    hps = load_config(CONFIG)
    tm = build_codec_model(hps.model, hps.model_kwargs.to_dict(),
                           device="cpu")
    return jm, tm, jm.init(jax.random.PRNGKey(0))[0]


def test_full_width_config_names_shapes_and_caches(full):
    jm, tm, jt = full
    theirs = {k: np.shape(v) for k, v in _flatten(jt).items()}
    ours = {k: tuple(v.shape)
            for k, v in P.to_flat(tm.param_template(False)).items()}
    assert ours == theirs
    assert sum(int(np.prod(s)) for s in ours.values()) == 14_851_810
    assert tm.hop_length == 320
    assert (tm.vq.num_quantizers, tm.vq.codebook_size, tm.vq.dim) == (
        32, 1024, 128)
    for ours_c, theirs_c, count, size in zip(
            tm.init_cache(1), jm.init_cache(1), (12, 12), (9094, 4928)):
        assert [tuple(c.shape) for c in ours_c] == \
            [tuple(c.shape) for c in theirs_c]
        assert len(ours_c) == count
        assert sum(c.numel() for c in ours_c) == size


def test_full_width_streamed_frames_match_jax(full, rng):
    """Three frames of encode_decode_stream at full width, from JAX's
    seeded params and N(0, 1) codebooks."""
    jm, tm, jt = full
    flat = seeded_flat(jt)
    jp = jm.fold_params(jax_tree(jt, flat))
    tp = tm.fold_params(P.from_flat(flat, tm.param_template(False)))
    books = rng.standard_normal((32, 1024, 128)).astype(np.float32)
    wav = (rng.standard_normal((1, 1, 3 * 320)) * 0.3).astype(np.float32)
    r = jm.encode_decode_stream(jp, {"embed": jnp.asarray(books)},
                                jnp.asarray(wav), *jm.init_cache(1))
    with torch.no_grad():
        s = tm.encode_decode_stream(tp, {"embed": t(books)}, t(wav),
                                    *tm.init_cache(1))
    assert s[0].shape == (32, 1, 3) and s[1].shape == (1, 1, 960)
    np.testing.assert_array_equal(n(s[0]), n(r[0]))
    _close(s[1], r[1])
    for a, b in zip(s[2] + s[3], r[2] + r[3]):
        _close(a, b)
