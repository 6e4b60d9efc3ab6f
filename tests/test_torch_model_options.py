"""The port's model options against the JAX package on the CPU: the
depthwise `shift` lowering, every `jnp.pad` mode of a causal conv, weight
standardization, the learnable STFT, the ResBlock skips (offline,
streaming and folded, on a tiny HILCodec) and the frame kernels on a
standardized model (the train step with these options:
test_torch_options_train.py).

Tolerances: 1e-5 of the reference's largest magnitude for every f32
forward (convolutions through different libraries), 1e-6 for the weight
reparameterizations and the pads (a few f32 operations each); tokens exact
or f32 ties (`assert_token_parity_exact_or_fp_tie`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import layers as JL
from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.models.hilcodec import HILCodec as JaxHILCodec
from hilcodec_tpu.ops import conv as JC
from hilcodec_tpu.ops import reparam as JR
from hilcodec_tpu.ops import rvq as Q_J
from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ
from hilcodec_tpu.utils.checkpoint import _flatten

from hilcodec_tpu_torch.models import layers as TL
from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.ops import conv as TC
from hilcodec_tpu_torch.ops import decoder_kernel as DK
from hilcodec_tpu_torch.ops import encoder_kernel as EK
from hilcodec_tpu_torch.ops import reparam as TR
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.utils import params as P

from test_rvq import assert_token_parity_exact_or_fp_tie
from torch_port_common import CPU, TINY, TINY_VQ, codebooks, jax_tree, n, t

FWD_TOL = 1e-5
OP_TOL = 1e-6
B, FRAMES = 2, 3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this module: the test runs share the host's
    cores between several worker processes."""
    k = torch.get_num_threads()
    torch.set_num_threads(min(k, 2))
    yield
    torch.set_num_threads(k)


def close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err)


@pytest.fixture
def jax_shift():
    """The JAX package's shift lowering for one test; the port has one
    lowering, the convolution."""
    JC.set_depthwise_lowering("shift")
    yield
    JC.set_depthwise_lowering("conv")


# ------------------------------------------------------------- lowering

@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2),
                                             (2, 2)])
def test_shift_depthwise_matches_jax_and_conv(jax_shift, stride, dilation):
    """A depthwise conv (and, at dilation 1, the causal transposed conv and
    its streaming step): the port's convolution against JAX's shift form
    (`train.depthwise_lowering: shift`) and against JAX's conv form."""
    rng = np.random.default_rng(stride * 10 + dilation)
    x = rng.standard_normal((2, 6, 23)).astype(np.float32)
    w = rng.standard_normal((6, 1, 4)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    got = TC.conv1d(t(x), t(w), t(b), stride, dilation, groups=6,
                    padding=(3, 2))
    ref = JC.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                    dilation, groups=6, padding=(3, 2))
    close(n(got), ref, OP_TOL, "conv vs JAX's shift form")
    JC.set_depthwise_lowering("conv")
    conv = JC.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                     dilation, groups=6, padding=(3, 2))
    JC.set_depthwise_lowering("shift")
    close(n(got), conv, OP_TOL, "conv vs JAX's conv form")
    if dilation != 1:
        return
    wt = rng.standard_normal((6, 1, 2 * stride)).astype(np.float32)
    ref = JC.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(wt),
                                     jnp.asarray(b), stride, groups=6)
    got = TC.causal_conv_transpose1d(t(x), t(wt), t(b), stride, groups=6)
    close(n(got), ref, OP_TOL, "convT vs JAX's shift form")
    cache = rng.standard_normal((2, 6, (2 * stride - 1) // stride)
                                ).astype(np.float32)
    ry, rc = JC.causal_conv_transpose1d_step(
        jnp.asarray(x[..., :3]), jnp.asarray(cache), jnp.asarray(wt),
        jnp.asarray(b), stride, groups=6)
    gy, gc = TC.causal_conv_transpose1d_step(t(x[..., :3]), t(cache), t(wt),
                                             t(b), stride, groups=6)
    close(n(gy), ry, OP_TOL, "convT step vs JAX's shift form")
    np.testing.assert_array_equal(n(gc), np.asarray(rc))


def test_depthwise_lowering_switch():
    """The port takes exactly the lowering names that JAX's switch takes;
    an unknown one raises on the JAX side and is not among the port's."""
    try:
        for mode in TC.DEPTHWISE_LOWERINGS:
            JC.set_depthwise_lowering(mode)
    finally:
        JC.set_depthwise_lowering("conv")
    with pytest.raises(ValueError, match="depthwise lowering"):
        JC.set_depthwise_lowering("im2col")
    assert "im2col" not in TC.DEPTHWISE_LOWERINGS
    assert set(TC.DEPTHWISE_LOWERINGS) == {"conv", "shift"}


# ------------------------------------------------------------------ pads

@pytest.mark.parametrize("mode", TC.PAD_MODES)
def test_pad_mode_matches_jnp_pad(mode):
    """pad1d against jnp.pad, pads shorter and longer than the signal
    (one side at a time too), and the causal conv that pads with it."""
    rng = np.random.default_rng(len(mode))
    for length in (5, 4):
        x = rng.standard_normal((2, 3, length)).astype(np.float32)
        for pads in ((3, 4), (9, 12), (0, 2), (7, 0)):
            ref = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), pads), mode=mode)
            close(n(TC.pad1d(t(x), pads, mode)), ref, OP_TOL,
                  f"{mode} {pads} L={length}")
    x = rng.standard_normal((2, 3, 10)).astype(np.float32)
    w = rng.standard_normal((4, 3, 7)).astype(np.float32)
    ref = JC.causal_conv1d(jnp.asarray(x), jnp.asarray(w), None, 2, 2,
                           pad_mode=mode)
    close(n(TC.causal_conv1d(t(x), t(w), None, 2, 2, pad_mode=mode)), ref,
          FWD_TOL, f"causal conv {mode}")


def test_pad_mode_empty_and_unknown_refused():
    x = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="undefined"):
        TC.pad1d(x, (2, 2), "empty")
    with pytest.raises(ValueError, match="unknown pad_mode"):
        TC.pad1d(x, (2, 2), "circular")


# ------------------------------------------------- weight standardization

@pytest.mark.parametrize("scale", [None, 0.5])
def test_weight_standardization_matches_jax(scale):
    """Init ({v, g[, scale]}), compute (f32 rsqrt(max(var * fan_in, eps)),
    also from bf16 leaves) and fold against JAX; fold_tree tells it from
    weight norm by its `scale` leaf, as JAX's does."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((8, 4, 5)).astype(np.float32)
    jp = JR.weight_standardization_init(jnp.asarray(w), scale=scale)
    tp = TR.weight_standardization_init(t(w), scale=scale)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(n(tp[k]), np.asarray(jp[k]))
    g = rng.uniform(0.5, 1.5, (8, 1, 1)).astype(np.float32)
    jp = dict(jp, g=jnp.asarray(g))
    tp = dict(tp, g=t(g))
    ref = JR.compute_weight(jp, JR.WEIGHT_STANDARDIZATION)
    close(n(TR.compute_weight(tp, TR.WEIGHT_STANDARDIZATION)), ref, OP_TOL,
          "compute")
    jb = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    tb = {k: v.bfloat16() for k, v in tp.items()}
    got = TR.compute_weight(tb, TR.WEIGHT_STANDARDIZATION)
    assert got.dtype == torch.bfloat16
    close(n(got.float()), np.asarray(
        JR.compute_weight(jb, JR.WEIGHT_STANDARDIZATION), np.float32),
        2.0 ** -8, "compute from bf16")
    tree_j = JR.fold_tree({"c": dict(jp, b=jnp.zeros(8))})
    tree_t = TR.fold_tree({"c": dict(tp, b=torch.zeros(8))})
    close(n(tree_t["c"]["w"]), tree_j["c"]["w"], OP_TOL, "fold_tree")
    assert set(tree_t["c"]) == {"w", "b"}
    p = TR.init_reparam(t(w), TR.WEIGHT_STANDARDIZATION, bias=torch.zeros(8))
    assert set(p) == {"v", "g", "b"} and torch.equal(p["g"],
                                                     torch.ones(8, 1, 1))


# ------------------------------------------- model variants (tiny codec)

def variant(**kw):
    """JAX and port CodecModels of the tiny config with options `kw`, and
    their unfolded params from JAX's init with every zero-init scale, skip
    scale and learnable basis made seeded and nonzero."""
    jm = JaxCodecModel(JaxHILCodec(**TINY, **kw), JaxResidualVQ(**TINY_VQ))
    tm = CodecModel(HILCodec(**TINY, **kw), ResidualVQ(**TINY_VQ), CPU)
    template, _ = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    flat = _flatten(template)
    for k, v in flat.items():
        if k.endswith(("scale_param", "skip_scale")):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("basis"):
            flat[k] = (v + 0.05 * rng.standard_normal(v.shape)
                       ).astype(np.float32)
    return jm, tm, jax_tree(template, flat), P.from_flat(
        flat, tm.param_template(False))


def _stream(tm, pt, wav, books):
    """The port's streamed tokens and waveform, frame by frame."""
    ce, cd = tm.init_cache(B)
    vt = {"embed": t(books)}
    tok, _ = tm.encode_stream(pt, vt, t(wav), ce)
    y, _ = tm.decode_stream(pt, vt, tok, cd)
    return tok, y


SKIP_VARIANTS = [dict(skip=s) for s in ("1x1", "scale", "exp_scale",
                                        "channelwise_scale")]
OPTION_VARIANTS = SKIP_VARIANTS + [
    dict(norm="weight_standardization", spec_learnable=True)]


@pytest.mark.parametrize("kw", OPTION_VARIANTS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_variant_offline_streaming_and_folded_match_jax(kw, tmp_path):
    """Each ResBlock skip, and weight standardization with the learnable
    STFT: the param names and shapes of JAX's init (unfolded and folded),
    the folded leaves and the deploy npz both ways (`skip_scale`, the 1x1
    shortcut, `basis`, the standardized `v` / `g`); the offline encoder
    and decoder; and the port's
    streamed tokens and waveform, from unfolded and from folded params,
    against JAX's offline codec (whose streaming equals it by
    construction, tests/test_codec_api.py): tokens exact or f32 ties of
    JAX's latents, the waveform that JAX decodes from the same tokens."""
    jm, tm, pj, pt = variant(**kw)
    assert P.to_flat(pt).keys() == {
        k for k in P.to_flat(tm.param_template(False))}
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((B, 1, FRAMES * tm.hop_length)) * 0.3
           ).astype(np.float32)
    enc, dec = jax.jit(jm.codec.encoder.apply), jax.jit(jm.codec.decoder.apply)
    zj = enc(pj["encoder"], jnp.asarray(wav))
    close(n(tm.codec.encoder.apply(pt["encoder"], t(wav))), zj, FWD_TOL,
          "encoder")
    q = (rng.standard_normal((B, 16, FRAMES)) * 0.5).astype(np.float32)
    close(n(tm.codec.decoder.apply(pt["decoder"], t(q))),
          dec(pj["decoder"], jnp.asarray(q)), FWD_TOL, "decoder")
    books = codebooks()
    fj, ft = jm.fold_params(pj), tm.fold_params(pt)
    assert set(P.to_flat(ft)) == set(P.to_flat(tm.param_template(True)))
    for a, b in zip(jax.tree.leaves(fj), P.flatten(ft).values()):
        np.testing.assert_allclose(n(b), np.asarray(a), rtol=FWD_TOL,
                                   atol=OP_TOL)
    # the deploy npz both ways: JAX's folded tree into the port, the
    # port's into JAX's tree, by leaf path
    path = str(tmp_path / "deploy.npz")
    np.savez(path, codebooks=books, **_flatten(fj))
    loaded, _ = P.load_deploy_npz(path, tm)
    for a, b in zip(jax.tree.leaves(fj), P.flatten(loaded).values()):
        np.testing.assert_array_equal(n(b), np.asarray(a))
    back = jax_tree(fj, P.to_flat(ft))
    assert jax.tree.structure(back) == jax.tree.structure(fj)
    for ptx, what in ((pt, "unfolded"), (ft, "folded")):
        tok, y = _stream(tm, ptx, wav, books)
        assert_token_parity_exact_or_fp_tie(
            n(tok), np.asarray(zj).swapaxes(1, 2), books, books.shape[0])
        qj = Q_J.dequantize(jnp.asarray(n(tok)), jnp.asarray(books))
        close(n(y), dec(pj["decoder"], qj.swapaxes(1, 2)), FWD_TOL,
              f"streamed wav {what}")


def test_learnable_spec_block_matches_jax():
    """The SpecBlock with a learnable basis alone: offline on a padded
    wav, streaming on the wav suffix, and its fold (which keeps `basis`)."""
    rng = np.random.default_rng(2)
    jb = JL.SpecBlock(32, 8, 4, learnable=True)
    tb = TL.SpecBlock(32, 8, 4, learnable=True)
    pj = jb.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in zip(
        ["layer/v", "layer/g", "scale_param", "basis"],
        [pj["layer"]["v"], pj["layer"]["g"], pj["scale_param"],
         pj["basis"]])}
    flat["scale_param"] = np.array([0.7], np.float32)
    flat["basis"] = flat["basis"] + 0.05 * rng.standard_normal(
        flat["basis"].shape).astype(np.float32)
    pj = {"layer": {"v": jnp.asarray(flat["layer/v"]),
                    "g": jnp.asarray(flat["layer/g"])},
          "scale_param": jnp.asarray(flat["scale_param"]),
          "basis": jnp.asarray(flat["basis"])}
    pt = P.from_flat(flat, tb.init(torch.Generator().manual_seed(0)))
    x = rng.standard_normal((2, 8, 6)).astype(np.float32)
    wav = rng.standard_normal((2, 1, 24)).astype(np.float32)
    close(n(tb.apply(pt, t(x), t(wav))),
          jb.apply(pj, jnp.asarray(x), jnp.asarray(wav)), FWD_TOL, "apply")
    sfx = rng.standard_normal((2, 1, 31 + 24)).astype(np.float32)
    close(n(tb.step(pt, t(x), t(sfx))),
          jb.step(pj, jnp.asarray(x), jnp.asarray(sfx)), FWD_TOL, "step")
    fj, ft = jb.fold(pj), tb.fold(pt)
    assert set(ft) == {"layer", "basis"} and torch.equal(ft["basis"],
                                                         pt["basis"])
    close(n(tb.step(ft, t(x), t(sfx))),
          jb.step(fj, jnp.asarray(x), jnp.asarray(sfx)), FWD_TOL, "folded")


# -------------------------------------------------------- frame kernels

def test_frame_kernels_refuse_what_jax_refuses():
    """Non-identity skips and a learnable STFT raise a ValueError in the
    frame kernels' lowering, as JAX's asserts do; nothing falls back to the
    plain step."""
    for kw in SKIP_VARIANTS:
        codec = HILCodec(**TINY, **kw)
        with pytest.raises(ValueError, match="identity skips"):
            DK.DecoderMegakernel(codec.decoder)
        with pytest.raises(ValueError, match="identity skips"):
            EK.EncoderMegakernel(codec.encoder)
    codec = HILCodec(**TINY, spec_learnable=True)
    with pytest.raises(ValueError, match="fixed STFT basis"):
        EK.EncoderMegakernel(codec.encoder)
    tm = CodecModel(codec, ResidualVQ(**TINY_VQ), CPU)
    params = tm.fold_params(tm.codec.init(torch.Generator().manual_seed(0)))
    ce, _ = tm.init_cache(1)
    with pytest.raises(ValueError, match="fixed STFT basis"):
        tm.encode_stream(params, {"embed": t(codebooks())},
                         torch.zeros(1, 1, tm.hop_length), ce,
                         megakernel=True)


def test_standardized_model_runs_the_frame_kernels():
    """A weight-standardized model folds to plain weights: its frame-kernel
    streams (the kernels' plain version on the CPU) equal its plain
    streams, and JAX's standardized plain streams."""
    jm, tm, pj, pt = variant(norm="weight_standardization")
    fj, ft = jm.fold_params(pj), tm.fold_params(pt)
    books = codebooks()
    wav = (np.random.default_rng(4).standard_normal(
        (B, 1, FRAMES * tm.hop_length)) * 0.3).astype(np.float32)
    vt = {"embed": t(books)}
    ce, cd = tm.init_cache(B)
    tok_k, _ = tm.encode_stream(ft, vt, t(wav), ce, megakernel=True)
    tok_p, _ = tm.encode_stream(ft, vt, t(wav), ce)
    assert torch.equal(tok_k, tok_p)
    y_k, _ = tm.decode_stream(ft, vt, tok_p, cd, megakernel=True)
    y_p, _ = tm.decode_stream(ft, vt, tok_p, cd)
    close(n(y_k), n(y_p), FWD_TOL, "kernel vs plain")
    zj = jax.jit(jm.codec.encoder.apply)(pj["encoder"], jnp.asarray(wav))
    assert_token_parity_exact_or_fp_tie(
        n(tok_p), np.asarray(zj).swapaxes(1, 2), books, books.shape[0])
