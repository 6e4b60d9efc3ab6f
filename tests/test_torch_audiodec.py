"""The port's AudioDec family against the JAX package's, on the CPU.

Both sides get the same seeded numpy inputs and the same parameters (the
JAX tree's leaves, through the port's checkpoint bridge) at the tiny shape
of tests/test_audiodec.py (hop 12, code dim 8, decoder 16 channels, so
the grouped convs hold 8 and 4 channels a group). Covered: each block's
`apply` and `step` (residual unit, encoder, MultiGroupConv1d, decoder with
nonzero input stats), stream equal to batch, the deployment fold, the
CodecModel's offline and streaming coding, a 3-slot engine whose slots
are bitwise their solo streams, the full-width registry model (names,
shapes, caches), and the tools on a tiny AudioDec config: export, infer,
`serve --params`, and the refusals JAX makes too (`--ckpt` and the
trainer: deploy-only; eval: no token coding on the bare generator).

Bars: tokens exact or a provable f32 tie
(`assert_token_parity_exact_or_fp_tie` of tests/test_rvq.py); waveforms,
latents and caches <= WAVE_ATOL = 1e-5 absolute.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import audiodec as JA
from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.models.registry import build_codec_model as jax_build
from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ
from hilcodec_tpu.utils.checkpoint import _flatten
from hilcodec_tpu.utils.pytree import leaf_paths

from hilcodec_tpu_torch import bench
from hilcodec_tpu_torch import eval as port_eval
from hilcodec_tpu_torch import export as port_export
from hilcodec_tpu_torch import infer
from hilcodec_tpu_torch.models import audiodec as TA
from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.registry import build_codec_model
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.serve import SlotEngine
from hilcodec_tpu_torch.serve.__main__ import serving_weights
from hilcodec_tpu_torch.utils import params as P
from hilcodec_tpu_torch.utils.checkpoint import load_codec
from hilcodec_tpu_torch.utils.hparams import load_config
from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

from test_rvq import assert_token_parity_exact_or_fp_tie
from test_torch_serve import (SCHEDULE, _assert_pcm, _dq16, _frames, _q16,
                              _run_schedule, _stream_ref)
from torch_port_common import jax_tree, n, seeded_flat, t

WAVE_ATOL = 1e-5
CPU = torch.device("cpu")
TINY = dict(encode_channels=4, enc_ratios=(2, 4), enc_strides=(3, 4),
            code_dim=8, codebook_num=2, codebook_size=16,
            decode_channels=16, dec_strides=(4, 3), resblock_kernel_size=5,
            resblock_dilations=(1, 3))
VQ = dict(dim=8, codebook_size=16, num_quantizers=2, kmeans_init=False)


def _close(a, b, atol=WAVE_ATOL):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=atol)


def _same_params(jax_mod, port_mod, seed=0, stats=False):
    """(jax params, port params) of one module, equal leaf for leaf; with
    stats, the decoder's input mean / scale made nontrivial."""
    template = jax_mod.init(jax.random.PRNGKey(seed))
    flat = seeded_flat(template, seed)
    if stats:
        rng = np.random.default_rng(seed + 7)
        for k in flat:
            if k.endswith("mean") or k.endswith("scale"):
                flat[k] = rng.uniform(0.5, 1.5, flat[k].shape
                                      ).astype(np.float32)
    ref = port_mod.init(torch.Generator().manual_seed(0))
    return jax_tree(template, flat), P.from_flat(flat, ref)


def _books(seed=1):
    return (np.random.default_rng(seed).standard_normal((2, 16, 8)) * 0.5
            ).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    jm = JaxCodecModel(JA.AudioDec(**TINY), JaxResidualVQ(**VQ))
    tm = CodecModel(TA.AudioDec(**TINY), ResidualVQ(**VQ), CPU)
    jp, tp = _same_params(jm.codec, tm.codec, stats=True)
    return jm, tm, jp, tp, _books()


def _blocks():
    j, p = JA.AudioDec(**TINY), TA.AudioDec(**TINY)
    return {
        "unit": (JA.CausalResidualUnit(4, dilation=3),
                 TA.CausalResidualUnit(4, dilation=3), 4, 1),
        "encoder": (j.encoder, p.encoder, 1, 12),
        "mgc": (JA.MultiGroupConv1d(8, 5, (1, 3)),
                TA.MultiGroupConv1d(8, 5, (1, 3)), 8, 1),
        "decoder": (j.decoder, p.decoder, 8, 1 / 12),
    }


@pytest.mark.parametrize("name", ["unit", "encoder", "mgc", "decoder"])
def test_block_apply_and_step_match_jax(name, rng):
    """apply on 8 input steps, then step over them in 4 chunks of 2, each
    output and every cache tensor against JAX's."""
    jmod, tmod, cin, per_step = _blocks()[name]
    jp, tp = _same_params(jmod, tmod, stats=name == "decoder")
    T = 8 if per_step <= 1 else int(8 * per_step)
    x = rng.standard_normal((2, cin, T)).astype(np.float32)
    _close(tmod.apply(tp, t(x)), jax.jit(jmod.apply)(jp, jnp.asarray(x)))
    jc, tc = jmod.init_cache(2), tmod.init_cache(2)
    assert [tuple(c.shape) for c in tc] == [c.shape for c in jc]
    chunk = T // 4
    jstep = jax.jit(jmod.step)
    for i in range(4):
        xi = x[:, :, i * chunk:(i + 1) * chunk]
        jy, jc = jstep(jp, jc, jnp.asarray(xi))
        ty, tc = tmod.step(tp, tc, t(xi))
        _close(ty, jy)
        for a, b in zip(tc, jc):
            _close(a, b)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_stream_equals_batch(tiny, part, rng):
    _, tm, _, tp, _ = tiny
    mod = getattr(tm.codec, part)
    T = 96 if part == "encoder" else 8
    cin = 1 if part == "encoder" else 8
    x = t(rng.standard_normal((1, cin, T)).astype(np.float32) * 0.3)
    full = mod.apply(tp[part], x)
    cache, outs = mod.init_cache(1), []
    for xi in x.chunk(4, dim=-1):
        y, cache = mod.step(tp[part], cache, xi)
        outs.append(y)
    _close(torch.cat(outs, -1), full)


def test_fold_params_matches_jax(tiny):
    jm, tm, jp, tp, _ = tiny
    ours = P.to_flat(tm.fold_params(tp))
    theirs = _flatten(jm.codec.fold_params(jp))
    assert set(ours) == set(theirs)
    assert "decoder/blocks/0/convs1/0/w" in ours
    assert "encoder/conv_pre/w" in ours and "codebooks" in ours
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-6,
                                   err_msg=k)


def test_codec_offline_coding_matches_jax(tiny, rng):
    jm, tm, jp, tp, books = tiny
    jp, tp = jm.codec.fold_params(jp), tm.fold_params(tp)
    wav = (rng.standard_normal((2, 1, 12 * 10)) * 0.3).astype(np.float32)
    jv, tv = {"embed": jnp.asarray(books)}, {"embed": t(books)}
    tok = tm.encode(tp, tv, t(wav))
    latents = n(tm.codec.encoder.apply(tp["encoder"], t(wav))
                ).transpose(0, 2, 1)
    assert tuple(tok.shape) == (2, 2, 10)
    assert_token_parity_exact_or_fp_tie(n(tok), latents, books, 2)
    _close(tm.decode(tp, tv, tok), jm.decode(jp, jv, jnp.asarray(n(tok))))


@pytest.mark.parametrize("f", [1, 2])
def test_codec_streaming_matches_jax(tiny, f, rng):
    """encode_stream / decode_stream at f frames a step: tokens against
    the cascade on the port's streamed latents, PCM against JAX's
    decode_stream of the same tokens, and JAX's own tokens."""
    jm, tm, jp, tp, books = tiny
    jp, tp = jm.codec.fold_params(jp), tm.fold_params(tp)
    wav = (rng.standard_normal((2, 1, 12 * 8)) * 0.3).astype(np.float32)
    jv, tv = {"embed": jnp.asarray(books)}, {"embed": t(books)}
    tok, _ = tm.encode_stream(tp, tv, t(wav), tm.init_cache(2)[0],
                              frames_per_step=f)
    jtok, _ = jm.encode_stream(jp, jv, jnp.asarray(wav), jm.init_cache(2)[0],
                               frames_per_step=f)
    latents = n(tm.codec.encoder.apply(tp["encoder"], t(wav))
                ).transpose(0, 2, 1)
    assert_token_parity_exact_or_fp_tie(n(tok), latents, books, 2)
    assert (n(tok) == np.asarray(jtok)).mean() > 0.99
    out, _ = tm.decode_stream(tp, tv, tok, tm.init_cache(2)[1],
                              frames_per_step=f)
    jout, _ = jm.decode_stream(jp, jv, jnp.asarray(n(tok)),
                               jm.init_cache(2)[1], frames_per_step=f)
    assert tuple(out.shape) == (2, 1, 96)
    _close(out, jout)


def test_cache_axes_are_the_leading_axis(tiny):
    _, tm, _, _, _ = tiny
    enc, dec = tm.cache_axes()
    assert set(enc) == set(dec) == {0}
    assert len(enc) == 1 + 2 * 4 + 1 and len(dec) == 1 + 2 * (1 + 4) + 1


def test_engine_slots_equal_solo_streams(tiny, rng):
    """Three streams attach at different ticks, share and skip ticks: each
    one's tokens and int16 PCM equal its solo port stream bitwise, and its
    solo JAX encode_decode_stream (tokens, the float output within
    WAVE_ATOL)."""
    jm, tm, jp, tp, books = tiny
    vq_state = {"embed": t(books)}
    hop = tm.hop_length
    eng = SlotEngine(tm, tp, vq_state, slots=3, mode="roundtrip",
                     devices=["cpu"])
    wavs = {k: _dq16(_q16(rng.standard_normal(hop * 6) * 0.3))
            for k in "abc"}
    got = _run_schedule(eng, {k: _frames(w, hop) for k, w in wavs.items()},
                        SCHEDULE)
    jpf, jv = jm.codec.fold_params(jp), {"embed": jnp.asarray(books)}
    for k, w in wavs.items():
        ref_tok, ref_pcm = _stream_ref(tm, tp, vq_state, w)
        tok, pcm = got[k]
        np.testing.assert_array_equal(tok, ref_tok)
        _assert_pcm(pcm, ref_pcm)
        jtok, jwav, _, _ = jm.encode_decode_stream(
            jpf, jv, jnp.asarray(w)[None, None], *jm.init_cache(1))
        np.testing.assert_array_equal(tok, np.asarray(jtok)[:, 0])
        np.testing.assert_allclose(ref_pcm, np.asarray(jwav)[0, 0], rtol=0,
                                   atol=WAVE_ATOL)


def test_registry_builds_the_full_width_model():
    """build_codec_model("audiodec", {}) is AudioDec() with RVQ 8 x 1024 x
    64: its leaf names and shapes are JAX's, its caches JAX's shapes."""
    m = build_codec_model("audiodec", {}, device="cpu")
    assert m.hop_length == 300 and m.codec.decoder.channels == 512
    assert (m.vq.num_quantizers, m.vq.codebook_size, m.vq.dim) == (8, 1024,
                                                                   64)
    jm = jax_build("audiodec", {})
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))[0])
    theirs = {k: tuple(v.shape) for k, v in
              zip(leaf_paths(shapes), jax.tree.leaves(shapes))}
    ours = {k: v.shape
            for k, v in P.to_flat(m.param_template(False)).items()}
    assert ours == theirs
    jc = jax.eval_shape(lambda: jm.init_cache(2))
    tc = m.init_cache(2)
    for a, b in zip(tc, jc):
        assert [tuple(c.shape) for c in a] == [c.shape for c in b]


# --------------------------------------------------------------- tools

@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("audiodec_tools")
    cfg = {"model": "audiodec",
           "model_kwargs": {k: list(v) if isinstance(v, tuple) else v
                            for k, v in TINY.items()},
           "data": {"sampling_rate": 24000}}
    cfg["model_kwargs"]["vq_kwargs"] = dict(VQ)
    path = str(tmp / "audiodec.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    rng = np.random.default_rng(0)
    write_wav(str(tmp / "in.wav"), 0.3 * rng.standard_normal(12 * 20),
              24000)
    return tmp, path


def test_export_and_serve_params_roundtrip(tools):
    """export (seeded weights, the quantizer's initial codebooks) ->
    `serve --params` gives the folded seeded weights and codebooks back,
    names as JAX's fold has them."""
    tmp, cfg = tools
    port_export.main(["-c", cfg, "-o", str(tmp / "ad"), "--device", "cpu"])
    with np.load(tmp / "ad_deploy.npz") as z:
        names = set(z.files)
    jm = JaxCodecModel(JA.AudioDec(**TINY), JaxResidualVQ(**VQ))
    jp = jm.codec.fold_params(jm.init(jax.random.PRNGKey(0))[0])
    assert names == set(_flatten(jp))
    hps = load_config(cfg)
    model, params, vq = serving_weights(hps, str(tmp / "ad_deploy.npz"),
                                        device="cpu")
    m0, p0, v0 = load_codec(hps, None, "cpu", random_books=False)
    p0 = m0.fold_params(p0)
    assert isinstance(model.codec, TA.AudioDec)
    for k, v in P.to_flat(p0).items():
        if k != "codebooks":
            np.testing.assert_array_equal(P.to_flat(params)[k], v,
                                          err_msg=k)
    np.testing.assert_array_equal(n(vq["embed"]), n(v0["embed"]))


def test_infer_matches_jax_drivers(tools, capsys):
    """`infer -f 2` on the port's seeded weights: the tokens and wav equal
    JAX's encode_stream / decode_stream on the same (bridged) weights."""
    tmp, cfg = tools
    infer.main(["-c", cfg, "-i", str(tmp / "in.wav"), "-o",
                str(tmp / "port"), "-f", "2", "--device", "cpu"])
    assert "encoder RTF:" in capsys.readouterr().out
    tok = np.load(tmp / "port_quantized.npy")
    assert tok.dtype == np.int16 and tok.shape == (2, 1, 20)
    hps = load_config(cfg)
    model = build_codec_model("audiodec", hps.model_kwargs.to_dict(), "cpu")
    params, vq = model.seeded()
    jm = JaxCodecModel(JA.AudioDec(**TINY), JaxResidualVQ(**VQ))
    template = jm.init(jax.random.PRNGKey(0))[0]
    jp = jm.codec.fold_params(jax_tree(template, P.to_flat(params)))
    jv = {"embed": jnp.asarray(n(vq["embed"]))}
    wav, _ = read_wav(str(tmp / "in.wav"))
    jtok, _ = jm.encode_stream(jp, jv, jnp.asarray(wav)[None, None],
                               jm.init_cache(1)[0], frames_per_step=2)
    np.testing.assert_array_equal(tok, np.asarray(jtok))
    jout, _ = jm.decode_stream(jp, jv, jtok, jm.init_cache(1)[1],
                               frames_per_step=2)
    out, _ = read_wav(str(tmp / "port_output.wav"))
    np.testing.assert_allclose(out, np.asarray(jout)[0, 0], rtol=0,
                               atol=1.01 / 32768)


def test_deploy_only_refusals(tools):
    """As in JAX: a train checkpoint needs the trainer, which refuses
    AudioDec (deploy-only); eval has no token coding on the bare
    generator JAX's eval takes, and says so."""
    tmp, cfg = tools
    for argv in (["-c", cfg, "-i", str(tmp / "in.wav"), "--ckpt", "x.npz",
                  "--device", "cpu"],):
        with pytest.raises(ValueError, match="deploy-only"):
            infer.main(argv)
    with pytest.raises(ValueError, match="deploy-only"):
        serving_weights(load_config(cfg), ckpt_path="x.npz", device="cpu")
    with pytest.raises(SystemExit, match="audiodec"):
        port_eval.main(["-i", str(tmp / "in.wav"), "-c", cfg, "--device",
                        "cpu"])


def test_bench_audiodec_point(capsys):
    """--model audiodec is bench.py's AudioDec point (AudioDec() with RVQ
    8 x 1024 x 64); the frame kernels are refused for it."""
    assert bench.parse_args(["4", "--model", "audiodec"]).model == "audiodec"
    with pytest.raises(SystemExit, match="HILCodec only"):
        bench.parse_args(["4", "--model", "audiodec", "--megakernel"])
    model = bench.build_audiodec_bench_model(CPU)
    assert isinstance(model.codec, TA.AudioDec)
    assert model.hop_length == 300 and model.codec.decoder.channels == 512
    assert (model.vq.num_quantizers, model.vq.codebook_size,
            model.vq.dim) == (8, 1024, 64)
