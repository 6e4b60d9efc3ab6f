"""Port HILCodec encoder / decoder / CodecModel against the JAX package at
a tiny config, on the CPU: batch `apply`, streaming `step` with every cache
tensor, the whole encode -> RVQ -> decode stream, and the param bridge.

Tolerances (absolute, f32): 1e-5 for latents (after l2norm, |z| ~ 1) and
waveforms; 2e-5 for cache tensors, which hold pre-activation values up to
~10 in magnitude (the same ~1e-6 relative summation-order gap between XLA
and ATen convolutions, scaled).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hilcodec_tpu.utils.checkpoint import _flatten

from hilcodec_tpu_torch.utils import params as P

from test_rvq import assert_token_parity_exact_or_fp_tie
from torch_port_common import both_params, codebooks, models, n, t

ATOL = 1e-5
CACHE_ATOL = 2e-5
FRAMES = 12


@pytest.fixture(scope="module")
def setup():
    jm, tm = models()
    pj, pt = both_params(jm, tm)
    return jm, tm, pj, pt


def _wav(seed, B=2, frames=FRAMES, hop=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, frames * hop)) * 0.3
            ).astype(np.float32)


def _close_caches(ct, cj):
    assert [tuple(c.shape) for c in ct] == [c.shape for c in cj]
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(n(a), n(b), atol=CACHE_ATOL, rtol=0)


@pytest.mark.parametrize("folded", [False, True])
def test_encoder_apply_and_step(setup, folded):
    jm, tm, pj, pt = setup
    if folded:
        pj, pt = jm.fold_params(pj), tm.fold_params(pt)
    je, te = jm.codec.encoder, tm.codec.encoder
    wav = _wav(0)
    zj = je.apply(pj["encoder"], jnp.asarray(wav))
    zt = te.apply(pt["encoder"], t(wav))
    assert zt.shape == (2, 16, FRAMES)
    np.testing.assert_allclose(n(zt), n(zj), atol=ATOL, rtol=0)

    cj, ct = je.init_cache(2), te.init_cache(2)
    for f in range(FRAMES):
        x = wav[:, :, f * 8:(f + 1) * 8]
        yj, cj = je.step(pj["encoder"], cj, jnp.asarray(x))
        yt, ct = te.step(pt["encoder"], ct, t(x))
        np.testing.assert_allclose(n(yt), n(yj), atol=ATOL, rtol=0)
    _close_caches(ct, cj)


@pytest.mark.parametrize("folded", [False, True])
def test_decoder_apply_and_step(setup, folded):
    jm, tm, pj, pt = setup
    if folded:
        pj, pt = jm.fold_params(pj), tm.fold_params(pt)
    jd, td = jm.codec.decoder, tm.codec.decoder
    z = np.random.default_rng(3).standard_normal((2, 16, FRAMES)
                                                 ).astype(np.float32)
    yj = jd.apply(pj["decoder"], jnp.asarray(z))
    yt = td.apply(pt["decoder"], t(z))
    assert yt.shape == (2, 1, FRAMES * 8)
    np.testing.assert_allclose(n(yt), n(yj), atol=ATOL, rtol=0)

    cj, ct = jd.init_cache(2), td.init_cache(2)
    for f in range(FRAMES):
        yj, cj = jd.step(pj["decoder"], cj, jnp.asarray(z[:, :, f:f + 1]))
        yt, ct = td.step(pt["decoder"], ct, t(z[:, :, f:f + 1]))
        np.testing.assert_allclose(n(yt), n(yj), atol=ATOL, rtol=0)
    _close_caches(ct, cj)


def test_fold_params_match(setup):
    jm, tm, pj, pt = setup
    fj, ft = _flatten(jm.fold_params(pj)), P.to_flat(tm.fold_params(pt))
    assert list(fj) == list(ft)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], atol=1e-6, rtol=1e-6)


def test_encode_decode_stream_matches_jax(setup):
    """The slice as a whole on folded params: tokens by the tie analyzer on
    the JAX latents, waveform where tokens agree, final caches."""
    jm, tm, pj, pt = setup
    fj, ft = jm.fold_params(pj), tm.fold_params(pt)
    books = codebooks()
    wav = _wav(1)
    cej, cdj = jm.init_cache(2)
    cet, cdt = tm.init_cache(2)
    tj, wj, cej, cdj = jm.encode_decode_stream(
        fj, {"embed": jnp.asarray(books)}, jnp.asarray(wav), cej, cdj)
    tt, wt, cet, cdt = tm.encode_decode_stream(
        ft, {"embed": t(books)}, t(wav), cet, cdt)
    assert tt.shape == (3, 2, FRAMES) and wt.shape == wav.shape
    z = n(jm.codec.encoder.apply(fj["encoder"], jnp.asarray(wav)))
    assert_token_parity_exact_or_fp_tie(n(tt), z.transpose(0, 2, 1), books,
                                        3)
    agree = (n(tt) == n(tj)).all(axis=(0, 1))
    assert agree.all(), "a token tie moved the decoder input"
    np.testing.assert_allclose(n(wt), n(wj), atol=ATOL, rtol=0)
    _close_caches(cet, cej)
    _close_caches(cdt, cdj)


def test_port_stream_equals_offline(setup):
    """Inside the port: frame-by-frame encode/decode == whole-utterance
    encode/decode, and the fused stream == encode_stream + decode_stream."""
    _, tm, _, pt = setup
    ft = tm.fold_params(pt)
    vq = {"embed": t(codebooks())}
    wav = t(_wav(2))
    ce, cd = tm.init_cache(2)
    tok_s, _ = tm.encode_stream(ft, vq, wav, ce)
    tok_o = tm.encode(ft, vq, wav)
    assert torch.equal(tok_s, tok_o)
    out_s, _ = tm.decode_stream(ft, vq, tok_s, cd)
    out_o = tm.decode(ft, vq, tok_s)
    np.testing.assert_allclose(n(out_s), n(out_o), atol=ATOL, rtol=0)
    ce, cd = tm.init_cache(2)
    tok_f, out_f, _, _ = tm.encode_decode_stream(ft, vq, wav, ce, cd, n=2)
    assert torch.equal(tok_f, tok_s[:2])
    out_2, _ = tm.decode_stream(ft, vq, tok_s[:2], tm.init_cache(2)[1])
    assert torch.equal(out_f, out_2)


def test_flagship_cache_layout():
    """Flagship caches: 22 tensors / 32,511 f32 (encoder), 30 / 43,968
    (decoder) per stream, in the JAX order and shapes."""
    from hilcodec_tpu.models.hilcodec import HILCodec as JaxHILCodec
    from hilcodec_tpu_torch.models.hilcodec import HILCodec
    jc, tc = JaxHILCodec(), HILCodec()
    (je, jd), (te, td) = jc.init_cache(1), tc.init_cache(1)
    assert [c.shape for c in je] == [tuple(c.shape) for c in te]
    assert [c.shape for c in jd] == [tuple(c.shape) for c in td]
    assert (len(te), sum(c.numel() for c in te)) == (22, 32511)
    assert (len(td), sum(c.numel() for c in td)) == (30, 43968)
    assert tc.hop_length == 320 and tc.encoder.wav_cache_len == 1023


@pytest.mark.parametrize("folded", [False, True])
def test_bridge_loads_jax_params(setup, folded):
    """JAX params flattened to numpy (as checkpoints hold them) load into
    the port, keep every name, and compute what JAX computes."""
    jm, tm, pj, _ = setup
    tree = jm.fold_params(pj) if folded else pj
    flat = _flatten(tree)
    assert P.is_folded(flat) == folded
    pt = P.from_flat(flat, tm.param_template(folded))
    back = P.to_flat(pt)
    assert list(back) == list(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    wav = _wav(4)
    np.testing.assert_allclose(
        n(tm.codec.encoder.apply(pt["encoder"], t(wav))),
        n(jm.codec.encoder.apply(tree["encoder"], jnp.asarray(wav))),
        atol=ATOL, rtol=0)


def test_bridge_rejects_wrong_names_and_shapes(setup):
    jm, tm, pj, _ = setup
    flat = _flatten(pj)
    k = next(iter(flat))
    bad = dict(flat)
    bad[k] = np.zeros((1,) + flat[k].shape, np.float32)
    with pytest.raises(ValueError, match="shapes"):
        P.from_flat(bad, tm.param_template(False))
    bad = dict(flat)
    bad.pop(k)
    with pytest.raises(ValueError, match="missing"):
        P.from_flat(bad, tm.param_template(False))


def test_bridge_loads_deploy_npz(setup, tmp_path):
    """A `{name}_deploy.npz` written the way export.py writes it (folded
    params by leaf path + `codebooks`) serves the same tokens and wav."""
    jm, tm, pj, _ = setup
    fj = jm.fold_params(pj)
    books = codebooks()
    flat = _flatten(fj)
    flat["codebooks"] = books
    path = tmp_path / "m_deploy.npz"
    with open(path, "wb") as f:
        np.savez_compressed(f, **flat)
    pt, vq = P.load_deploy_npz(str(path), tm)
    assert P.is_folded(P.to_flat(pt))
    wav = _wav(5, B=1)
    tj, wj, _, _ = jm.encode_decode_stream(
        fj, {"embed": jnp.asarray(books)}, jnp.asarray(wav),
        *jm.init_cache(1))
    tt, wt, _, _ = tm.encode_decode_stream(pt, vq, t(wav), *tm.init_cache(1))
    np.testing.assert_array_equal(n(tt), n(tj))
    np.testing.assert_allclose(n(wt), n(wj), atol=ATOL, rtol=0)
