"""Port ops and layers against the JAX package, on the CPU.

Tolerance: 1e-5 absolute on O(1) activations. Both sides compute in f32
but sum the conv / matmul products in other orders (XLA vs ATen), which
moves results by a few ulps; 1e-5 is ~100 ulps at magnitude 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import layers as JL
from hilcodec_tpu.ops import conv as JC
from hilcodec_tpu.ops import reparam as JR
from hilcodec_tpu.ops import stft as JS

from hilcodec_tpu_torch.models import layers as TL
from hilcodec_tpu_torch.ops import conv as TC
from hilcodec_tpu_torch.ops import reparam as TR
from hilcodec_tpu_torch.ops import stft as TS

from torch_port_common import n, t

ATOL = 1e-5

# (k, s, d, groups) — includes the flagship shapes: k=5 depthwise, the
# strided depthwise downsample k=2s, and dilation
CONV_GRID = [(5, 1, 1, 1), (5, 1, 1, 4), (3, 1, 2, 4), (4, 2, 1, 4),
             (10, 5, 1, 4), (16, 8, 1, 4), (1, 1, 1, 1), (7, 3, 2, 2)]
# transposed: flagship upsample k=2r, s=r depthwise, plus d>1 cases
CONVT_GRID = [(4, 2, 1, 4), (10, 5, 1, 4), (16, 8, 1, 4), (8, 4, 1, 1),
              (3, 2, 2, 4), (5, 1, 2, 2), (2, 2, 1, 4)]


def _inputs(rng, cin, cout_g, k, L, transposed=False, groups=1):
    x = rng.standard_normal((2, cin, L)).astype(np.float32)
    shape = (cin, cout_g, k) if transposed else (cout_g, cin // groups, k)
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    b = rng.standard_normal(shape[1] * groups if transposed else shape[0]
                            ).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("k,s,d,g", CONV_GRID)
def test_causal_conv1d_batch_and_step(k, s, d, g, rng):
    C, L = 4, 6 * s
    x, w, b = _inputs(rng, C, C, k, L, groups=g)
    ref = JC.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           s, d, g)
    got = TC.causal_conv1d(t(x), t(w), t(b), s, d, g)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=0)

    cl = TC.causal_conv1d_cache_len(k, s, d)
    assert cl == JC.causal_conv1d_cache_len(k, s, d)
    if cl <= 0:
        return
    cache = rng.standard_normal((2, C, cl)).astype(np.float32)
    yj, cj = JC.causal_conv1d_step(jnp.asarray(x), jnp.asarray(cache),
                                   jnp.asarray(w), jnp.asarray(b), s, d, g)
    yt, ct = TC.causal_conv1d_step(t(x), t(cache), t(w), t(b), s, d, g)
    np.testing.assert_allclose(n(yt), n(yj), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(n(ct), n(cj))


@pytest.mark.parametrize("k,s,d,g", [c for c in CONV_GRID if c[0] > 1])
def test_causal_conv1d_stream_equals_batch(k, s, d, g, rng):
    """Inside the port: concatenated steps == the batched conv."""
    C, L = 4, 8 * s
    x, w, b = _inputs(rng, C, C, k, L, groups=g)
    full = TC.causal_conv1d(t(x), t(w), t(b), s, d, g)
    cl = TC.causal_conv1d_cache_len(k, s, d)
    cache, outs = torch.zeros(2, C, cl), []
    for i in range(0, L, 2 * s):
        y, cache = TC.causal_conv1d_step(t(x[:, :, i:i + 2 * s]), cache,
                                         t(w), t(b), s, d, g)
        outs.append(y)
    np.testing.assert_allclose(n(torch.cat(outs, -1)), n(full), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("k,s,d,g", CONVT_GRID)
def test_causal_conv_transpose1d_batch_and_step(k, s, d, g, rng):
    C, L = 4, 5
    x, w, b = _inputs(rng, C, C // g, k, L, transposed=True, groups=g)
    ref = JC.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), s, d, g)
    got = TC.causal_conv_transpose1d(t(x), t(w), t(b), s, d, g)
    assert got.shape == (2, C, L * s)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=0)

    cl = TC.causal_conv_transpose1d_cache_len(k, s, d)
    assert cl == JC.causal_conv_transpose1d_cache_len(k, s, d)
    cache = rng.standard_normal((2, C, cl)).astype(np.float32)
    yj, cj = JC.causal_conv_transpose1d_step(
        jnp.asarray(x), jnp.asarray(cache), jnp.asarray(w), jnp.asarray(b),
        s, d, g)
    yt, ct = TC.causal_conv_transpose1d_step(t(x), t(cache), t(w), t(b), s,
                                             d, g)
    np.testing.assert_allclose(n(yt), n(yj), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(n(ct), n(cj))


@pytest.mark.parametrize("k,s,d,g", CONVT_GRID)
def test_causal_conv_transpose1d_stream_equals_batch(k, s, d, g, rng):
    C, L = 4, 6
    x, w, b = _inputs(rng, C, C // g, k, L, transposed=True, groups=g)
    full = TC.causal_conv_transpose1d(t(x), t(w), t(b), s, d, g)
    cache = torch.zeros(2, C, TC.causal_conv_transpose1d_cache_len(k, s, d))
    outs = []
    for i in range(L):
        y, cache = TC.causal_conv_transpose1d_step(t(x[:, :, i:i + 1]),
                                                   cache, t(w), t(b), s, d, g)
        outs.append(y)
    np.testing.assert_allclose(n(torch.cat(outs, -1)), n(full), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("n_fft,hop", [(16, 4), (64, 8), (128, 16)])
def test_causal_stft_mag(n_fft, hop, rng):
    """Batch (pad=True) and streaming-suffix (pad=False) magnitudes; the
    basis is the same numpy f32 array on both sides."""
    x = (rng.standard_normal((2, 1, hop * 6)) * 0.3).astype(np.float32)
    ref = JS.causal_stft_mag(jnp.asarray(x), n_fft, hop)
    got = TS.causal_stft_mag(t(x), n_fft, hop)
    assert got.shape == (2, n_fft // 2 + 1, 6)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=0)
    suffix = (rng.standard_normal((2, 1, n_fft - 1 + hop)) * 0.3
              ).astype(np.float32)
    ref = JS.causal_stft_mag(jnp.asarray(suffix), n_fft, hop, pad=False)
    got = TS.causal_stft_mag(t(suffix), n_fft, hop, pad=False)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(TS.causal_stft_basis(n_fft),
                                  JS.causal_stft_basis(n_fft))


def test_weight_norm_compute_and_fold(rng):
    v = rng.standard_normal((6, 3, 5)).astype(np.float32)
    p_j = JR.weight_norm_init(jnp.asarray(v))
    p_t = TR.weight_norm_init(t(v))
    np.testing.assert_allclose(n(p_t["g"]), n(p_j["g"]), rtol=1e-6)
    g = rng.uniform(0.5, 2.0, (6, 1, 1)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    fj = JR.fold({"v": jnp.asarray(v), "g": jnp.asarray(g),
                  "b": jnp.asarray(b)}, JR.WEIGHT_NORM)
    ft = TR.fold({"v": t(v), "g": t(g), "b": t(b)}, TR.WEIGHT_NORM)
    np.testing.assert_allclose(n(ft["w"]), n(fj["w"]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(n(ft["b"]), n(fj["b"]))


@pytest.mark.parametrize("name,params", [
    ("ELU", None), ("ELU", {"alpha": 0.5}), ("ReLU", None),
    ("LeakyReLU", {"negative_slope": 0.2}), ("GELU", None), ("SiLU", None),
    ("Tanh", None), ("Identity", None)])
def test_activation(name, params, rng):
    x = (rng.standard_normal((2, 3, 7)) * 2).astype(np.float32)
    ref = JL.activation(name, params)(jnp.asarray(x))
    got = TL.activation(name, params)(t(x))
    np.testing.assert_allclose(n(got), n(ref), atol=1e-6, rtol=1e-6)


def test_l2norm(rng):
    x = rng.standard_normal((2, 16, 5)).astype(np.float32)
    np.testing.assert_allclose(n(TL.l2norm(t(x), 16)),
                               n(JL.l2norm(jnp.asarray(x), 16)),
                               atol=1e-6, rtol=0)


def _layer_params(jlayer, tlayer_template, seed):
    """Seeded params of one JAX layer, with zero-init scales nonzero, as
    (jax_tree, port_tree)."""
    from torch_port_common import jax_tree, seeded_flat
    from hilcodec_tpu_torch.utils import params as P
    template = jlayer.init(jax.random.PRNGKey(seed))
    flat = seeded_flat(template, seed)
    return jax_tree(template, flat), P.from_flat(flat, tlayer_template)


@pytest.mark.parametrize("folded", [False, True])
def test_resblock_apply_and_step(folded, rng):
    kw = dict(kernel_size=5, dilations=(2, 1), res_scale=0.577, idx=2)
    jb, tb = JL.ResBlock(8, **kw), TL.ResBlock(8, **kw)
    pj, pt = _layer_params(jb, tb.init(torch.Generator()), 0)
    if folded:
        pj, pt = jb.fold(pj), tb.fold(pt)
    x = rng.standard_normal((2, 8, 12)).astype(np.float32)
    np.testing.assert_allclose(n(tb.apply(pt, t(x))),
                               n(jb.apply(pj, jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    cj, ct = jb.init_cache(2), tb.init_cache(2)
    assert [c.shape for c in cj] == [tuple(c.shape) for c in ct]
    for i in range(3):
        xi = x[:, :, 4 * i:4 * i + 4]
        yj, cj = jb.step(pj, cj, jnp.asarray(xi))
        yt, ct = tb.step(pt, ct, t(xi))
        np.testing.assert_allclose(n(yt), n(yj), atol=ATOL, rtol=0)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(n(a), n(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("folded", [False, True])
def test_specblock_apply_and_step(folded, rng):
    kw = dict(mean=-4.0, std=2.8, res_scale=0.577)
    jb, tb = JL.SpecBlock(32, 8, 4, **kw), TL.SpecBlock(32, 8, 4, **kw)
    pj, pt = _layer_params(jb, tb.init(torch.Generator()), 1)
    if folded:
        pj, pt = jb.fold(pj), tb.fold(pt)
    x = rng.standard_normal((2, 8, 6)).astype(np.float32)
    wav = (rng.standard_normal((2, 1, 24)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(
        n(tb.apply(pt, t(x), t(wav))),
        n(jb.apply(pj, jnp.asarray(x), jnp.asarray(wav))), atol=ATOL, rtol=0)
    suffix = (rng.standard_normal((2, 1, 31 + 4)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(
        n(tb.step(pt, t(x[:, :, :1]), t(suffix))),
        n(jb.step(pj, jnp.asarray(x[:, :, :1]), jnp.asarray(suffix))),
        atol=ATOL, rtol=0)
