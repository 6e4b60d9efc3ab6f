"""The port's deployment precisions against the JAX package on the CPU:
`cast_streaming_params`, streaming at `bf16w` (bf16 conv kernels, f32
activations) and at `bf16` (everything bf16, the latents f32 into the
quantizer), the bf16 `SlotEngine` against its solo streams, and the
bench's `--dtype`.

Bars:
  * bf16w: the port's streamed waveform within 1e-5 of JAX's (both f32
    arithmetic on the same bf16-rounded weights), tokens exact or f32 ties
    of JAX's latents;
  * bf16: two bf16 paths that round at different points cannot be held
    at an f32 bar, so each side is held to its own f32 result: the port's
    bf16 distance from its f32 waveform (and latents) at most
    BF16_RATIO x JAX's on the same inputs and weights, and the port's bf16
    tokens equal to JAX's bf16 tokens at a share of at least
    BF16_TOKEN_SHARE (readings beside the constants);
  * the bf16 engine: each slot's tokens and int16 PCM equal the same
    stream's solo `encode_decode_stream` in bf16, bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models.codec import \
    cast_streaming_params as jax_cast_streaming_params
from hilcodec_tpu.utils.checkpoint import _flatten

from hilcodec_tpu_torch import bench
from hilcodec_tpu_torch.models.codec import cast_streaming_params
from hilcodec_tpu_torch.serve import SlotEngine
from hilcodec_tpu_torch.utils import params as P

from test_rvq import assert_token_parity_exact_or_fp_tie
from torch_port_common import both_params, codebooks, models, n, t

B, FRAMES = 3, 6
# the port's bf16-vs-f32 distance over JAX's, waveform and latents (read
# on this config: 1.00 for both; two paths that both round after every op)
BF16_RATIO = 2.0
# share of the port's bf16 tokens equal to JAX's bf16 tokens (read: 1.0 on
# the 54 tokens here)
BF16_TOKEN_SHARE = 0.9


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this module: the test runs share the host's
    cores between several worker processes."""
    k = torch.get_num_threads()
    torch.set_num_threads(min(k, 2))
    yield
    torch.set_num_threads(k)


@pytest.fixture(scope="module")
def setup():
    jm, tm = models()
    pj, pt = both_params(jm, tm)
    books = codebooks()
    wav = (np.random.default_rng(5).standard_normal(
        (B, 1, FRAMES * tm.hop_length)) * 0.3).astype(np.float32)
    return jm, tm, jm.fold_params(pj), tm.fold_params(pt), books, wav


@pytest.mark.parametrize("kernels_only", [True, False])
def test_cast_streaming_params_matches_jax(setup, kernels_only):
    """Leaf by leaf the same dtypes and the same values (bf16 rounding is
    round to nearest even on both sides), from the same folded values."""
    _, tm, fj, _, _, _ = setup
    ft = P.from_flat(_flatten(fj), tm.param_template(True))
    cj = jax_cast_streaming_params(fj, jnp.bfloat16, kernels_only)
    ct = cast_streaming_params(ft, torch.bfloat16, kernels_only)
    flat_t = P.flatten(ct)
    assert len(flat_t) == len(jax.tree.leaves(cj))
    for a, b in zip(jax.tree.leaves(cj), flat_t.values()):
        want = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
        assert b.dtype == want and a.ndim == b.ndim
        np.testing.assert_array_equal(n(b.float()),
                                      np.asarray(a, np.float32))
    assert any(v.dtype == torch.float32 for v in flat_t.values()) \
        == kernels_only


def _port_stream(tm, params, books, wav, dtype):
    """The port's streamed (tokens, waveform, latents) in `dtype`."""
    ce, cd = tm.init_cache(B, dtype)
    vt = {"embed": t(books)}
    x = t(wav).to(dtype)
    tok, _ = tm.encode_stream(params, vt, x, ce)
    y, _ = tm.decode_stream(params, vt, tok, cd)
    z = tm.codec.encoder.apply(params["encoder"], x)
    return tok, y, z


def _jax_stream(jm, params, books, wav, dtype):
    """JAX's streamed (tokens, waveform) in `dtype`, and its latents."""
    ce, cd = jm.init_cache(B, dtype)
    vj = {"embed": jnp.asarray(books)}
    x = jnp.asarray(wav).astype(dtype)
    tok, _ = jax.jit(jm.encode_stream)(params, vj, x, ce)
    y, _ = jax.jit(jm.decode_stream)(params, vj, tok, cd)
    z = jax.jit(jm.codec.encoder.apply)(params["encoder"], x)
    return tok, y, z


def test_bf16w_streams_match_jax(setup):
    """bf16 conv kernels, f32 activations and caches: each conv widens its
    weight to the input's dtype on both sides, so the arithmetic is f32."""
    jm, tm, fj, ft, books, wav = setup
    cj = jax_cast_streaming_params(fj, jnp.bfloat16, True)
    ct = cast_streaming_params(ft, torch.bfloat16, True)
    tok_t, y_t, _ = _port_stream(tm, ct, books, wav, torch.float32)
    tok_j, y_j, z_j = _jax_stream(jm, cj, books, wav, jnp.float32)
    assert y_t.dtype == torch.float32
    assert_token_parity_exact_or_fp_tie(
        n(tok_t), np.asarray(z_j).swapaxes(1, 2), books, books.shape[0])
    # JAX decodes its own tokens: equal to the port's (no tie here)
    np.testing.assert_array_equal(n(tok_t), np.asarray(tok_j))
    scale = float(np.abs(np.asarray(y_j)).max())
    assert float(np.abs(n(y_t) - np.asarray(y_j)).max()) <= 1e-5 * scale


def test_bf16_streams_within_jax_bf16_error(setup):
    """Everything bf16: the waveform and the caches come back bf16, the
    latents reach the quantizer in f32, and the port strays from its own
    f32 result no further than BF16_RATIO x JAX's bf16 from JAX's f32."""
    jm, tm, fj, ft, books, wav = setup
    cj = jax_cast_streaming_params(fj, jnp.bfloat16, False)
    ct = cast_streaming_params(ft, torch.bfloat16, False)
    tok_t, y_t, z_t = _port_stream(tm, ct, books, wav, torch.bfloat16)
    tok_t32, y_t32, z_t32 = _port_stream(tm, ft, books, wav, torch.float32)
    tok_j, y_j, z_j = _jax_stream(jm, cj, books, wav, jnp.bfloat16)
    _, y_j32, z_j32 = _jax_stream(jm, fj, books, wav, jnp.float32)
    assert y_t.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16

    def dist(a, b):
        return float(np.abs(np.asarray(a, np.float32)
                            - np.asarray(b, np.float32)).max())

    for what, port, ref in (
            ("waveform", dist(n(y_t.float()), n(y_t32)),
             dist(np.asarray(y_j, np.float32), y_j32)),
            ("latents", dist(n(z_t.float()), n(z_t32)),
             dist(np.asarray(z_j, np.float32), z_j32))):
        assert 0.0 < ref and port <= BF16_RATIO * ref, (what, port, ref)
    share = float((n(tok_t) == np.asarray(tok_j)).mean())
    assert share >= BF16_TOKEN_SHARE, share


def test_bf16_engine_matches_solo_streams(setup):
    """SlotEngine(dtype=bfloat16): bf16 caches, params and PCM; each
    slot's tokens and int16 PCM equal its stream's solo bf16
    `encode_decode_stream` (folded params cast the same way)."""
    _, tm, _, ft, books, wav = setup
    vq = {"embed": t(books)}
    eng = SlotEngine(tm, ft, vq, slots=4, fold=False, dtype=torch.bfloat16,
                     devices=["cpu"])
    assert all(c.dtype == torch.bfloat16
               for c in eng._cache_enc + eng._cache_dec)
    hop = tm.hop_length
    pcm16 = np.clip(np.round(wav[:, 0] * 32768.0), -32768, 32767
                    ).astype(np.int16)
    slots = [eng.attach() for _ in range(B)]
    toks, outs = [], []
    for f in range(FRAMES):
        for s, x in zip(slots, pcm16):
            eng.submit(s, x[f * hop:(f + 1) * hop])
        res = eng.tick()
        toks.append(np.stack([res[s]["tokens"] for s in slots]))
        outs.append(np.stack([res[s]["pcm"] for s in slots]))
    ct = cast_streaming_params(ft, torch.bfloat16, kernels_only=False)
    x = (t(pcm16.astype(np.float32)) / 32768.0)[:, None].to(torch.bfloat16)
    for i in range(B):
        ce, cd = tm.init_cache(1, torch.bfloat16)
        tok, y, _, _ = tm.encode_decode_stream(ct, vq, x[i:i + 1], ce, cd)
        np.testing.assert_array_equal(
            np.stack([tk[i] for tk in toks], -1), n(tok)[:, 0])
        ref = torch.clamp(torch.round(y * 32768.0), -32768, 32767).to(
            torch.int16)
        np.testing.assert_array_equal(np.concatenate([o[i] for o in outs]),
                                      n(ref)[0, 0])


@pytest.mark.parametrize("dtype", ["bf16w", "bf16"])
def test_bench_dtype_runs_and_names_its_metric(monkeypatch, dtype):
    """--dtype casts the bench's params (and with bf16 its audio and
    caches) and takes bench.py's metric suffix, with --megakernel too."""
    from test_torch_bench import _tiny_model
    monkeypatch.setattr(bench, "build_bench_model", _tiny_model)
    for extra, suffix in (([], ""), (["--megakernel"], "_megakernel")):
        res = bench.run(["2", "--seconds", "0.002", "--device", "cpu",
                         "--dtype", dtype, *extra])
        assert res["metric"] == f"torch_streaming_encdec_rtf_{dtype}{suffix}"
    model = _tiny_model(torch.device("cpu"))
    params, _ = bench.bench_params(model, dtype)
    leaves = P.flatten(params).values()
    assert all((v.dtype == torch.bfloat16) == (dtype == "bf16" or v.ndim >= 3)
               for v in leaves)
