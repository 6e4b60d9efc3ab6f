"""Mimi in the port (`models/mimi.py`, `models/transformer.py`) against its
plain reference (`reference/mimi_ref.py`, torch and math only), on the
CPU at tiny widths: the streaming encode / decode over more positions
than the transformers' context, so that the rings wrap; the split RVQ's
tokens and sum; the registry's lazy build from the shipped config; the
caches' batch axes."""

import os
import subprocess
import sys

import pytest
import torch

from hilcodec_tpu_torch.models.registry import build_codec_model
from hilcodec_tpu_torch.models.transformer import StreamingTransformer
from hilcodec_tpu_torch.reference import mimi_ref
from hilcodec_tpu_torch.utils.hparams import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "mimi_24k.yaml")

TINY = dict(channels=1, n_filters=4, ratios=[4, 2], dimension=16,
            n_residual_layers=1, kernel_size=7, last_kernel_size=3,
            residual_kernel_size=3, dilation_base=2, compress=2,
            true_skip=True, activation="ELU", norm="none",
            pad_mode="constant", resample_stride=2,
            transformer=dict(d_model=16, num_heads=2, num_layers=2,
                             dim_feedforward=32, context=5,
                             max_period=10000.0, layer_scale=0.01,
                             norm_eps=1e-5),
            vq="SplitResidualVQ",
            vq_kwargs=dict(input_dim=16, dim=8, codebook_size=32,
                           num_quantizers=4, n_semantic=1))


@pytest.fixture(scope="module")
def tiny():
    """The tiny model, its seeded weights (LayerScale gains near 1, so
    the transformer branches count) and 12 frames of 3 streams."""
    torch.set_num_threads(2)
    m = build_codec_model("mimi", TINY, device="cpu")
    gen = torch.Generator().manual_seed(1)
    params, state = m.init(gen)
    for side in ("encoder", "decoder"):
        for lp in params[side]["transformer"]["layers"]:
            lp["scale1"] = 0.5 + torch.rand(16, generator=gen)
            lp["scale2"] = 0.5 + torch.rand(16, generator=gen)
    wav = torch.randn(3, 1, 12 * m.hop_length, generator=gen) * 0.3
    return m, params, state, wav


def test_streaming_matches_the_reference_past_the_wrap(tiny):
    m, params, state, wav = tiny
    ctx = TINY["transformer"]["context"]
    # 12 frame steps of 2 positions each: 24 positions, past a context of 5
    assert 2 * wav.shape[-1] // m.hop_length > 4 * ctx
    z_ref = mimi_ref.encode_latent(params, TINY, wav)
    ce, cd = m.init_cache(3)
    zs = []
    for i in range(12):
        z, ce = m.codec.encoder.step(
            params["encoder"], ce,
            wav[..., i * m.hop_length:(i + 1) * m.hop_length])
        zs.append(z)
    assert torch.allclose(torch.cat(zs, -1), z_ref, atol=1e-5, rtol=0)
    assert torch.allclose(m.codec.encoder.apply(params["encoder"], wav),
                          z_ref, atol=1e-5, rtol=0)
    toks, _ = m.encode_stream(params, state, wav, m.init_cache(3)[0],
                              frames_per_step=2)
    assert torch.equal(toks.long(), mimi_ref.quantize(state, z_ref))
    out, _ = m.decode_stream(params, state, toks, cd, frames_per_step=3)
    ref = mimi_ref.decode(params, state, TINY, toks)
    assert out.shape == wav.shape
    assert float((out - ref).abs().max()) < 1e-5


def test_a_step_of_two_positions_is_two_of_one():
    t = StreamingTransformer(d_model=8, num_heads=2, num_layers=2,
                             dim_feedforward=16, context=3)
    gen = torch.Generator().manual_seed(0)
    p = t.init(gen)
    x = torch.randn(2, 8, 10, generator=gen)
    c2 = t.init_cache(2)
    c1 = t.init_cache(2)
    y2, y1 = [], []
    for i in range(0, 10, 2):
        y, c2 = t.step(p, c2, x[..., i:i + 2])
        y2.append(y)
        for j in (i, i + 1):
            y, c1 = t.step(p, c1, x[..., j:j + 1])
            y1.append(y)
    assert torch.allclose(torch.cat(y2, -1), torch.cat(y1, -1), atol=1e-6)
    assert torch.allclose(torch.cat(y2, -1), t.apply(p, x), atol=1e-5)
    assert c2[0].tolist() == [10, 10]


def test_the_split_rvq_tokens_and_sum(tiny):
    m, _, state, _ = tiny
    z = torch.randn(2, 16, 7, generator=torch.Generator().manual_seed(4))
    toks = m.vq.quantize(state, z)
    assert toks.shape == (4, 2, 7) and toks.dtype == torch.int32
    assert torch.equal(toks.long(), mimi_ref.quantize(state, z))
    q = m.vq.dequantize(state, toks)
    assert torch.allclose(q.transpose(1, 2),
                          mimi_ref.dequantize(state, toks), atol=1e-6)
    # the semantic codebook alone: its codeword through its projection
    one = m.vq.dequantize(state, toks[:1])
    want = state["semantic"][0][toks[0].long()] @ state["semantic_out"].T
    assert torch.allclose(one, want, atol=1e-6)


def test_the_caches_have_a_batch_axis(tiny):
    m = tiny[0]
    enc, dec = m.cache_axes()
    n_ring = 1 + 2 * TINY["transformer"]["num_layers"]
    assert len(enc) == len(m.init_cache(1)[0]) and set(enc) == {0}
    assert len(dec) == len(m.init_cache(1)[1]) and set(dec) == {0}
    ce = m.init_cache(3)[0]
    ring = [c for c in ce if c.dim() == 4]
    assert len(ring) == n_ring - 1
    assert ring[0].shape == (3, 2, TINY["transformer"]["context"], 8)


def test_the_registry_builds_mimi_from_the_shipped_config():
    hps = load_config(CONFIG)
    m = build_codec_model(hps.model, hps.model_kwargs.to_dict(),
                          device="cpu")
    assert m.hop_length == 1920
    assert (m.vq.num_quantizers, m.vq.codebook_size, m.vq.dim) == \
        (8, 2048, 256)
    tr = m.codec.encoder.transformer
    assert (tr.num_layers, tr.d_model, tr.num_heads, tr.context) == \
        (8, 512, 8, 250)
    assert m.codec.encoder.seanet.n_filters == 64
    # the registry imports the family only when it is asked for
    code = ("import sys, hilcodec_tpu_torch.models.registry; "
            "print('hilcodec_tpu_torch.models.mimi' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "False", out.stderr[-2000:]


def test_the_frame_kernels_refuse_mimi(tiny):
    m, params, state, wav = tiny
    with pytest.raises(ValueError, match="frame kernels"):
        m.encode_stream(params, state, wav, m.init_cache(3)[0],
                        megakernel=True)
