"""The training half of the port's ResidualVQ and the codec's training
forward against the JAX package on the CPU, with JAX's own random draws
passed through the port's `RVQDraws` seam: EMA statistics, Laplace
smoothing, dead-code expiry with JAX's candidate rows, dropout masking,
`loss_vq`, the straight-through gradient and k-means with JAX's initial
rows; and the RVQ kernel's plan at the training path's M = 1800 rows.

Tolerances: indices and replace counts exact; codebooks, EMA statistics,
loss_vq and forwards to 1e-5 relative (f32, one matmul per statistic);
k-means means to 1e-4 (20 iterations of assignments and means)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.ops.rvq import ResidualVQ as JaxVQ
from torch_port_common import both_params, models

from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.ops import rvq_kernel
from hilcodec_tpu_torch.ops.rvq import ResidualVQ, RVQDraws

RTOL = 1e-5
KMEANS_RTOL = 1e-4
KW = dict(dim=16, codebook_size=32, num_quantizers=3, kmeans_init=False,
          decay=0.99)


def vq_pair(**kw):
    cfg = dict(KW, **kw)
    return JaxVQ(**cfg), ResidualVQ(**cfg)


def jax_state_to_port(js):
    return {k: torch.from_numpy(np.array(v)) for k, v in js.items()}


def jax_call_draws(jvq, key, n, rows) -> RVQDraws:
    """The candidates JAX's __call__ draws from `key` (ops/rvq.py)."""
    _, rep_key = jax.random.split(key)
    cand = [np.asarray(jax.random.randint(k, (jvq.codebook_size,), 0, rows))
            for k in jax.random.split(rep_key, jvq.num_quantizers)]
    return RVQDraws(n, torch.from_numpy(np.stack(cand).astype(np.int64)))


def latents(seed, B=2, T=40, C=16):
    x = np.random.default_rng(seed).standard_normal((B, C, T))
    return x.astype(np.float32)


def trained_state(jvq, seed):
    """A JAX state after one EMA pass (codebooks with history)."""
    st = jvq.init_state(jax.random.PRNGKey(seed))
    st = dict(st, embed=jax.random.normal(jax.random.PRNGKey(seed + 1),
                                          st["embed"].shape))
    st["ema_embed"] = st["embed"] * jvq.ema_num_initial
    return st


@pytest.mark.parametrize("threshold,n", [(0.0, 3), (0.0, 1), (0.5, 3),
                                         (0.5, 2), (0.5, 1)])
def test_training_pass_matches_jax(threshold, n):
    """threshold 0: Laplace smoothing; 0.5 with initial 0.5: expiry of
    every code unused in the pass, from JAX's candidates; n < n_q leaves
    the inactive stages' state and indices (0) alone."""
    jvq, tvq = vq_pair(ema_num_threshold=threshold, ema_num_initial=0.5)
    js = trained_state(jvq, 1)
    x = latents(2)
    key = jax.random.PRNGKey(3)
    jq, jns, jloss, jrep, jidx = jvq(jnp.asarray(x), js, key,
                                     n=jnp.asarray(n), training=True)
    draws = jax_call_draws(jvq, key, n, x.shape[0] * x.shape[2])
    tq, tns, tloss, trep, tidx = tvq(torch.from_numpy(x),
                                     jax_state_to_port(js), draws, True)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    if threshold > 0:
        assert int(trep.sum()) > 0
    for k in ("embed", "ema_embed", "ema_num"):
        np.testing.assert_allclose(tns[k].numpy(), np.asarray(jns[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
        # inactive stages keep their state exactly
        np.testing.assert_array_equal(tns[k][n:].numpy(),
                                      np.asarray(js[k])[n:])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                               rtol=RTOL, atol=1e-6)


def test_eval_pass_runs_every_stage_without_update():
    jvq, tvq = vq_pair(ema_num_threshold=0.5, ema_num_initial=0.5)
    js = trained_state(jvq, 4)
    x = latents(5)
    jq, jns, jloss, _, jidx = jvq(jnp.asarray(x), js, jax.random.PRNGKey(0),
                                  n=None, training=False)
    tq, tns, tloss, trep, tidx = tvq(torch.from_numpy(x),
                                     jax_state_to_port(js), None, False)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    for k in ("embed", "ema_embed", "ema_num"):
        np.testing.assert_array_equal(tns[k].numpy(), np.asarray(js[k]))
    assert int(trep.sum()) == 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)


def test_straight_through_and_loss_vq_gradient():
    """d/dx of sum(c * quantized) + w * loss_vq against jax.vjp: the
    identity for the straight-through output plus loss_vq's own term."""
    jvq, tvq = vq_pair(ema_num_threshold=0.5, ema_num_initial=0.5)
    js = trained_state(jvq, 6)
    x = latents(7)
    c = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def f(xx):
        q, _, loss, _, _ = jvq(xx, js, key, n=jnp.asarray(2), training=True)
        return jnp.sum(q * c) + 0.37 * loss

    jg = jax.grad(f)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    q, _, loss, _, _ = tvq(xt, jax_state_to_port(js),
                           jax_call_draws(jvq, key, 2, 80), True)
    (tg,) = torch.autograd.grad(torch.sum(q * torch.from_numpy(c))
                                + 0.37 * loss, xt)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("rows", [40, 80])
def test_kmeans_init_matches_jax(rows):
    """k-means from JAX's initial rows per stage: a permutation's head
    when rows >= K, rows drawn with replacement otherwise."""
    jvq, tvq = vq_pair(kmeans_init=True, ema_num_initial=0.5,
                       codebook_size=32 if rows == 80 else 64)
    x = latents(10, B=2, T=rows // 2)
    key = jax.random.PRNGKey(11)
    js = jvq.kmeans_init_state(jvq.init_state(key), jnp.asarray(x), key)
    init_idx = []
    K = jvq.codebook_size
    for k in jax.random.split(key, jvq.num_quantizers):
        idx = (jax.random.permutation(k, rows)[:K] if rows >= K
               else jax.random.randint(k, (K,), 0, rows))
        init_idx.append(np.asarray(idx))
    ts = tvq.kmeans_init_state(
        tvq.init_state(torch.Generator()), torch.from_numpy(x),
        torch.from_numpy(np.stack(init_idx).astype(np.int64)))
    assert bool(ts["initted"]) and bool(js["initted"])
    for k in ("embed", "ema_embed", "ema_num"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=KMEANS_RTOL, atol=1e-5, err_msg=k)


def test_init_state_and_draws():
    vq = ResidualVQ(dim=4, codebook_size=8, num_quantizers=3,
                    kmeans_init=True, ema_num_initial=0.5,
                    dropout_index=(2, 3))
    st = vq.init_state(torch.Generator())
    assert set(st) == {"embed", "ema_embed", "ema_num", "initted"}
    assert not bool(st["initted"]) and not st["embed"].any()
    assert torch.equal(st["ema_num"], torch.full((3, 8), 0.5))
    gen = torch.Generator().manual_seed(0)
    assert {vq.sample_n(gen) for _ in range(50)} == {2, 3}
    d = vq.sample_draws(gen, 10)
    assert d.expire_idx.shape == (3, 8) and int(d.expire_idx.max()) < 10
    assert vq.kmeans_init_indices(gen, 20).shape == (3, 8)
    idx = vq.kmeans_init_indices(gen, 5)
    assert int(idx.max()) < 5
    no_drop = ResidualVQ(num_quantizers=4, dropout=False)
    assert no_drop.sample_n(gen) == 4


def test_codec_training_forward_matches_jax():
    """The whole training forward (encoder, RVQ pass with EMA and expiry,
    decoder) against JAX's CodecModel.forward on the tiny codec."""
    jm, tm = models()
    cfg = dict(dim=16, codebook_size=32, num_quantizers=3, kmeans_init=False,
               ema_num_threshold=0.5, ema_num_initial=0.5, dropout=True,
               dropout_index=(1, 2, 3))
    jm = type(jm)(jm.codec, JaxVQ(**cfg))
    tm = CodecModel(tm.codec, ResidualVQ(**cfg), tm.device)
    jp, tp = both_params(jm, tm)
    js = trained_state(jm.vq, 12)
    hop = jm.hop_length
    wav = (np.random.default_rng(13).standard_normal((2, 1, hop * 20))
           * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(14)
    jw, jns, jloss, jrep = jm.forward(jp, js, jnp.asarray(wav), key,
                                      n=jnp.asarray(2), training=True)
    tw, tns, tloss, trep = tm.forward(
        tp, jax_state_to_port(js), torch.from_numpy(wav),
        jax_call_draws(jm.vq, key, 2, 2 * 20), training=True)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    for k in ("embed", "ema_embed", "ema_num"):
        np.testing.assert_allclose(tns[k].numpy(), np.asarray(jns[k]),
                                   rtol=RTOL, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)


def test_from_config_passes_every_vq_kwarg():
    from hilcodec_tpu_torch.utils.hparams import load_config
    kw = load_config("configs/hilcodec_speech.yaml").model_kwargs.to_dict()
    vq = CodecModel.from_config(kw, device="cpu").vq
    assert (vq.decay, vq.ema_num_threshold, vq.ema_num_initial, vq.dropout,
            vq.dropout_index, vq.kmeans_init) == (0.99, 0.5, 0.5, True,
                                                  (2, 4, 8), True)
    bare = CodecModel.from_config({"vq_kwargs": {}}, device="cpu").vq
    assert (bare.ema_num_threshold, bare.ema_num_initial,
            bare.dropout) == (0.0, 1.0, False)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_rvq_plan_at_the_training_rows(n):
    """The training forward launches the RVQ kernel on B x 75 = 1800 rows
    at depth 2, 4 or 8: more clusters than one wave holds, so the plan
    takes clusters of 8 on 16-row tiles, whose slices cover K."""
    def held(plan):        # the H100's counts at these sizes (PERF.md)
        return 7 if plan.cluster == 16 else 15
    plan = rvq_kernel.rvq_plan(1800, 1024, 128, n, held)
    assert (plan.cluster, plan.rows) == (8, 16)
    assert plan.tiles == 113 and plan.tiles > held(plan)
    assert plan.slice * plan.cluster >= 1024
    assert plan.smem <= rvq_kernel.SMEM_MAX

