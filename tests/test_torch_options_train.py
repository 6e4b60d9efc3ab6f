"""One train step of tests/test_train_step.py's tiny trainer with the
codec options weight standardization, the learnable STFT and 1x1 ResBlock
skips, the port against the JAX `Trainer` from the same state, batch and
draws, at the bars of tests/test_train_parity.py (those of
test_torch_train_step.py, whose checks it reuses), and the new leaves
(`basis`, the 1x1 shortcuts, the standardized `v` / `g`) crossing the
checkpoint layout both ways."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.models.hilcodec import HILCodec as JaxHILCodec
from hilcodec_tpu.utils.checkpoint import _flatten

from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.utils import params as P

from test_torch_train_step import (_check_deltas, _check_grads,
                                   _check_losses, _check_vq, jax_draws,
                                   port_tiny_trainer, seeded_state_flat)
from test_train_step import tiny_trainer
from torch_port_common import CPU, t


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this module: the test runs share the host's
    cores between several worker processes."""
    k = torch.get_num_threads()
    torch.set_num_threads(min(k, 2))
    yield
    torch.set_num_threads(k)


def test_train_step_with_options_matches_jax():
    """One train step of test_train_step.py's tiny trainer with weight
    standardization, the learnable STFT and 1x1 skips in the codec: losses,
    balancer, per-leaf G and D gradients, the VQ advance and the AdamP
    deltas against the JAX Trainer on its own draws."""
    opts = dict(norm="weight_standardization", spec_learnable=True,
                skip="1x1")
    codec_kw = dict(channels_enc=8, channels_dec=8, n_residual_enc=1,
                    n_residual_dec=1, strides=(4, 2), n_fft_base=16,
                    vq_dim=16, res_scale_enc=0.577, res_scale_dec=0.577,
                    **opts)
    jtr = tiny_trainer()
    jtr = dataclasses.replace(jtr, model=JaxCodecModel(
        JaxHILCodec(**codec_kw), jtr.model.vq))
    ttr = port_tiny_trainer()
    ttr = dataclasses.replace(ttr, model=CodecModel(
        HILCodec(**codec_kw), ttr.model.vq, CPU))
    flat, js = seeded_state_flat(jtr)
    assert any(k.endswith("shortcut/v") for k in flat)
    assert any(k.endswith("basis") for k in flat)
    ts = P.tree_from_flat(flat, ttr.init_state(torch.Generator()))
    hop = jtr.model.hop_length
    wav = (np.random.default_rng(1).standard_normal((2, 1, hop * 128))
           * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(1)
    draws = jax_draws(jtr, js, key, 2 * 128)
    jaux, (js_next, jm) = jax.jit(lambda s, w, k: (
        jtr.compute_grads(s, w, k), jtr.train_step(s, w, k)))(
            js, jnp.asarray(wav), key)
    taux = ttr.compute_grads(ts, t(wav), draws)
    ts_next, tm = ttr.train_step(ts, t(wav), draws)
    r = dict(jaux=jaux, taux=taux, js=js, ts=ts, js_next=js_next,
             ts_next=ts_next, jm=jm, tm=tm)
    _check_losses(r)
    _check_grads(r)
    _check_vq(r)
    _check_deltas(r)
    # the checkpoint layout both ways: the port's next state under JAX's
    # leaf paths, and back into JAX's tree
    flat_t = P.tree_to_flat(ts_next)
    flat_j = _flatten(js_next)
    assert set(flat_t) == set(flat_j)
    assert all(flat_t[k].shape == np.shape(flat_j[k]) for k in flat_j)
    back = jax.tree.unflatten(jax.tree.structure(js_next),
                              [jnp.asarray(flat_t[k]) for k in flat_j])
    assert jax.tree.structure(back) == jax.tree.structure(js_next)
