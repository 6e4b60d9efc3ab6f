"""The port's quantizer routing against the JAX package's, on the CPU:
shape-gain VQ (`ops/shape_gain.py`), the `vq: ''` ablation (`NoVQ`) and
`vq_from_kwargs`.

The JAX side's random expiry candidates are drawn here from the JAX keys
exactly as its train step derives them, and handed to the port as
`ShapeGainDraws`. Bars: indices and replace counts exact; quantized
latents, losses and codebook states <= 1e-5; the train steps at the bars
of tests/test_train_parity.py (losses <= 1e-4 relative, per-leaf G and D
gradients <= 2e-3 relative L2, the quantizer's state <= 1e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.ops import rvq as JQ
from hilcodec_tpu.ops import shape_gain as JSG
from hilcodec_tpu.utils.hparams import HParams as JaxHParams
from test_train_step import tiny_trainer

from hilcodec_tpu_torch import eval as port_eval
from hilcodec_tpu_torch.models.codec import CodecModel, vq_from_kwargs
from hilcodec_tpu_torch.ops import rvq as TQ
from hilcodec_tpu_torch.ops import shape_gain as TSG
from hilcodec_tpu_torch.utils import params as P

from test_torch_eval_cli import _means, _root_eval, _wavs
from test_torch_train_loop import cut_down
from test_torch_train_step import (GRAD_RTOL, LOSS_RTOL, VQ_RTOL, jflat,
                                   port_tiny_trainer, rel_l2,
                                   seeded_state_flat, tflat)
from torch_port_common import n, t, write_jax_checkpoint

CPU = torch.device("cpu")
ATOL = 1e-5
# decay 0.5 and threshold 0.5 make codewords expire within a step
CB = dict(dim=8, shape_codebook_size=16, gain_codebook_size=4, decay=0.5,
          ema_num_threshold=0.5, ema_num_initial=0.5)
RVQ = dict(dim=8, num_quantizers=3, shape_codebook_size=16,
           gain_codebook_size=4, decay=0.5, ema_num_threshold=0.5,
           ema_num_initial=0.5)
SG_KWARGS = dict(dim=16, num_quantizers=3, shape_codebook_size=32,
                 gain_codebook_size=8, decay=0.99, ema_num_threshold=0.5,
                 ema_num_initial=0.5, dropout=False)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=atol)


def _state(jstate):
    return {k: t(np.asarray(v)) for k, v in jstate.items()}


def _candidates(key, scs, gcs, rows):
    """A JAX codebook's expiry candidates from its train_step key."""
    ks, kg = jax.random.split(key)
    return (t(np.asarray(jax.random.randint(ks, (scs,), 0, rows))).long(),
            t(np.asarray(jax.random.randint(kg, (gcs,), 0, rows))).long())


def _draws(key, rvq, rows, n_active=None):
    """ShapeGainDraws of a JAX ResidualShapeGainVQ call with `key`."""
    cands = [_candidates(jax.random.fold_in(key, i), rvq.shape_codebook_size,
                         rvq.gain_codebook_size, rows)
             for i in range(rvq.num_quantizers)]
    return TSG.ShapeGainDraws(n_active, torch.stack([c[0] for c in cands]),
                              torch.stack([c[1] for c in cands]))


def test_codebook_quantize_matches_jax(rng):
    jcb, tcb = JSG.ShapeGainCodebook(**CB), TSG.ShapeGainCodebook(**CB)
    state = jcb.init_state(jax.random.PRNGKey(0))
    x = (rng.standard_normal((64, 8)) * 2).astype(np.float32)
    ref = jcb.quantize(jnp.asarray(x), state)
    ours = tcb.quantize(t(x), _state(state))
    assert torch.equal(ours[1], t(np.asarray(ref[1])).long())
    assert torch.equal(ours[2], t(np.asarray(ref[2])).long())
    _close(ours[0], ref[0])
    _close(ours[3], ref[3])
    assert tcb.gain_num_ratio == jcb.gain_num_ratio == 4.0


def test_codebook_train_step_with_jax_candidates(rng):
    """One EMA step with expiry: shapes, gains, their usage and the
    replace counts equal JAX's on JAX's candidate rows."""
    jcb, tcb = JSG.ShapeGainCodebook(**CB), TSG.ShapeGainCodebook(**CB)
    state = jcb.init_state(jax.random.PRNGKey(0))
    x = (rng.standard_normal((64, 8)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    q_j, st_j, ns_j, ng_j = jcb.train_step(jnp.asarray(x), state, key)
    q_t, st_t, ns_t, ng_t = tcb.train_step(t(x), _state(state),
                                           *_candidates(key, 16, 4, 64))
    _close(q_t, q_j)
    for k in st_j:
        _close(st_t[k], st_j[k])
    assert (int(ns_t), int(ng_t)) == (int(ns_j), int(ng_j))
    assert int(ns_t) > 0 and int(ng_t) > 0


def test_residual_shape_gain_training_pass_matches_jax(rng):
    jr, tr = JSG.ResidualShapeGainVQ(**RVQ), TSG.ResidualShapeGainVQ(**RVQ)
    state = jr.init_state(jax.random.PRNGKey(0))
    x = (rng.standard_normal((2, 8, 10)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(1)
    q_j, st_j, loss_j, rep_j = jr(jnp.asarray(x), state, key)
    xt = t(x).requires_grad_(True)
    q_t, st_t, loss_t, rep_t = tr(xt, _state(state), _draws(key, jr, 20))
    _close(q_t, q_j)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    for k in st_j:
        _close(st_t[k], st_j[k])
    assert np.array_equal(n(rep_t), np.asarray(rep_j))
    # straight-through output, MSE commit loss: their gradient is JAX's
    g_j = jax.grad(lambda v: jnp.sum(jr(v, state, key)[0])
                   + jr(v, state, key)[2])(jnp.asarray(x))
    (g_t,) = torch.autograd.grad(q_t.sum() + loss_t, xt)
    _close(g_t, g_j)


@pytest.mark.parametrize("n_active", [1, 2, 3])
def test_residual_shape_gain_eval_at_static_and_traced_n(n_active, rng):
    """Evaluation at n stages: the port's n (a Python int) against JAX's
    static n and its traced n under jit (the infer / eval graphs)."""
    jr, tr = JSG.ResidualShapeGainVQ(**RVQ), TSG.ResidualShapeGainVQ(**RVQ)
    state = jr.init_state(jax.random.PRNGKey(0))
    x = (rng.standard_normal((2, 8, 10)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(1)
    traced = jax.jit(lambda v, k: jr(v, state, key, n=k, training=False))
    q_t, st_t, loss_t, rep_t = tr(t(x), _state(state),
                                  TQ.RVQDraws(n_active), training=False)
    for q_j, _, loss_j, _ in (
            jr(jnp.asarray(x), state, key, n=n_active, training=False),
            traced(jnp.asarray(x), jnp.asarray(n_active))):
        _close(q_t, q_j)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for k in st_t:
        assert torch.equal(st_t[k], t(np.asarray(state[k])))
    assert not rep_t.any()


def test_bridge_and_novq_follow_jax():
    kw = {"dim": 16, "num_quantizers": 3, "codebook_size": 64,
          "gain_codebook_size": 8, "ema_num_threshold": 0.5}
    jb, tb = JSG.ShapeGainVQBridge.from_kwargs(kw), \
        TSG.ShapeGainVQBridge.from_kwargs(kw)
    for f in ("dim", "num_quantizers", "shape_codebook_size",
              "gain_codebook_size", "decay", "ema_num_threshold",
              "ema_num_initial", "log_gain"):
        assert getattr(tb.rvq, f) == getattr(jb.rvq, f), f
    assert (tb.kmeans_init, tb.dropout) == (jb.kmeans_init, jb.dropout) == (
        False, False)
    assert tb.num_quantizers == 3 and jb.sample_n(None) is None
    gen = torch.Generator().manual_seed(0)
    d = tb.sample_draws(gen, 50)
    assert d.n is None and d.shape_idx.shape == (3, 64)
    assert d.gain_idx.shape == (3, 8) and int(d.shape_idx.max()) < 50
    state = tb.init_state(gen)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: v.shape for k, v in jb.init_state(jax.random.PRNGKey(0)).items()}
    assert tb.kmeans_init_state(state, None, None) is state

    jn, tn = JQ.NoVQ(), TQ.NoVQ()
    assert (tn.num_quantizers, tn.kmeans_init, tn.dropout) == (
        jn.num_quantizers, jn.kmeans_init, jn.dropout)
    st = tn.init_state(gen)
    assert set(st) == set(jn.init_state(jax.random.PRNGKey(0))) == {
        "initted"} and bool(st["initted"])
    x = torch.randn(2, 4, 5, requires_grad=True)
    q, st2, loss, rep, idx = tn(x, st, tn.sample_draws(gen, 10))
    assert q is x and st2 is st and idx is None
    assert float(loss) == 0.0 and rep.shape == (0,) and \
        rep.dtype == torch.int32
    assert tn.kmeans_init_state(st, x, None) is st


def test_vq_routing_matches_jax():
    """ResidualVQ, ResidualShapeGainVQ and '' route as JAX's
    CodecModel.from_config routes them; an unknown name is refused with
    JAX's message."""
    base = {"vq_kwargs": {"dim": 16, "codebook_size": 32,
                          "num_quantizers": 2, "kmeans_init": False}}
    from hilcodec_tpu.models.codec import CodecModel as JCM
    for name, cls in (("ResidualVQ", TQ.ResidualVQ),
                      ("ResidualShapeGainVQ", TSG.ShapeGainVQBridge),
                      ("", TQ.NoVQ)):
        kw = dict(base, vq=name, channels_enc=8, channels_dec=8)
        ours, theirs = vq_from_kwargs(kw), JCM.from_config(kw).vq
        assert isinstance(ours, cls)
        assert type(ours).__name__ == type(theirs).__name__
    assert isinstance(vq_from_kwargs(base), TQ.ResidualVQ)
    bad = dict(base, vq="ProductVQ")
    with pytest.raises(ValueError) as ours:
        vq_from_kwargs(bad)
    with pytest.raises(ValueError) as theirs:
        JCM.from_config(dict(bad, channels_enc=8, channels_dec=8))
    assert str(ours.value) == str(theirs.value)


def test_codec_without_euclidean_books_refuses_token_coding():
    cm = CodecModel.from_config(
        {"vq": "", "channels_enc": 8, "channels_dec": 8, "strides": [4, 2],
         "n_fft_base": 16, "vq_kwargs": {"dim": 16}}, device="cpu")
    params, vq_state = cm.seeded()
    wav = torch.zeros(1, 1, 8 * 4)
    with pytest.raises(ValueError, match="reconstruct through forward"):
        cm.encode(params, vq_state, wav)
    with pytest.raises(ValueError, match="reconstruct through forward"):
        cm.encode_stream(params, vq_state, wav, cm.init_cache(1)[0])
    out = cm.forward(params, vq_state, wav, None, training=False)
    assert out[0].shape == wav.shape and out[3].shape == (0,)


def _one_step(jtr, ttr, draws_fn):
    """One step of both trainers from one seeded state and batch."""
    flat, js = seeded_state_flat(jtr)
    ts = P.tree_from_flat(flat, ttr.init_state(torch.Generator()))
    hop = jtr.model.hop_length
    wav = (np.random.default_rng(1).standard_normal((2, 1, hop * 128))
           * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(1)
    jaux = jax.jit(jtr.compute_grads)(js, jnp.asarray(wav), key)
    taux = ttr.compute_grads(ts, torch.from_numpy(wav),
                             draws_fn(js, key, 2 * 128))
    return jaux, taux


def _check_step(jaux, taux):
    for k, v in jaux["losses"].items():
        np.testing.assert_allclose(float(taux["losses"][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k in ("loss_vq", "d_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, atol=1e-12, err_msg=k)
    for side in ("g_grads", "d_grads"):
        jg, tg = jflat(jaux[side]), tflat(taux[side])
        assert set(jg) == set(tg), side
        worst = max((rel_l2(tg[k], jg[k]), k) for k in jg)
        assert worst[0] <= GRAD_RTOL, (side, worst)
    jv, tv = jaux["new_vq_state"], taux["new_vq_state"]
    assert set(jv) == set(tv)
    for k in jv:
        np.testing.assert_allclose(n(tv[k]).astype(np.float32),
                                   np.asarray(jv[k]).astype(np.float32),
                                   rtol=VQ_RTOL, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(n(taux["num_replaces"]),
                                  np.asarray(jaux["num_replaces"]))


def test_trainer_step_with_shape_gain_matches_jax():
    """The flagship trainer's tiny config with `vq: ResidualShapeGainVQ`:
    one step against JAX's on JAX's expiry candidates."""
    jvq = JSG.ShapeGainVQBridge.from_kwargs(SG_KWARGS)
    jtr = tiny_trainer()
    jtr = dataclasses.replace(jtr, model=JaxCodecModel(jtr.model.codec, jvq))
    ttr = port_tiny_trainer()
    ttr = dataclasses.replace(ttr, model=dataclasses.replace(
        ttr.model, vq=TSG.ShapeGainVQBridge.from_kwargs(SG_KWARGS)))

    def draws(js, key, rows):
        _, k_vq = jax.random.split(jax.random.fold_in(key, js.iteration))
        return _draws(k_vq, jvq.rvq, rows)

    jaux, taux = _one_step(jtr, ttr, draws)
    _check_step(jaux, taux)
    assert int(n(taux["num_replaces"]).sum()) > 0


def test_trainer_step_without_vq_matches_jax():
    """The same trainer with `vq: ''`: the latents reach the decoder
    unquantized, no VQ loss, no replaces."""
    jtr = tiny_trainer()
    jtr = dataclasses.replace(jtr, model=JaxCodecModel(jtr.model.codec,
                                                       JQ.NoVQ()))
    ttr = port_tiny_trainer()
    ttr = dataclasses.replace(ttr, model=dataclasses.replace(
        ttr.model, vq=TQ.NoVQ()))
    jaux, taux = _one_step(jtr, ttr, lambda js, key, rows: TQ.RVQDraws(0))
    _check_step(jaux, taux)
    assert float(taux["loss_vq"]) == 0.0
    assert taux["num_replaces"].shape == (0,)


def test_eval_reconstructs_shape_gain_through_forward(tmp_path, capsys):
    """eval's model mode on a tiny shape-gain config and JAX checkpoint, at
    2 of 3 stages: what the root eval.py scores (both reconstruct through
    forward; offline and --stream alike)."""
    cfg = cut_down(str(tmp_path))
    cfg["model_kwargs"]["vq"] = "ResidualShapeGainVQ"
    cfg["model_kwargs"]["vq_kwargs"].update(
        shape_codebook_size=32, gain_codebook_size=8, dropout=False)
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    ckpt = str(tmp_path / "00001.ckpt.npz")
    write_jax_checkpoint(JaxHParams(**cfg), ckpt)
    ref, _ = _wavs(tmp_path, n=2, seconds=0.02)
    args = ["-i", str(ref), "-c", str(cfg_path), "--ckpt", ckpt,
            "-m", "sisdr,mcd", "-n", "2", "--stream"]
    theirs = _means(_root_eval(args, capsys))
    port_eval.main(args + ["--device", "cpu"])
    ours = _means(capsys.readouterr().out)
    assert set(ours) == set(theirs) == {"sisdr", "mcd"}
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=2e-4,
                                   err_msg=k)
