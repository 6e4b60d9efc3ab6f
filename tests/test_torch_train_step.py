"""The port's GAN train step against the JAX `Trainer` on the tiny config of
tests/test_train_step.py, from the same params, state, batch and draws.

The JAX state is initialized, its zero-init scales are set to seeded
nonzero values (so every residual and spec branch carries gradient), and
the same flat arrays build both states (the port's through its checkpoint
bridge). The draws of each JAX step (dropout depth, expiry candidates) are
computed here with `jax.random` from the step's key, exactly as the JAX
step derives them, and handed to the port's step.

Bars (those of tests/test_train_parity.py):
  * losses, loss_vq, d_loss and the balancer's EMA norms   <= 1e-4 relative
  * per-leaf G and D gradients and AdamP deltas           <= 2e-3 relative
    in L2 norm, against max(|reference|, GRAD_FLOOR)
  * the VQ state advance (embed, ema_embed, ema_num)      <= 1e-4 relative
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.utils.checkpoint import _flatten
from hilcodec_tpu.utils.pytree import leaf_paths
from test_train_step import tiny_trainer

from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.discriminators import Discriminators
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.models.losses import MelLoss
from hilcodec_tpu_torch.ops.rvq import ResidualVQ, RVQDraws
from hilcodec_tpu_torch.train.balancer import Balancer
from hilcodec_tpu_torch.train.optim import make_optimizer
from hilcodec_tpu_torch.train.schedulers import CosineAnnealingWarmup
from hilcodec_tpu_torch.train.step import Trainer
from hilcodec_tpu_torch.utils import params as P

CPU = torch.device("cpu")
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-3
VQ_RTOL = 1e-4
# relative L2 errors are taken against max(||reference||, GRAD_FLOOR): a
# leaf whose reference gradient is (near) zero is held to this absolute
# bound instead
GRAD_FLOOR = 1e-7
# AdamP gate: no leaf's cosine may sit within this relative distance of
# its threshold, or the two sides could legitimately branch apart
GATE_MARGIN = 1e-3
SEED = 0


def port_tiny_trainer() -> Trainer:
    """The port's counterpart of test_train_step.tiny_trainer()."""
    codec = HILCodec(channels_enc=8, channels_dec=8, n_residual_enc=1,
                     n_residual_dec=1, strides=(4, 2), n_fft_base=16,
                     vq_dim=16, res_scale_enc=0.577, res_scale_dec=0.577)
    vq = ResidualVQ(dim=16, codebook_size=32, num_quantizers=3,
                    kmeans_init=False, decay=0.99, ema_num_threshold=0.5,
                    ema_num_initial=0.5, dropout=True,
                    dropout_index=(1, 2, 3))
    disc = Discriminators(
        mfbd_kwargs={"use": True, "periods": [1, 2], "taps": 16,
                     "cutoff_freqs": [0.0, 0.25],
                     "channels": [4, 8], "kernel_sizes": [5, 5],
                     "strides": [3, 1]},
        mstftd_kwargs={"use": True, "filters": 4,
                       "n_ffts": [64], "hop_lengths": [16],
                       "win_lengths": [64]})
    balancer = Balancer(weights=(("freq", 0.48), ("mfbd_g", 1.1),
                                 ("mfbd_fm", 1.1), ("mstftd_g", 1.1),
                                 ("mstftd_fm", 1.1)),
                        weight_others=0.01, ema_decay=0.99)
    kw = {"lr": 5e-4, "betas": [0.5, 0.9], "weight_decay": 1e-5}
    opt_g, lr_g = make_optimizer("AdamP", kw)
    opt_d, lr_d = make_optimizer("AdamP", kw)
    sched = CosineAnnealingWarmup(warmup_iterations=10, T_max=100,
                                  eta_min=1e-6)
    return Trainer(model=CodecModel(codec, vq, CPU), disc=disc,
                   mel_loss=MelLoss(24000, n_mels_max=16),
                   balancer=balancer, optim_g=opt_g, optim_d=opt_d,
                   sched_g=sched, sched_d=sched, lr_g=lr_g, lr_d=lr_d)


def jax_draws(jtr, state, key, rows: int) -> RVQDraws:
    """The dropout depth and expiry candidates the JAX step draws from
    `key` at `state.iteration` (train/step.py and ops/rvq.py)."""
    k_drop, k_vq = jax.random.split(jax.random.fold_in(key, state.iteration))
    n = int(jtr.model.vq.sample_n(k_drop))
    _, rep_key = jax.random.split(k_vq)
    vq = jtr.model.vq
    cand = [np.asarray(jax.random.randint(k, (vq.codebook_size,), 0, rows))
            for k in jax.random.split(rep_key, vq.num_quantizers)]
    return RVQDraws(n, torch.from_numpy(np.stack(cand).astype(np.int64)))


def seeded_state_flat(jtr, seed=SEED):
    """The JAX initial state as flat leaf-path arrays, zero-init scales set
    to seeded values in [0.5, 1.5)."""
    state = jtr.init_state(jax.random.PRNGKey(seed))
    flat = _flatten(state)
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("scale_param"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    jstate = jax.tree.unflatten(jax.tree.structure(state),
                                [jnp.asarray(flat[p])
                                 for p in _flatten(state)])
    return flat, jstate


def rel_l2(a, b, floor=GRAD_FLOOR) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


def jflat(tree) -> dict:
    """JAX tree -> {leaf path: numpy}, in the port's '/'-path naming."""
    return dict(zip(leaf_paths(tree),
                    [np.asarray(x) for x in jax.tree.leaves(tree)]))


def tflat(tree) -> dict:
    return {k.replace(".", "/"): v.detach().numpy()
            for k, v in P.flatten(tree).items()}


@pytest.fixture(scope="module")
def run():
    """Two steps of both trainers from one state and batch; the JAX side
    jitted once (compute_grads and train_step in one program)."""
    jtr, ttr = tiny_trainer(), port_tiny_trainer()
    flat, js0 = seeded_state_flat(jtr)
    ts0 = P.tree_from_flat(flat, ttr.init_state(torch.Generator()))
    hop = jtr.model.hop_length
    wav = (np.random.default_rng(SEED + 1).standard_normal(
        (2, 1, hop * 128)) * 0.3).astype(np.float32)
    rows = 2 * 128

    jstep = jax.jit(lambda s, w, k: (jtr.compute_grads(s, w, k),
                                     jtr.train_step(s, w, k)))
    out = {"jtr": jtr, "ttr": ttr, "wav": wav, "js0": js0, "ts0": ts0,
           "flat": flat}
    js, ts = js0, ts0
    for i, key in enumerate((jax.random.PRNGKey(1), jax.random.PRNGKey(2))):
        draws = jax_draws(jtr, js, key, rows)
        jaux, (js_next, jm) = jstep(js, jnp.asarray(wav), key)
        taux = ttr.compute_grads(ts, torch.from_numpy(wav), draws)
        ts_next, tm = ttr.train_step(ts, torch.from_numpy(wav), draws)
        out[i] = dict(draws=draws, jaux=jaux, taux=taux, js=js, ts=ts,
                      js_next=js_next, ts_next=ts_next, jm=jm, tm=tm)
        js, ts = js_next, ts_next
    return out


def _check_losses(r):
    jaux, taux = r["jaux"], r["taux"]
    for k, v in jaux["losses"].items():
        np.testing.assert_allclose(float(taux["losses"][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(taux["loss_vq"]),
                               float(jaux["loss_vq"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(taux["d_loss"]), float(jaux["d_loss"]),
                               rtol=LOSS_RTOL)
    for k in ("ema_norms", "ema_fix"):
        np.testing.assert_allclose(taux["new_bal"][k].numpy(),
                                   np.asarray(jaux["new_bal"][k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k, v in jaux["ema_logs"].items():
        np.testing.assert_allclose(float(taux["ema_logs"][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert bool(taux["finite"]) == bool(jaux["finite"])
    assert bool(taux["do_d"]) == bool(jaux["do_d"])


def _check_grads(r):
    for side in ("g_grads", "d_grads"):
        jg, tg = jflat(r["jaux"][side]), tflat(r["taux"][side])
        assert set(jg) == set(tg), side
        worst = max((rel_l2(tg[k], jg[k]), k) for k in jg)
        assert worst[0] <= GRAD_RTOL, (side, worst)


def _check_vq(r):
    jv, tv = r["jaux"]["new_vq_state"], r["taux"]["new_vq_state"]
    for k in ("embed", "ema_embed", "ema_num"):
        np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]),
                                   rtol=VQ_RTOL, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(r["taux"]["num_replaces"].numpy(),
                                  np.asarray(r["jaux"]["num_replaces"]))


def _check_gates(r, ttr):
    """The AdamP gate sits clear of its threshold on every leaf, and the
    port's gradients take the branch JAX's take."""
    for side in ("g", "d"):
        opt = getattr(ttr, f"optim_{side}")
        params = getattr(r["ts"], f"params_{side}")
        jg = P.unflatten({
            k.replace("/", "."): torch.from_numpy(np.array(v))
            for k, v in jflat(r["jaux"][f"{side}_grads"]).items()})
        ref = opt.gate_report(jg, params)
        got = opt.gate_report(r["taux"][f"{side}_grads"], params)
        assert ref and set(ref) == set(got)
        for path, (ch, ch_t, ly, ly_t) in ref.items():
            assert abs(ch - ch_t) > GATE_MARGIN * ch_t, (path, ch, ch_t)
            assert abs(ly - ly_t) > GATE_MARGIN * ly_t, (path, ly, ly_t)
            g = got[path]
            assert (g[0] < g[1], g[2] < g[3]) == (ch < ch_t, ly < ly_t), path


def _check_deltas(r):
    for side in ("params_g", "params_d"):
        j0, j1 = jflat(getattr(r["js"], side)), jflat(
            getattr(r["js_next"], side))
        t0, t1 = tflat(getattr(r["ts"], side)), tflat(
            getattr(r["ts_next"], side))
        worst = max((rel_l2(t1[k] - t0[k], j1[k] - j0[k]), k) for k in j0)
        assert worst[0] <= GRAD_RTOL, (side, worst)
    jm, tm = r["jm"], r["tm"]
    for k in ("lr", "finite", "loss/d", "loss/freq"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert int(r["ts_next"].iteration) == int(r["js_next"].iteration)


@pytest.mark.parametrize("step", [0, 1])
def test_compute_grads_matches_jax(run, step):
    """Losses, balancer, per-leaf G and D gradients and the VQ advance of
    the first step, and of the second from each side's own first-step
    state (which checks that the state is threaded)."""
    r = run[step]
    assert r["draws"].n in (1, 2, 3)
    _check_losses(r)
    _check_grads(r)
    _check_vq(r)
    _check_gates(r, run["ttr"])


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_matches_jax(run, step):
    """AdamP deltas of both sides, the step's metrics and the counter."""
    _check_deltas(run[step])


def test_expiry_fired_with_jax_candidates(run):
    """ema_num_initial 0.5 sits at the threshold, so every code unused in
    the first step expires and takes JAX's candidate row."""
    assert int(run[0]["taux"]["num_replaces"].sum()) > 0


def test_valid_step_matches_jax(run):
    jl = jax.jit(run["jtr"].valid_step)(run["js0"], jnp.asarray(run["wav"]),
                                        jax.random.PRNGKey(0))
    tl = run["ttr"].valid_step(run["ts0"], torch.from_numpy(run["wav"]))
    assert set(jl) == set(tl)
    for k, v in jl.items():
        np.testing.assert_allclose(float(tl[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)


def test_d_nonfinite_guard(run):
    """An Inf in a D weight makes d_loss non-finite: the D update is
    skipped (params and optimizer state unchanged) and loss/d reads NaN."""
    ttr, ts = run["ttr"], run["ts0"]
    params_d = P.tree_map(lambda x: x.clone(), ts.params_d)
    params_d["mfbd"]["discs"][0]["convs"][0]["g"] *= float("inf")
    bad = ts._replace(params_d=params_d)
    new, m = ttr.train_step(bad, torch.from_numpy(run["wav"]),
                            run[0]["draws"])
    for a, b in zip(P.flatten(bad.params_d).values(),
                    P.flatten(new.params_d).values()):
        assert torch.equal(a, b)
    assert np.isnan(float(m["loss/d"]))
    assert int(new.opt_d.step) == int(bad.opt_d.step)


def test_disc_update_ratio_skips_d(run):
    """disc_update_ratio (1, 2): iteration 0 skips D (its params and
    optimizer state unchanged, loss/d NaN), iteration 1 updates it."""
    ttr = dataclasses.replace(run["ttr"], disc_update_ratio=(1, 2))
    wav = torch.from_numpy(run["wav"])
    s1, m1 = ttr.train_step(run["ts0"], wav, run[0]["draws"])
    for a, b in zip(P.flatten(run["ts0"].params_d).values(),
                    P.flatten(s1.params_d).values()):
        assert torch.equal(a, b)
    assert int(s1.opt_d.step) == 0 and np.isnan(float(m1["loss/d"]))
    s2, m2 = ttr.train_step(s1, wav, run[1]["draws"])
    assert any(not torch.equal(a, b) for a, b in zip(
        P.flatten(s1.params_d).values(), P.flatten(s2.params_d).values()))
    assert np.isfinite(float(m2["loss/d"]))
