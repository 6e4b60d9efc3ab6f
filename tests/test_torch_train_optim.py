"""The port's AdamP, schedulers, gradient clippers and balancer against the
JAX package on the CPU.

AdamP runs two updates on a tree built so that the gate takes each of its
branches (channel projection, layer projection, none), with a
`project_channel` regex group, a per-group weight decay and lr scale; every
leaf's cosine sits well clear of its threshold (asserted). Tolerances:
updates and optimizer state 1e-5 relative (f32 elementwise work and
norms); schedulers, clippers and the balancer 1e-6."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.train import balancer as JB
from hilcodec_tpu.train import grad_clip as JC
from hilcodec_tpu.train import optim as JO
from hilcodec_tpu.train import schedulers as JS

from hilcodec_tpu_torch.train import balancer as TB
from hilcodec_tpu_torch.train import grad_clip as TC
from hilcodec_tpu_torch.train import optim as TO
from hilcodec_tpu_torch.train import schedulers as TS
from hilcodec_tpu_torch.utils import params as P

RTOL = 1e-5
GATE_MARGIN = 1e-3


def to_t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def cmp_tree(got, ref, rtol=RTOL, what=""):
    fg, fr = P.flatten(got), P.flatten(ref)
    assert set(fg) == set(fr), what
    for k in fr:
        np.testing.assert_allclose(np.asarray(fg[k]), np.asarray(fr[k]),
                                   rtol=rtol, atol=1e-9,
                                   err_msg=f"{what} {k}")


def gate_tree(seed=0):
    """params / grads whose AdamP gate takes every branch:
    'ortho' (grad orthogonal to each channel -> channel projection),
    'layer' (grad orthogonal to the whole weight but not to each channel
    -> layer projection), 'free' (grad along the weight -> none), plus a
    1-D bias and a weight in a project_channel group."""
    rng = np.random.default_rng(seed)
    p_o = rng.standard_normal((4, 3, 5)).astype(np.float32)
    g_o = rng.standard_normal((4, 3, 5)).astype(np.float32)
    g_o -= (np.sum(g_o * p_o, axis=(1, 2), keepdims=True)
            / np.sum(p_o * p_o, axis=(1, 2), keepdims=True)) * p_o
    p_l = np.stack([np.ones((2, 3)), np.ones((2, 3))]).astype(np.float32)
    g_l = np.stack([np.ones((2, 3)), -np.ones((2, 3))]).astype(np.float32)
    g_l += 0.001 * rng.standard_normal(g_l.shape).astype(np.float32)
    p_f = rng.standard_normal((3, 4)).astype(np.float32)
    g_f = (2.0 * p_f + 0.1 * rng.standard_normal((3, 4))).astype(np.float32)
    params = {"ortho": p_o, "layer": p_l, "free": p_f,
              "bias": rng.standard_normal(5).astype(np.float32),
              "chan": {"w": rng.standard_normal((6, 2)).astype(np.float32)}}
    grads = {"ortho": g_o, "layer": g_l, "free": g_f,
             "bias": rng.standard_normal(5).astype(np.float32),
             "chan": {"w": rng.standard_normal((6, 2)).astype(np.float32)}}
    return params, grads


GROUPS = [{"regex_list": ["^chan/"], "project_channel": True,
           "weight_decay": 1e-2, "lr_scale": 0.5}]


@pytest.mark.parametrize("name,nesterov", [("AdamP", False),
                                           ("AdamP", True), ("Adam", False)])
def test_adamp_matches_jax(name, nesterov):
    kw = {"lr": 1e-3, "betas": [0.5, 0.9], "weight_decay": 1e-3,
          "nesterov": nesterov}
    jopt, jlr = JO.make_optimizer(name, kw, GROUPS)
    topt, tlr = TO.make_optimizer(name, kw, GROUPS)
    assert jlr == tlr
    params, grads = gate_tree()
    tp, tg = to_t(params), to_t(grads)
    if name == "AdamP":
        rep = topt.gate_report(tg, tp)
        assert set(rep) == {"ortho", "layer", "free"}
        ch, ch_t, ly, ly_t = rep["ortho"]
        assert ch < ch_t
        ch, ch_t, ly, ly_t = rep["layer"]
        assert ch >= ch_t and ly < ly_t
        ch, ch_t, ly, ly_t = rep["free"]
        assert ch >= ch_t and ly >= ly_t
        for path, (ch, ch_t, ly, ly_t) in rep.items():
            assert abs(ch - ch_t) > GATE_MARGIN * ch_t, path
            assert abs(ly - ly_t) > GATE_MARGIN * ly_t, path
    js, ts = jopt.init(params), topt.init(tp)
    jp = jax.tree.map(jnp.asarray, params)
    for step in range(2):
        lr = 1e-3 * (step + 1)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp,
                             jnp.asarray(lr, jnp.float32))
        tu, ts = topt.update(tg, ts, tp, torch.tensor(lr))
        cmp_tree(tu, to_t(ju), what=f"updates step {step}")
        cmp_tree(ts.exp_avg, to_t(js.exp_avg), what="exp_avg")
        cmp_tree(ts.exp_avg_sq, to_t(js.exp_avg_sq), what="exp_avg_sq")
        assert int(ts.step) == int(js.step) == step + 1
        jp = jax.tree.map(lambda a, b: a + b, jp, ju)
        tp = P.tree_map(lambda a, b: a + b, tp, tu)


def test_unported_optimizers_point_at_roadmap():
    """SGDP, RAdam and SAM build (ported; no longer refused), as in JAX;
    an unknown name still raises."""
    for name, kw, cls in (
            ("SGDP", {"lr": 1e-3, "momentum": 0.9}, TO.SGDP),
            ("RAdam", {"lr": 1e-3}, TO.RAdam),
            ("SAM", {"base_optimizer": "RAdam", "rho": 0.1,
                     "base_optimizer_kwargs": {"lr": 2e-3}}, TO.SAM)):
        opt, lr = TO.make_optimizer(name, dict(kw))
        jopt, jlr = JO.make_optimizer(name, dict(kw))
        assert isinstance(opt, cls) and lr == jlr
        assert type(opt).__name__ == type(jopt).__name__
    with pytest.raises(ValueError):
        TO.make_optimizer("Lion", {"lr": 1e-3})
    fn = TO.make_group_fn(GROUPS + [{"regex_list": ["w$"],
                                     "weight_decay": 0.0}])
    assert fn("chan/w") == {"project_channel": True, "weight_decay": 0.0,
                            "lr_scale": 0.5}
    assert fn("free") == {} and TO.make_group_fn(None) is None


@pytest.mark.parametrize("name,kw", [
    ("CosineAnnealingWarmup", {"warmup_iterations": 5, "eta_min": 1e-6}),
    ("CosineAnnealingLR", {"eta_min": 1e-5}),
    ("EmptyScheduler", {}),
    ("CosineAnnealingWarmupRestarts", {"first_cycle_steps": 4,
                                       "max_lr": 1e-3, "min_lr": 1e-5,
                                       "warmup_steps": 1, "gamma": 0.5}),
    ("CosineAnnealingWarmupRestarts", {"first_cycle_steps": 3,
                                       "cycle_mult": 2.0, "max_lr": 1e-3,
                                       "min_lr": 1e-5, "warmup_steps": 1}),
    ("ReduceLROnPlateau", {"factor": 0.5})])
def test_schedulers_match_jax(name, kw):
    js, ts = JS.make_scheduler(name, kw, 10), TS.make_scheduler(name, kw, 10)
    for it, ep in ((0, 0), (3, 0), (4, 0), (5, 1), (9, 3), (40, 7),
                   (100, 10)):
        ref = float(js(5e-4, jnp.asarray(it, jnp.int32),
                       jnp.asarray(ep, jnp.int32)))
        got = float(ts(5e-4, torch.tensor(it, dtype=torch.int32),
                       torch.tensor(ep, dtype=torch.int32)))
        np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=f"{it} {ep}")


def test_reduce_lr_on_plateau_semantics():
    """The JAX test's sequence: initial patience holds, `patience` bad
    epochs decay by `factor`, cooldown suppresses counting, min_lr floors
    the multiplier."""
    sched = TS.ReduceLROnPlateau(factor=0.5, patience=1, initial_patience=2,
                                 cooldown=1, threshold=1e-4)
    st = sched.init_state()
    scales = []
    for metric in (1.0, 1.0, 1.0, 1.0, 1.0, 1.0):
        st = sched.update(st, metric)
        scales.append(st["scale"])
    assert scales == [1.0, 1.0, 0.5, 0.5, 0.5, 0.25]
    st = sched.update(st, 0.1)
    assert st["bad_epochs"] == 0 and st["best"] == 0.1
    s2 = TS.ReduceLROnPlateau(factor=0.1, patience=0, min_lr=1e-4)
    st2 = s2.update(s2.init_state(), 1.0)
    st2 = s2.update(st2, 1.0, base_lr=1e-3)
    st2 = s2.update(st2, 1.0, base_lr=1e-3)
    assert st2["scale"] == pytest.approx(0.1)


@pytest.mark.parametrize("kind,kw", [("norm", {"max_norm": 0.5}),
                                     ("norm_local", {"max_norm": 0.5}),
                                     ("value", {"clip_value": 0.3}),
                                     (None, {})])
def test_clippers_match_jax(kind, kw):
    _, grads = gate_tree(1)
    ref = JC.make_clipper(kind, kw)(jax.tree.map(jnp.asarray, grads))
    got = TC.make_clipper(kind, kw)(to_t(grads))
    cmp_tree(got, to_t(ref), rtol=1e-6, what=str(kind))
    with pytest.raises(ValueError):
        TC.make_clipper("median")


def _balancer_grads(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((3, 1, 50)) * s).astype(np.float32)
            for k, s in (("freq", 10.0), ("mfbd_g", 0.01), ("mfbd_fm", 0.1),
                         ("mstftd_g", 1e-4), ("mstftd_fm", 0.02))}


@pytest.mark.parametrize("per_item", [True, False])
def test_balancer_combine_matches_jax(per_item):
    kw = dict(weights=(("freq", 0.48), ("mfbd_g", 1.1), ("mfbd_fm", 1.1),
                       ("mstftd_g", 1.1), ("mstftd_fm", 1.1)),
              weight_others=0.01, ema_decay=0.99, per_batch_item=per_item)
    jb, tb = JB.Balancer(**kw), TB.Balancer(**kw)
    js, ts = jb.init_state(), tb.init_state()
    for step in range(3):
        g = _balancer_grads(step)
        jout, js, jfin, jlogs = jb.combine(
            {k: jnp.asarray(v) for k, v in g.items()}, js)
        tout, ts, tfin, tlogs = tb.combine(
            {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        assert bool(tfin) and bool(jfin)
        # a sum of five scaled terms: 1e-6 of its largest magnitude
        np.testing.assert_allclose(
            tout.numpy(), np.asarray(jout), rtol=1e-6,
            atol=1e-6 * float(np.abs(np.asarray(jout)).max()))
        for k in ("ema_norms", "ema_fix"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6)
        for k in jlogs:
            np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]),
                                       rtol=1e-6)


def test_balancer_nonfinite_keeps_state_and_zeroes():
    kw = dict(weights=(("freq", 0.48), ("mfbd_g", 1.1)), ema_decay=0.99)
    jb, tb = JB.Balancer(**kw), TB.Balancer(**kw)
    g = _balancer_grads(4)
    g = {"freq": g["freq"], "mfbd_g": g["mfbd_g"]}
    _, js, _, _ = jb.combine({k: jnp.asarray(v) for k, v in g.items()},
                             jb.init_state())
    _, ts, _, _ = tb.combine({k: torch.from_numpy(v) for k, v in g.items()},
                             tb.init_state())
    g["mfbd_g"][0, 0, 3] = math.inf
    jout, js2, jfin, jlogs = jb.combine(
        {k: jnp.asarray(v) for k, v in g.items()}, js)
    tout, ts2, tfin, tlogs = tb.combine(
        {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    assert not bool(tfin) and not bool(jfin)
    assert not tout.any()
    for k in ("ema_norms", "ema_fix"):
        np.testing.assert_array_equal(ts2[k].numpy(), ts[k].numpy())
        np.testing.assert_allclose(ts2[k].numpy(), np.asarray(js2[k]),
                                   rtol=1e-6)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]),
                                   rtol=1e-6)
    cfg = TB.Balancer.from_config({"weights": {"freq": 1.0, "x": 2.0},
                                   "ema_decay": 0.9})
    assert cfg.keys == ["freq", "x"] and cfg.ema_decay == 0.9
