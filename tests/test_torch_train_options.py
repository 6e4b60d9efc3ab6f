"""The port's training options against the JAX package on the CPU: SGDP,
RAdam and SAM; MelGradLoss; one tiny trainer with MSD (spectral norm),
MelGradLoss, RAdam on the generator, SGDP on the discriminators and
`disc_update_ratio` (1, 2), two steps against the JAX `Trainer` (the
first step masks the D update, the `u` buffers still advance);
checkpoints with `u` buffers and RAdam / SGDP state crossing both ways;
the debug scanners; and on the flagship-shaped tiny trainer of
tests/test_train_step.py (MFBD + MSTFTD, cheaper on the CPU than MSD),
bf16 `compute_dtype` and every `remat` selector.

Tolerances:
  * optimizer updates and states: 1e-6 relative (atol 1e-9; f32
    elementwise work and norms);
  * MelGradLoss: value 1e-5 relative, gradient 1e-5 relative L2;
  * the trainer: the bars of tests/test_train_parity.py (losses and
    balancer 1e-4 relative; per-leaf G / D gradients and update deltas
    2e-3 relative L2, the deltas plus the f32 spacing of the params they
    are read from; VQ state 1e-4), the `u` buffers 1e-4 relative L2;
  * bf16 against JAX's bf16 step: losses 0.1 relative, per-leaf G and D
    gradients 0.3 relative L2 against max(|reference|, 1% of the side's
    global norm), each side's whole gradient 0.05 relative L2 (bf16's own
    rounding, which the two packages place at different points; readings
    beside the constants); bf16 losses within
    0.1 relative of f32's from the same state (the JAX package's own bar,
    tests/test_train_step.py);
  * remat: bitwise equal to `none`.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import discriminators as JD
from hilcodec_tpu.models import losses as JL
from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.models.hilcodec import HILCodec as JaxHILCodec
from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ
from hilcodec_tpu.train import balancer as JB
from hilcodec_tpu.train import optim as JO
from hilcodec_tpu.train import schedulers as JS
from hilcodec_tpu.train.step import Trainer as JaxTrainer
from hilcodec_tpu.utils import checkpoint as jax_ckpt
from hilcodec_tpu.utils import debug as jax_debug

from test_torch_train_step import (SEED, jax_draws, jflat, port_tiny_trainer,
                                   rel_l2, tflat)
from test_train_step import tiny_trainer

from hilcodec_tpu_torch.models import losses as TL
from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.discriminators import Discriminators
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.ops import rvq as TQ
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.train import optim as TO
from hilcodec_tpu_torch.train import schedulers as TS
from hilcodec_tpu_torch.train.balancer import Balancer
from hilcodec_tpu_torch.train.step import Trainer
from hilcodec_tpu_torch.utils import checkpoint as ckpt
from hilcodec_tpu_torch.utils import debug as port_debug
from hilcodec_tpu_torch.utils import params as P

OPT_RTOL = 1e-6
MEL_RTOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-3
U_RTOL = 1e-4
BF16_RTOL = 0.1
# the port's bf16 step against JAX's (see the bf16 test), two bf16 steps
# that round at different points: losses read 3.0e-3 at most (mfbd_fm),
# per-leaf gradients 0.043 (G) and 0.138 (D), each side's whole gradient
# 0.0091 (G) and 0.0112 (D); the port's f32 step reads 0.30 (the mel
# loss), 1.58 and 0.185, 0.63 and 0.070
BF16_LOSS_VS_JAX = 0.1
BF16_GRAD_VS_JAX = 0.3
BF16_GLOBAL_VS_JAX = 0.05
BF16_GRAD_FLOOR = 0.01
GATE_MARGIN = 1e-3
CPU = torch.device("cpu")

CODEC = dict(channels_enc=8, channels_dec=8, n_residual_enc=1,
             n_residual_dec=1, strides=(4, 2), n_fft_base=16, vq_dim=16,
             res_scale_enc=0.577, res_scale_dec=0.577)
VQ = dict(dim=16, codebook_size=32, num_quantizers=3, kmeans_init=False,
          decay=0.99, ema_num_threshold=0.5, ema_num_initial=0.5,
          dropout=True, dropout_index=(1, 2, 3))
# MSD alone: its first scale is spectrally normed; MPD and the aggregate
# are held against JAX in tests/test_torch_hifigan_disc.py (each family
# more than doubles the JAX step's compile time here)
DISC = dict(msd_kwargs={"use": True})
WEIGHTS = (("freq", 0.48), ("msd_g", 1.1), ("msd_fm", 1.1))
RADAM = {"lr": 5e-4, "betas": [0.5, 0.9], "weight_decay": 1e-5}
SGDP = {"lr": 5e-4, "momentum": 0.9, "nesterov": True,
        "weight_decay": 1e-5}


def to_t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def cmp_tree(got, ref, rtol=OPT_RTOL, what=""):
    fg, fr = P.flatten(got), P.flatten(ref)
    assert set(fg) == set(fr), what
    for k in fr:
        np.testing.assert_allclose(np.asarray(fg[k]), np.asarray(fr[k]),
                                   rtol=rtol, atol=1e-9,
                                   err_msg=f"{what} {k}")


# --------------------------------------------------------------- optimizers

def opt_tree(seed=0):
    """params and three steps of gradients: conv-like, matrix, a 1-D bias
    and a leaf under a regex group."""
    rng = np.random.default_rng(seed)
    shapes = {"conv": (4, 3, 5), "mat": (3, 4), "bias": (5,),
              "grp": {"w": (6, 2)}}
    mk = lambda: jax.tree.map(  # noqa: E731
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    return mk(), [mk() for _ in range(3)]


GROUPS = [{"regex_list": ["^grp/"], "weight_decay": 1e-2, "lr_scale": 0.5}]


def run_both(jopt, topt, jstate, tstate, lr=1e-2):
    """Three updates of both optimizers; compares updates and states."""
    params, grads = opt_tree()
    jp, tp = jax.tree.map(jnp.asarray, params), to_t(params)
    for step, g in enumerate(grads):
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp,
                                 jnp.asarray(lr, jnp.float32))
        tu, tstate = topt.update(to_t(g), tstate, tp, torch.tensor(lr))
        cmp_tree(tu, to_t(ju), what=f"updates {step}")
        for name in tstate._fields:
            cmp_tree(getattr(tstate, name), to_t(getattr(jstate, name)),
                     what=f"{name} {step}")
        jp = jax.tree.map(lambda a, b: a + b, jp, ju)
        tp = P.tree_map(lambda a, b: a + b, tp, tu)


@pytest.mark.parametrize("kw", [
    {"momentum": 0.9, "nesterov": True, "weight_decay": 1e-3},
    {"momentum": 0.5, "dampening": 0.1, "weight_decay": 1e-3},
    {"momentum": 0.0}])
def test_sgdp_matches_jax(kw):
    """SGDP with nesterov or plain momentum, the AdamP projection's gate
    clear of its threshold on every leaf, and a regex group."""
    jopt, jlr = JO.make_optimizer("SGDP", dict(kw, lr=1e-2), GROUPS)
    topt, tlr = TO.make_optimizer("SGDP", dict(kw, lr=1e-2), GROUPS)
    assert jlr == tlr and isinstance(topt, TO.SGDP)
    params, grads = opt_tree()
    gate = TO.AdamP(delta=topt.delta, eps=topt.eps)
    for path, (ch, ch_t, ly, ly_t) in gate.gate_report(
            to_t(grads[0]), to_t(params)).items():
        assert abs(ch - ch_t) > GATE_MARGIN * ch_t, path
        assert abs(ly - ly_t) > GATE_MARGIN * ly_t, path
    run_both(jopt, topt, jopt.init(params), topt.init(to_t(params)))


def _rho(t, b2):
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    return rho_inf - 2.0 * t * b2 ** t / (1 - b2 ** t)


def test_radam_matches_jax_across_rectification():
    """Steps 4, 5 and 6 at beta2 0.999: rho_t crosses 5 between steps 5
    and 6, so the unrectified and the rectified branch both run; weight
    decay goes into the gradient."""
    kw = {"lr": 1e-2, "betas": [0.9, 0.999], "weight_decay": 1e-3}
    jopt, _ = JO.make_optimizer("RAdam", kw)
    topt, _ = TO.make_optimizer("RAdam", kw)
    assert [_rho(t, 0.999) > 5 for t in (4, 5, 6)] == [False, False, True]
    params, grads = opt_tree(1)
    rng = np.random.default_rng(2)
    m = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                     .astype(np.float32) * 0.1, params)
    v = jax.tree.map(lambda p: rng.uniform(0.01, 0.1, p.shape)
                     .astype(np.float32), params)
    js = JO.RAdamState(jnp.asarray(3, jnp.int32),
                       jax.tree.map(jnp.asarray, m),
                       jax.tree.map(jnp.asarray, v))
    ts = TO.RAdamState(torch.tensor(3, dtype=torch.int32), to_t(m), to_t(v))
    run_both(jopt, topt, js, ts)
    assert int(topt.init(to_t(params)).step) == 0


def test_sam_two_steps_match_jax():
    """SAM over AdamP (from base_optimizer / base_optimizer_kwargs, with
    its groups): three rounds of first_step (the perturbation, adaptive)
    and second_step (the base update at the perturbed gradients)."""
    kw = {"base_optimizer": "AdamP", "rho": 0.1, "adaptive": True,
          "base_optimizer_kwargs": {"lr": 2e-3, "betas": [0.5, 0.9],
                                    "weight_decay": 1e-3}}
    jopt, jlr = JO.make_optimizer("SAM", dict(kw), GROUPS)
    topt, tlr = TO.make_optimizer("SAM", dict(kw), GROUPS)
    assert jlr == tlr == 2e-3 and isinstance(topt.base, TO.AdamP)
    params, grads = opt_tree(3)
    jp, tp = jax.tree.map(jnp.asarray, params), to_t(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in enumerate(grads):
        je, js = jopt.first_step(jax.tree.map(jnp.asarray, g), jp, js)
        te, ts = topt.first_step(to_t(g), tp, ts)
        cmp_tree(te, to_t(je), what=f"e_w {step}")
        g_adv = jax.tree.map(lambda x: 0.9 * x + 0.01, g)
        ju, js = jopt.second_step(jax.tree.map(jnp.asarray, g_adv), js, jp,
                                  jnp.asarray(tlr, jnp.float32))
        tu, ts = topt.second_step(to_t(g_adv), ts, tp, torch.tensor(tlr))
        cmp_tree(tu, to_t(ju), what=f"updates {step}")
        cmp_tree(ts.base_state.exp_avg, to_t(js.base_state.exp_avg),
                 what="exp_avg")
        assert not any(bool(x.any()) for x in P.flatten(ts.e_w).values())
        jp = jax.tree.map(lambda a, b: a + b, jp, ju)
        tp = P.tree_map(lambda a, b: a + b, tp, tu)


# ------------------------------------------------------------- MelGradLoss

@pytest.mark.parametrize("mel_norm", [None, "slaney"])
def test_mel_grad_loss_matches_jax(mel_norm):
    """Value and d loss / d wav_g against JAX's custom_vjp; the gradient is
    taken on the linear mel, so autograd through the log differs."""
    rng = np.random.default_rng(5)
    wg = (rng.standard_normal((2, 1, 2048)) * 0.3).astype(np.float32)
    wr = (rng.standard_normal((2, 1, 2048)) * 0.3).astype(np.float32)
    wg[:, :, 700:1500] *= 1e-4             # clipped bins on the g side
    jl = JL.MelGradLoss(24000, n_mels_max=16, mel_norm=mel_norm)
    tl = TL.MelGradLoss(24000, n_mels_max=16, mel_norm=mel_norm)
    assert [s[:2] for s in tl.transforms] == [s[:2] for s in jl.transforms]
    jv, jg = jax.jit(jax.value_and_grad(
        lambda w: jl(w, jnp.asarray(wr))["freq"]))(jnp.asarray(wg))
    w = torch.from_numpy(wg).requires_grad_(True)
    tv = tl(w, torch.from_numpy(wr))["freq"]
    (tg,) = torch.autograd.grad(tv, w)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=MEL_RTOL)
    assert rel_l2(tg.numpy(), np.asarray(jg)) <= MEL_RTOL

    # the same value through plain autograd: another gradient
    w2 = torch.from_numpy(wg).requires_grad_(True)
    plain = torch.zeros(())
    for n_fft, hop, n_mels in tl.transforms:
        basis = tl.basis(n_fft, n_mels, CPU)
        lg = torch.log(torch.clamp(tl._mel(w2, n_fft, hop, basis),
                                   min=tl.clip_val))
        lr = torch.log(torch.clamp(tl._mel(torch.from_numpy(wr), n_fft,
                                           hop, basis), min=tl.clip_val))
        plain = plain + torch.mean(torch.abs(lg - lr)) \
            + torch.mean(torch.square(lg - lr))
    (pg,) = torch.autograd.grad(plain, w2)
    np.testing.assert_allclose(float(plain.detach()), float(tv.detach()),
                               rtol=MEL_RTOL)
    assert rel_l2(pg.numpy(), tg.numpy()) > 0.1


# ------------------------------------------------ the trainer, against JAX

def jax_trainer():
    opt_g, lr_g = JO.make_optimizer("RAdam", RADAM)
    opt_d, lr_d = JO.make_optimizer("SGDP", SGDP)
    sched = JS.CosineAnnealingWarmup(warmup_iterations=10, T_max=100,
                                     eta_min=1e-6)
    return JaxTrainer(
        model=JaxCodecModel(JaxHILCodec(**CODEC), JaxResidualVQ(**VQ)),
        disc=JD.Discriminators(**DISC),
        mel_loss=JL.MelGradLoss(24000, n_mels_max=16),
        balancer=JB.Balancer(weights=WEIGHTS, weight_others=0.01,
                             ema_decay=0.99),
        optim_g=opt_g, optim_d=opt_d, sched_g=sched, sched_d=sched,
        lr_g=lr_g, lr_d=lr_d, disc_update_ratio=(1, 2))


def port_trainer():
    opt_g, lr_g = TO.make_optimizer("RAdam", RADAM)
    opt_d, lr_d = TO.make_optimizer("SGDP", SGDP)
    sched = TS.CosineAnnealingWarmup(warmup_iterations=10, T_max=100,
                                     eta_min=1e-6)
    return Trainer(
        model=CodecModel(HILCodec(**CODEC), ResidualVQ(**VQ), CPU),
        disc=Discriminators(**DISC),
        mel_loss=TL.MelGradLoss(24000, n_mels_max=16),
        balancer=Balancer(weights=WEIGHTS, weight_others=0.01,
                          ema_decay=0.99),
        optim_g=opt_g, optim_d=opt_d, sched_g=sched, sched_d=sched,
        lr_g=lr_g, lr_d=lr_d, disc_update_ratio=(1, 2))


def jax_step_with_grads(jtr):
    """jit of JAX's train_step that also returns its compute_grads output,
    captured in the same trace: one program to compile, not two."""
    box = []

    class Capturing(type(jtr)):
        def compute_grads(self, *a, **kw):
            box.append(super().compute_grads(*a, **kw))
            return box[-1]

    cap = Capturing(**{f.name: getattr(jtr, f.name)
                       for f in dataclasses.fields(jtr)})

    def step(state, wav, key):
        box.clear()
        new, metrics = cap.train_step(state, wav, key)
        return box[-1], (new, metrics)

    return jax.jit(step)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this module: the test runs share the host's
    cores between several worker processes, and a full complement of
    threads in each makes the CPU convs here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def seed_scales(flat):
    """The zero-init scales of a flat state set to seeded values in
    [0.5, 1.5), as test_torch_train_step does, so that every residual and
    spec branch carries gradient."""
    rng = np.random.default_rng(SEED)
    for k in flat:
        if k.endswith("scale_param"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    return flat


def bridged_state(jtr, ttr):
    """The port's seeded initial state, its scales seeded, and JAX's from
    the same arrays (JAX's tree read off eval_shape: its init, jitted or
    op by op, takes 14-20 s at MSD's widths)."""
    state = ttr.init_state(torch.Generator().manual_seed(SEED))
    flat = seed_scales(P.tree_to_flat(state))
    template = jax.eval_shape(jtr.init_state, jax.random.PRNGKey(SEED))
    js = jax.tree.unflatten(jax.tree.structure(template),
                            [jnp.asarray(flat[p])
                             for p in jax_ckpt._leaf_paths(template)])
    return js, P.tree_from_flat(flat, state)


def batch(jtr, seed=SEED + 1):
    return (np.random.default_rng(seed).standard_normal(
        (2, 1, jtr.model.hop_length * 128)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def run():
    """Two steps of both trainers from one state and batch, as
    tests/test_torch_train_step.py's two_steps (the JAX side jitted once)."""
    jtr, ttr = jax_trainer(), port_trainer()
    js0, ts0 = bridged_state(jtr, ttr)
    wav = batch(jtr)
    jstep = jax_step_with_grads(jtr)
    out = {"jtr": jtr, "ttr": ttr, "wav": wav, "js0": js0, "ts0": ts0}
    js, ts = js0, ts0
    for i, key in enumerate((jax.random.PRNGKey(1), jax.random.PRNGKey(2))):
        draws = jax_draws(jtr, js, key, 2 * 128)
        jaux, (js_next, jm) = jstep(js, jnp.asarray(wav), key)
        taux = ttr.compute_grads(ts, torch.from_numpy(wav), draws)
        ts_next, tm = ttr.apply_grads(ts, taux)
        out[i] = dict(draws=draws, jaux=jaux, taux=taux, js=js, ts=ts,
                      js_next=js_next, ts_next=ts_next, jm=jm, tm=tm)
        js, ts = js_next, ts_next
    return out


def u_paths(flat):
    return [k for k in flat if k.endswith("/u")]


@pytest.mark.parametrize("step", [0, 1])
def test_trainer_matches_jax(run, step):
    """Losses, balancer, G and D gradients, the VQ advance, both sides'
    deltas and the u buffers; step 0 masks the D update (D's gradients
    zero, its params unchanged but u), step 1 updates D."""
    r = run[step]
    jaux, taux = r["jaux"], r["taux"]
    assert bool(taux["do_d"]) == bool(jaux["do_d"]) == (step == 1)
    for k, v in jaux["losses"].items():
        np.testing.assert_allclose(float(taux["losses"][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k in ("loss_vq", "d_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k in ("ema_norms", "ema_fix"):
        np.testing.assert_allclose(taux["new_bal"][k].numpy(),
                                   np.asarray(jaux["new_bal"][k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for side in ("g_grads", "d_grads"):
        jg, tg = jflat(jaux[side]), tflat(taux[side])
        assert set(jg) == set(tg), side
        worst = max((rel_l2(tg[k], jg[k]), k) for k in jg)
        assert worst[0] <= GRAD_RTOL, (side, worst)
    for k in ("embed", "ema_embed", "ema_num"):
        np.testing.assert_allclose(taux["new_vq_state"][k].numpy(),
                                   np.asarray(jaux["new_vq_state"][k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    # SGDP's projection gate sits clear of its threshold (step 1; step 0's
    # D gradients are zero and its update masked)
    if step == 1:
        gate = TO.AdamP(delta=run["ttr"].optim_d.delta)
        for path, (ch, ch_t, ly, ly_t) in gate.gate_report(
                taux["d_grads"], r["ts"].params_d).items():
            assert abs(ch - ch_t) > GATE_MARGIN * ch_t, path
            assert abs(ly - ly_t) > GATE_MARGIN * ly_t, path
    for side in ("params_g", "params_d"):
        j0, j1 = jflat(getattr(r["js"], side)), jflat(
            getattr(r["js_next"], side))
        t0, t1 = tflat(getattr(r["ts"], side)), tflat(
            getattr(r["ts_next"], side))
        us = u_paths(j0)
        for k in us:
            assert rel_l2(t1[k], j1[k]) <= U_RTOL, k
        # the deltas as p_new - p: SGDP's steps (lr x a projected gradient)
        # can sit near the f32 spacing of p, so the rounding of p + update
        # (half a spacing on each side) is allowed beside the 2e-3
        worst = max(((np.linalg.norm((t1[k] - t0[k]) - (j1[k] - j0[k]))
                      / (GRAD_RTOL * np.linalg.norm(j1[k] - j0[k])
                         + np.linalg.norm(np.spacing(j0[k]))), k)
                     for k in j0 if k not in us), default=(0.0, ""))
        assert worst[0] <= 1.0, (side, worst)
        if side == "params_d":
            assert len(us) == 8         # MSD's first scale: 7 convs + post
            moved = {k for k in j0 if not np.array_equal(t1[k], t0[k])}
            # (the post conv's u has one element: its unit never moves)
            if step == 0:
                assert moved and moved <= set(us), moved
            else:
                assert moved - set(us), moved
    assert np.isnan(float(r["tm"]["loss/d"])) == (step == 0)


# --------------------------------------------------------------------- bf16

def dtype_names(tree) -> set:
    """The dtypes of a JAX or torch tree's leaves, by name."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*map(dtype_names, tree))
    return {str(tree.dtype).replace("torch.", "")}


class Recorder:
    """Delegates to `inner`, recording the dtypes of what it is called
    with (the mel loss's wav_g; the balancer's per-family gradients)."""

    def __init__(self, inner, seen):
        self.inner, self.seen = inner, seen

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, wav_g, wav_r):
        self.seen["mel wav_g"] = dtype_names(wav_g)
        return self.inner(wav_g, wav_r)

    def combine(self, grads, state, **kw):
        for k, v in grads.items():
            self.seen[f"balancer {k}"] = dtype_names(v)
        return self.inner.combine(grads, state, **kw)


class Tap:
    """Delegates to `inner`, recording under `tag` the dtypes of what its
    `apply` returns: the encoder's latents and the decoder's waveform
    before the f32 casts, each discriminator family's logits and feature
    maps before the losses' f32 casts."""

    def __init__(self, inner, seen, tag):
        self.inner, self.seen, self.tag = inner, seen, tag

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def apply(self, *a, **kw):
        out = self.inner.apply(*a, **kw)
        self.seen.setdefault(self.tag, set()).update(dtype_names(out))
        return out


def tapped(tr, seen):
    """The trainer `tr` (JAX's or the port's) in bf16 with every boundary
    recorded into `seen`."""
    codec = copy.copy(tr.model.codec)
    for part in ("encoder", "decoder"):
        object.__setattr__(codec, part, Tap(getattr(codec, part), seen, part))
    disc = copy.copy(tr.disc)
    object.__setattr__(disc, "discs", {name: Tap(d, seen, name)
                                       for name, d in tr.disc.discs.items()})
    bf16 = jnp.bfloat16 if isinstance(tr, JaxTrainer) else torch.bfloat16
    return dataclasses.replace(
        tr, compute_dtype=bf16, disc=disc,
        model=dataclasses.replace(tr.model, codec=codec),
        mel_loss=Recorder(tr.mel_loss, seen),
        balancer=Recorder(tr.balancer, seen))


@pytest.fixture(scope="module")
def tiny():
    """The flagship-shaped tiny trainers of tests/test_train_step.py (MFBD
    + MSTFTD, MelLoss) and its port on one bridged state, batch and key
    (the port's draws computed from it), and the port's f32 (remat none)
    step on them."""
    jtr, ttr = tiny_trainer(), port_tiny_trainer()
    js, state = bridged_state(jtr, ttr)
    wav = torch.from_numpy(batch(jtr))
    key = jax.random.PRNGKey(1)
    draws = jax_draws(jtr, js, key, 2 * 128)
    return dict(jtr=jtr, ttr=ttr, js=js, key=key, state=state, wav=wav,
                draws=draws, ref=ttr.compute_grads(state, wav, draws))


def test_bf16_matches_jax_dtypes_and_f32_losses(tiny):
    """compute_dtype bfloat16 against JAX's bf16 step from the same state
    and draws: the encoder, the decoder and every discriminator family
    return bf16, the mel loss's input (wav_g) and every gradient into the
    balancer are f32, each boundary in JAX's dtype. On a batch at 0.5
    whose 1e-3 noise lies below bf16's spacing there (2^-8), so that the
    input's cast moves the step far more than either side's own rounding:
    the losses and the G and D gradients within the bf16 bars of JAX's
    (an f32 step fails them). On the plain batch: losses within 0.1 of the
    port's f32 step's, the step finite, masters, optimizer, VQ and
    balancer states f32."""
    jseen, tseen = {}, {}
    flat = (0.5 + tiny["wav"] * 1e-3).contiguous()
    jaux = jax.jit(tapped(tiny["jtr"], jseen).compute_grads)(
        tiny["js"], jnp.asarray(flat.numpy()), tiny["key"])
    ttr = tapped(tiny["ttr"], tseen)
    got = ttr.compute_grads(tiny["state"], flat, tiny["draws"])
    assert tseen == jseen
    nets = {"encoder", "decoder", *tiny["ttr"].disc.discs}
    assert {k: v for k, v in tseen.items() if k in nets} == {
        k: {"bfloat16"} for k in nets}
    assert len(tseen) == len(nets) + 1 + len(ttr.balancer.weights)
    assert all(v == {"float32"} for k, v in tseen.items() if k not in nets)

    for k, v in jaux["losses"].items():
        np.testing.assert_allclose(float(got["losses"][k]), float(v),
                                   rtol=BF16_LOSS_VS_JAX, err_msg=k)
    np.testing.assert_allclose(float(got["d_loss"]), float(jaux["d_loss"]),
                               rtol=BF16_LOSS_VS_JAX)
    for side in ("g_grads", "d_grads"):
        jg, tg = jflat(jaux[side]), tflat(got[side])
        assert set(jg) == set(tg), side
        norm = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                           for v in jg.values()))
        worst = max((rel_l2(tg[k], jg[k], BF16_GRAD_FLOOR * norm), k)
                    for k in jg)
        assert worst[0] <= BF16_GRAD_VS_JAX, (side, worst)
        whole = rel_l2(np.concatenate([tg[k].ravel() for k in jg]),
                       np.concatenate([jg[k].ravel() for k in jg]))
        assert whole <= BF16_GLOBAL_VS_JAX, (side, whole)

    aux = ttr.compute_grads(tiny["state"], tiny["wav"], tiny["draws"])
    f32 = tiny["ref"]["losses"]
    for k, v in aux["losses"].items():
        assert abs(float(v) - float(f32[k])) <= BF16_RTOL * abs(
            float(f32[k])), k
    new, m = ttr.apply_grads(tiny["state"], aux)
    assert bool(aux["finite"])
    assert all(np.isfinite(float(v)) for k, v in m.items()
               if k.startswith("loss/"))
    for part in ("params_g", "params_d", "opt_g", "opt_d", "vq_state",
                 "balancer"):
        for k, v in P.flatten(getattr(new, part)).items():
            if v.is_floating_point():
                assert v.dtype == torch.float32, (part, k)
                assert bool(torch.isfinite(v).all()), (part, k)
    # the gradients reach the f32 masters through the casts
    assert any(bool(g.any()) for g in P.flatten(aux["g_grads"]).values())


# -------------------------------------------------------------------- remat

@pytest.mark.parametrize("remat", ["disc", "gen", "mel", "all", "gen,mel"])
def test_remat_is_bitwise_and_updates_vq_once(tiny, remat, monkeypatch):
    """Each selector gives the `none` step's losses, gradients, balancer
    and VQ state bit for bit; with `gen` the generator forward (and the
    quantizer's training pass) runs again in the backward, and the VQ
    state is still the one update's."""
    calls = []
    inner = TQ.ResidualVQ.__call__

    def counting(self, *a, **kw):
        calls.append(1)
        return inner(self, *a, **kw)

    monkeypatch.setattr(TQ.ResidualVQ, "__call__", counting)
    ref = tiny["ref"]
    got = dataclasses.replace(tiny["ttr"], remat=remat).compute_grads(
        tiny["state"], tiny["wav"], tiny["draws"])
    want_calls = 2 if remat in ("gen", "all", "gen,mel") else 1
    assert len(calls) == want_calls
    for part in ("g_grads", "d_grads", "losses", "new_vq_state", "new_bal",
                 "ema_logs"):
        a, b = P.flatten(got[part]), P.flatten(ref[part])
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    for k in ("d_loss", "loss_vq", "num_replaces", "finite", "do_d"):
        assert torch.equal(got[k], ref[k]), k


# -------------------------------------------------------------- checkpoints

def small(state):
    """A TrainState (JAX's or the port's) cut to MSD's first scale's first
    two convs (with their u) and its post conv on the D side, to keep the
    compressed JAX archive small; G whole (RAdam state)."""
    def cut(d):
        s0 = d["msd"]["discs"][0]
        return {"msd": {"discs": [{"convs": s0["convs"][:2],
                                   "post": s0["post"]}]}}
    return state._replace(params_d=cut(state.params_d),
                          opt_d=type(state.opt_d)(cut(state.opt_d[0])))


def test_checkpoint_with_u_and_radam_sgdp_state_crosses(run, tmp_path):
    """The port's state after two steps (u buffers, RAdam on G, SGDP on D)
    read by JAX's load_checkpoint leaf for leaf, and JAX's state read by
    the port's."""
    ts, js = small(run[1]["ts_next"]), small(run[1]["js_next"])
    flat = P.tree_to_flat(ts)
    assert ".opt_d/.momentum/msd/discs/0/convs/1/u" in flat
    assert ".opt_g/.step" in flat and ".params_d/msd/discs/0/post/u" in flat
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 2, ts, {"epoch": 2})
    theirs, extras = jax_ckpt.load_checkpoint(path, small(run["js0"]))
    assert int(extras["epoch"]) == 2
    got = jax_ckpt._flatten(theirs)
    assert set(got) == set(flat)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 2, js)
    back, _ = ckpt.load_checkpoint(jpath, small(run["ts0"]))
    resumed = P.tree_to_flat(back)
    for k, v in jax_ckpt._flatten(js).items():
        np.testing.assert_array_equal(resumed[k], np.asarray(v), err_msg=k)


# -------------------------------------------------------------------- debug

def test_debug_scanners_match_jax(run, tmp_path):
    """find_nonfinite on both states (one NaN planted at one path) and
    find_zero_grads on both sides' gradients name the same leaves."""
    r = run[0]
    assert port_debug.find_nonfinite(r["ts_next"]) == \
        jax_debug.find_nonfinite(r["js_next"]) == []
    tbad = r["ts_next"]._replace(params_d=P.tree_map(
        lambda x: x.clone(), r["ts_next"].params_d))
    tbad.params_d["msd"]["discs"][1]["post"]["g"][0] = float("nan")
    jd = jax.tree.map(np.array, r["js_next"].params_d)
    jd["msd"]["discs"][1]["post"]["g"][0] = np.nan
    jbad = r["js_next"]._replace(params_d=jd)
    got = port_debug.find_nonfinite(tbad)
    assert got == jax_debug.find_nonfinite(jbad) == [
        ".params_d/msd/discs/1/post/g"]
    for side in ("g_grads", "d_grads"):
        got = port_debug.find_zero_grads(r["taux"][side])
        assert got == jax_debug.find_zero_grads(r["jaux"][side]), side
    # the masked step's D gradients are all zero; u takes none in either
    zeros = port_debug.find_zero_grads(r["taux"]["d_grads"])
    assert len(zeros) == len(P.flatten(r["taux"]["d_grads"]))
    log = port_debug.FileLogger(str(tmp_path / "sub" / "run.log"))
    log.log("one")
    log.log("two")
    lines = (tmp_path / "sub" / "run.log").read_text().splitlines()
    assert [ln.split("] ", 1)[1] for ln in lines] == ["one", "two"]
