"""The port's Avocodo trainer against the JAX package's on the CPU: one and
two `AvocodoTrainer` steps from the same seeded state and batch on JAX's
draws (dropout depth, expiry candidates), `valid_step`, one step of the
`train.trainer: hilcodec` ablation (the Avocodo generator under the
balancer trainer), checkpoints crossing both ways, one cut-down epoch of
`python -m hilcodec_tpu_torch.train -c configs/avocodo_synth.yaml`, and
every shipped config building its port trainer.

Bars (those of tests/test_train_parity.py): losses <= 1e-4 relative,
per-leaf G and D gradients <= 2e-3 relative L2 (against max(|reference|,
1e-7)), the VQ state <= 1e-4.
"""

import dataclasses
import glob
import os
import subprocess
import sys
import types
from typing import Any

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import avocodo as JA
from hilcodec_tpu.models.losses import HifiGANMelLoss as JaxHifiGANMelLoss
from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ
from hilcodec_tpu.train import step_avocodo as JSA
from hilcodec_tpu.train.balancer import SimpleBalancer as JaxSimpleBalancer
from hilcodec_tpu.train.loop import build_trainer as jax_build_trainer
from hilcodec_tpu.train.optim import make_optimizer as jax_optimizer
from hilcodec_tpu.train.schedulers import CosineAnnealingWarmup as JaxCosine
from hilcodec_tpu.utils import checkpoint as jax_ckpt
from hilcodec_tpu.utils.hparams import HParams as JaxHParams

from hilcodec_tpu_torch.models import avocodo as TA
from hilcodec_tpu_torch.models.losses import HifiGANMelLoss
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.train import step_avocodo as TSA
from hilcodec_tpu_torch.train.balancer import SimpleBalancer
from hilcodec_tpu_torch.train.loop import TrainLoop, build_trainer
from hilcodec_tpu_torch.train.optim import make_optimizer
from hilcodec_tpu_torch.train.schedulers import CosineAnnealingWarmup
from hilcodec_tpu_torch.train.step import Trainer
from hilcodec_tpu_torch.utils import checkpoint as ckpt
from hilcodec_tpu_torch.utils import params as P
from hilcodec_tpu_torch.utils.hparams import HParams, load_config

from test_torch_avocodo import COMBD, PQMF, SBD, SEGMENT, TINY
from test_torch_train_loop import ROOT, make_corpus
from test_torch_train_step import (GRAD_RTOL, LOSS_RTOL,
                                   _check_grads, _check_losses, _check_vq,
                                   jax_draws, jflat, rel_l2,
                                   seeded_state_flat, tflat)
from torch_port_common import write_jax_checkpoint

CPU = torch.device("cpu")
SYNTH = os.path.join(ROOT, "configs", "avocodo_synth.yaml")
# quantizer dropout over 2 or 4 of 4 stages and dead-code expiry, as the
# shipped 12-stage stack with dropout_index [2, 4, 8, 12] has them
VQ = dict(dim=16, codebook_size=32, num_quantizers=4, kmeans_init=False,
          decay=0.99, ema_num_threshold=0.5, ema_num_initial=0.5,
          dropout=True, dropout_index=(2, 4))
WEIGHTS = {"freq": 45, "combd_g": 1.0, "combd_fm": 2.0, "sbd_g": 1.0,
           "sbd_fm": 2.0}
OPT = {"lr": 5e-4, "betas": [0.5, 0.9], "weight_decay": 1e-5}
# the shipped mel (n_fft 1024, win 1024) at the model hop; fewer mels
MEL = (24000, 1e-5, 1024, 40, 64, 1024)


def jax_tiny_trainer():
    opt_g, lr_g = jax_optimizer("AdamP", OPT)
    opt_d, lr_d = jax_optimizer("AdamP", OPT)
    sched = JaxCosine(warmup_iterations=10, T_max=100, eta_min=1e-6)
    return JSA.AvocodoTrainer(
        model=JSA.AvocodoCodecModel(JA.AvocodoModel(**TINY),
                                    JaxResidualVQ(**VQ)),
        disc=JA.AvocodoDiscriminators(combd_kwargs=COMBD, sbd_kwargs=SBD),
        mel_loss=JaxHifiGANMelLoss(*MEL),
        balancer=JaxSimpleBalancer.from_config(
            {"weights": WEIGHTS, "weight_others": 0.01}),
        optim_g=opt_g, optim_d=opt_d, sched_g=sched, sched_d=sched,
        lr_g=lr_g, lr_d=lr_d, pqmf_config=PQMF)


def port_tiny_trainer():
    opt_g, lr_g = make_optimizer("AdamP", OPT)
    opt_d, lr_d = make_optimizer("AdamP", OPT)
    sched = CosineAnnealingWarmup(warmup_iterations=10, T_max=100,
                                  eta_min=1e-6)
    return TSA.AvocodoTrainer(
        model=TSA.AvocodoCodecModel(
            TA.AvocodoFullRate(TA.AvocodoModel(**TINY)), ResidualVQ(**VQ),
            CPU),
        disc=TA.AvocodoDiscriminators(combd_kwargs=COMBD, sbd_kwargs=SBD),
        mel_loss=HifiGANMelLoss(*MEL),
        balancer=SimpleBalancer.from_config(
            {"weights": WEIGHTS, "weight_others": 0.01}),
        optim_g=opt_g, optim_d=opt_d, sched_g=sched, sched_d=sched,
        lr_g=lr_g, lr_d=lr_d, pqmf_config=PQMF)


def _seeded(jtr):
    """seeded_state_flat of JAX's state, its init jitted (eager init
    dispatches op by op)."""
    return seeded_state_flat(types.SimpleNamespace(
        init_state=jax.jit(jtr.init_state)))


def _wav(seed=1):
    return (np.random.default_rng(seed).standard_normal((2, 1, SEGMENT))
            * 0.3).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class _GivenGrads(JSA.AvocodoTrainer):
    """JAX's AvocodoTrainer whose train_step takes its compute_grads output
    as given, so that the gradients compile once."""
    aux: Any = None

    def compute_grads(self, state, wav_r, key):
        return self.aux


@pytest.fixture(scope="module")
def run():
    """Two steps of both trainers: JAX's compute_grads, then JAX's
    train_step on those gradients."""
    jtr, ttr = jax_tiny_trainer(), port_tiny_trainer()
    flat, js = _seeded(jtr)
    ts = P.tree_from_flat(flat, ttr.init_state(torch.Generator()))
    wav = _wav()
    rows = 2 * SEGMENT // jtr.model.hop_length
    given = _GivenGrads(**{f.name: getattr(jtr, f.name)
                           for f in dataclasses.fields(jtr)})
    jgrads = jax.jit(jtr.compute_grads)
    jupdate = jax.jit(lambda aux, s, k: dataclasses.replace(
        given, aux=aux).train_step(s, None, k))
    out = {"jtr": jtr, "ttr": ttr, "wav": wav, "js0": js, "ts0": ts}
    for i, key in enumerate((jax.random.PRNGKey(1), jax.random.PRNGKey(2))):
        draws = jax_draws(jtr, js, key, rows)
        jaux = jgrads(js, jnp.asarray(wav), key)
        js_next, jm = jupdate(jaux, js, key)
        taux = ttr.compute_grads(ts, torch.from_numpy(wav), draws)
        ts_next, tm = ttr.apply_grads(ts, taux)
        out[i] = dict(draws=draws, jaux=jaux, taux=taux, jm=jm, tm=tm,
                      js_next=js_next, ts_next=ts_next)
        js, ts = js_next, ts_next
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_avocodo_step_matches_jax(run, step):
    r = run[step]
    jaux, taux = r["jaux"], r["taux"]
    assert set(taux["losses"]) == set(jaux["losses"]) == set(WEIGHTS)
    for k, v in jaux["losses"].items():
        np.testing.assert_allclose(float(taux["losses"][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k in ("loss_vq", "d_loss", "g_total"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    _check_grads(r)
    _check_vq(r)
    for k, v in r["jm"].items():
        ours = r["tm"][k]
        if k == "num_replaces":
            np.testing.assert_array_equal(ours.numpy(), np.asarray(v))
        else:
            np.testing.assert_allclose(float(ours), float(v),
                                       rtol=LOSS_RTOL, err_msg=k)
    assert int(r["ts_next"].iteration) == step + 1


def test_avocodo_step_updates_params_like_jax(run):
    """The AdamP deltas of the first step, D and G, <= 2e-3 relative L2
    per leaf."""
    r = run[0]
    for side in ("params_g", "params_d"):
        j0, j1 = jflat(getattr(run["js0"], side)), jflat(
            getattr(r["js_next"], side))
        t0, t1 = tflat(getattr(run["ts0"], side)), tflat(
            getattr(r["ts_next"], side))
        worst = max((rel_l2(t1[k] - t0[k], j1[k] - j0[k]), k) for k in j0)
        assert worst[0] <= GRAD_RTOL, (side, worst)


def test_valid_step_matches_jax(run):
    jtr, ttr = run["jtr"], run["ttr"]
    ref = jax.jit(jtr.valid_step)(run["js0"], jnp.asarray(run["wav"]),
                                  jax.random.PRNGKey(0))
    ours = ttr.valid_step(run["ts0"], torch.from_numpy(run["wav"]))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)


def test_codec_facade_encode_decode_and_forward_match_jax(run):
    """AvocodoCodecModel: encode's tokens, decode's full-rate wav and the
    evaluation forward, against JAX's facade."""
    jtr, ttr = run["jtr"], run["ttr"]
    jp, tp = run["js0"].params_g, run["ts0"].params_g
    jv, tv = run["js0"].vq_state, run["ts0"].vq_state
    wav = run["wav"]
    jm = jtr.model
    tok = ttr.model.encode(tp, tv, torch.from_numpy(wav), n=3)
    jtok = jax.jit(lambda p, v, w: jm.encode(p, v, w, n=3))(
        jp, jv, jnp.asarray(wav))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(
        ttr.model.decode(tp, tv, tok).numpy(),
        np.asarray(jax.jit(jm.decode)(jp, jv, jtok)), rtol=0, atol=1e-5)
    ours = ttr.model.forward(tp, tv, torch.from_numpy(wav), None,
                             training=False)[0]
    ref = jax.jit(lambda p, v, w: jm.forward(
        p, v, w, jax.random.PRNGKey(0), training=False)[0])(
            jp, jv, jnp.asarray(wav))
    assert ours.shape == (2, 1, SEGMENT)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def _hiltrainer_cfg():
    """The `train.trainer: hilcodec` ablation at a tiny width: the Avocodo
    generator, an MSTFTD, the balancer."""
    mk = {k: (list(v) if isinstance(v, tuple) else v)
          for k, v in TINY.items() if k != "vq_dim"}
    mk["vq_kwargs"] = {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in VQ.items()}
    return dict(
        model="avocodo", model_kwargs=mk,
        disc_kwargs={"mstftd_kwargs": {
            "use": True, "n_ffts": [64], "hop_lengths": [16],
            "win_lengths": [64], "filters": 4}},
        data={"sampling_rate": 24000},
        train={"trainer": "hilcodec", "batch_size": 2, "n_mels_max": 16,
               "balancer_kwargs": {"weights": {"freq": 1.0, "mstftd_g": 1.0,
                                               "mstftd_fm": 1.0},
                                   "weight_others": 0.01,
                                   "ema_decay": 0.99},
               "optimizer": "AdamP", "optimizer_kwargs": dict(OPT)})


def test_hilcodec_trainer_ablation_step_matches_jax():
    cfg = _hiltrainer_cfg()
    jtr = jax_build_trainer(JaxHParams(**cfg))
    ttr = build_trainer(HParams(**cfg), "cpu")
    assert isinstance(ttr, Trainer)
    assert isinstance(ttr.model.codec, TA.AvocodoFullRate)
    flat, js = _seeded(jtr)
    ts = P.tree_from_flat(flat, ttr.init_state(torch.Generator()))
    wav = _wav(3)
    key = jax.random.PRNGKey(1)
    draws = jax_draws(jtr, js, key, 2 * SEGMENT // jtr.model.hop_length)
    r = {"jaux": jax.jit(jtr.compute_grads)(js, jnp.asarray(wav), key),
         "taux": ttr.compute_grads(ts, torch.from_numpy(wav), draws)}
    _check_losses(r)
    _check_grads(r)
    _check_vq(r)


def cut_down_avocodo(corpus: str) -> dict:
    """configs/avocodo_synth.yaml at a tiny width on `corpus`: the tiny
    generator, CoMBD and SBD of tests/test_torch_avocodo.py, 4 quantizers
    with dropout over 2 or 4, 2 steps of batch 2 per epoch of SEGMENT
    samples, a 2-item valid filelist."""
    with open(SYNTH) as f:
        cfg = yaml.safe_load(f)
    cfg["model_kwargs"].update(
        {k: (list(v) if isinstance(v, tuple) else v)
         for k, v in TINY.items() if k != "vq_dim"})
    cfg["model_kwargs"]["vq_kwargs"].update(
        dim=16, codebook_size=32, num_quantizers=4, dropout_index=[2, 4])
    cfg["disc_kwargs"] = {"combd_kwargs": COMBD, "sbd_kwargs": SBD}
    data = cfg["data"]
    data["classes"]["clean"]["directories_to_include"] = [
        os.path.join(corpus, "train")]
    data.update(length=4, segment_size=SEGMENT, wav_dir=corpus,
                num_mels=40,
                filelists={"valid": os.path.join(corpus, "valid.txt")})
    cfg["train"].update(batch_size=2, max_epochs=1, save_interval=1,
                        num_workers=0, plot_param_and_grad=False)
    cfg["valid"] = {"batch_size": 2}
    return cfg


@pytest.fixture
def setup(tmp_path):
    make_corpus(str(tmp_path))
    cfg = cut_down_avocodo(str(tmp_path))
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return tmp_path, cfg, str(path)


def test_checkpoints_cross_both_ways(setup):
    """A port TrainLoop epoch's .ckpt.npz loads into JAX's AvocodoTrainState
    leaf for leaf, and the port resumes from one that JAX wrote."""
    tmp, cfg, _ = setup
    loop = TrainLoop(HParams(**cfg), run_dir=str(tmp / "port"),
                     device="cpu")
    loop.run()
    assert loop.iteration == 2
    assert isinstance(loop.state, TSA.AvocodoTrainState)
    path = ckpt.latest_checkpoint(str(tmp / "port"))[1]

    jtr = jax_build_trainer(JaxHParams(**cfg))
    assert isinstance(jtr, JSA.AvocodoTrainer)
    template = jax.jit(jtr.init_state)(jax.random.PRNGKey(3))
    jstate, extras = jax_ckpt.load_checkpoint(path, template)
    assert int(extras["epoch"]) == 1 and int(jstate.iteration) == 2
    ours = P.tree_to_flat(loop.state)
    theirs = jax_ckpt._flatten(jstate)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)

    # and back: a JAX-written checkpoint resumes the port's loop
    write_jax_checkpoint(JaxHParams(**cfg),
                         str(tmp / "jax" / "00001.ckpt.npz"))
    back = TrainLoop(HParams(**cfg), run_dir=str(tmp / "jax"), device="cpu")
    back.init_or_resume()
    assert back.epoch == 1
    resumed = P.tree_to_flat(back.state)
    with np.load(str(tmp / "jax" / "00001.ckpt.npz")) as z:
        written = {k: z[k] for k in z.files if not k.startswith("__")}
    assert set(resumed) == set(written)
    for k, v in written.items():
        np.testing.assert_array_equal(resumed[k], v, err_msg=k)


def test_cli_trains_one_epoch(setup):
    tmp, _, path = setup
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "hilcodec_tpu_torch.train", "-n", "avo",
         "-b", str(tmp / "logs"), "-c", path, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp / "logs" / "avo" / "00001.ckpt.npz").exists()
    assert "combd_fm" in out.stdout and "sbd_g" in out.stdout


@pytest.mark.parametrize("config", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs",
                                                        "*.yaml"))))
def test_every_shipped_config_builds_its_trainer(config):
    """Built on the CPU, not stepped."""
    hps = load_config(os.path.join(ROOT, "configs", config))
    tr = build_trainer(hps, "cpu")
    avocodo_own = (hps.get("model") == "avocodo"
                   and hps.train.get("trainer") != "hilcodec")
    assert isinstance(tr, TSA.AvocodoTrainer if avocodo_own else Trainer)
    assert tr.device == CPU
