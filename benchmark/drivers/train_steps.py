"""Training: the port's `Trainer.train_step` chained over the window.

The trainer is `train/loop.build_trainer` on the configuration file's
sections; the state is built from weights the reference's init draws
from the seed, standing past the scheduler's warm-up. Each step takes a
batch of `batch` x `segment` samples of speech-band noise made on the
card from the seed (every step's rows differ) and the quantizer's draws
from a seeded generator, as the port's loop draws them (`sample_draws`).
Set-up runs the first `checked_steps` steps through the same call and
keeps what the check needs: each step's losses, the optimizers' first
moments after step 1 (the first gradients, times 1 - beta1) and the
params after the last. The window then chains steps from that state
until its time is up and synchronizes; a traced run profiles
`profile_steps` more after it.

Records: audio_s / wall_s / units (steps) of the window, units_profiled,
attempted (steps), failed (steps the balancer found non-finite), and
from `work` the reference's FLOPs a step.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict

import torch

from .. import common
from ..reference import train_ref
from ..trace import Profiled
from . import port


def _batch(cell: common.Cell, k: int) -> torch.Tensor:
    tr = cell.traffic
    gen = common.device_generator(cell.device, common.sub_seed(cell.seed,
                                                               100 + k))
    return common.speech_band(gen, tr["batch"], tr["segment"], cell.device)


def _draw_gen(cell: common.Cell, k: int) -> torch.Generator:
    return torch.Generator().manual_seed(common.sub_seed(cell.seed,
                                                         10000 + k))


def _program_state(trainer, weights, iteration: int):
    from hilcodec_tpu_torch.train.step import TrainState
    from hilcodec_tpu_torch.models.hilcodec import params_to
    dev = trainer.device
    pg = params_to(weights["params_g"], dev)
    pd = params_to(weights["params_d"], dev)
    return TrainState(
        params_g=pg, params_d=pd,
        vq_state={k: v.to(dev) for k, v in weights["vq_state"].items()},
        opt_g=trainer.optim_g.init(pg), opt_d=trainer.optim_d.init(pd),
        balancer=trainer.balancer.init_state(dev),
        iteration=torch.full((), iteration, dtype=torch.int32, device=dev),
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        lr_scale=torch.ones((), device=dev))


def _clone(tree) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in train_ref.leaves(tree).items()}


def setup(cell: common.Cell) -> Dict[str, Any]:
    from hilcodec_tpu_torch.train.loop import build_trainer
    cfg, dev = cell.config, cell.device
    if cell.precision == "bf16":
        cfg = dict(cfg, train=dict(cfg["train"], compute_dtype="bfloat16"))
    trainer = build_trainer(port.hparams(cfg), dev)
    ref = train_ref.build(cell.config, "cpu")
    weights = train_ref.make_weights(ref, common.sub_seed(cell.seed, 0))
    state = _program_state(trainer, weights,
                           train_ref.start_iteration(cell.config))
    st = dict(cell=cell, trainer=trainer, losses=[])
    n = cell.traffic["checked_steps"]
    for k in range(n):
        wav = _batch(cell, k)
        state, m = trainer.train_step(
            state, wav, trainer.sample_draws(_draw_gen(cell, k), wav.shape))
        st["losses"].append({key: v for key, v in m.items()
                             if key.startswith("loss/")})
        if k == 0:
            st["m1_g"] = _clone(state.opt_g.exp_avg)
            st["m1_d"] = _clone(state.opt_d.exp_avg)
    st["p_g"], st["p_d"] = _clone(state.params_g), _clone(state.params_d)
    st["losses"] = [{key: float(v) for key, v in m.items()}
                    for m in st["losses"]]
    st["state"], st["next"] = state, n
    return st


def _run(st: Dict[str, Any], until: float = None, steps: int = None) -> int:
    cell, trainer = st["cell"], st["trainer"]
    k0 = k = st["next"]
    state = st["state"]
    while (time.perf_counter() < until) if until is not None \
            else (k < k0 + steps):
        with torch.profiler.record_function("train_step"):
            wav = _batch(cell, k)
            state, m = trainer.train_step(
                state, wav,
                trainer.sample_draws(_draw_gen(cell, k), wav.shape))
        st["finite"].append(m["finite"])
        k += 1
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    st["state"], st["next"] = state, k
    return k - k0


def window(st: Dict[str, Any]) -> Dict[str, Any]:
    cell, tr = st["cell"], st["cell"].traffic
    st["finite"] = []
    t0 = time.perf_counter()
    steps = _run(st, until=t0 + cell.seconds)
    wall = time.perf_counter() - t0
    rec: Dict[str, Any] = {
        "audio_s": steps * tr["batch"] * tr["segment"] / common.SAMPLE_RATE,
        "wall_s": wall, "units": steps, "precision": cell.precision}
    if cell.trace:
        with Profiled(cell.device) as p:
            done = _run(st, steps=tr["profile_steps"])
        rec["trace"], rec["units_profiled"] = p.data, done
    finite = torch.stack(st["finite"]).float().cpu()
    rec["attempted"] = int(finite.numel())
    rec["failed"] = int((finite < 1).sum())
    return rec


def work(st: Dict[str, Any]) -> Dict[str, Any]:
    tr = st["cell"].traffic
    ref = train_ref.build(st["cell"].config, "cpu")
    return {"flops_per_unit": train_ref.step_flops(ref, tr["batch"],
                                                   tr["segment"])}


def release(st: Dict[str, Any]) -> None:
    for key in ("trainer", "state", "finite"):
        st.pop(key, None)


def check(st: Dict[str, Any], rec: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's first steps from the same state, batches and
    draws: each step's losses, the first gradients (from the first
    moments after step 1) and the params' change after the last."""
    cell = st["cell"]
    dev = cell.device
    ref = train_ref.build(cell.config, dev)
    weights = train_ref.make_weights(ref, common.sub_seed(cell.seed, 0))
    state = train_ref.init_state(ref, weights,
                                 train_ref.start_iteration(cell.config))
    p0_g, p0_d = _clone(state.params_g), _clone(state.params_d)
    loss_gap = 0.0
    for k in range(cell.traffic["checked_steps"]):
        wav = _batch(cell, k)
        state, m = ref.train_step(
            state, wav, ref.sample_draws(_draw_gen(cell, k), wav.shape))
        for key, v in st["losses"][k].items():
            r = float(m[key])
            loss_gap = max(loss_gap, abs(v - r) / max(abs(r), 1e-6))
        if k == 0:
            r1_g = _clone(state.opt_g.exp_avg)
            r1_d = _clone(state.opt_d.exp_avg)
    b1 = ref.optim_g.betas[0]
    r_g, r_d = _clone(state.params_g), _clone(state.params_d)
    grad_gap = delta_gap = 0.0
    # the generator and the discriminator each against its own median
    # leaf: at the start of training the discriminator's gradients are
    # four orders of magnitude below the generator's
    for side, m_ref, m_prog, p0, p_ref, p_prog in (
            ("g", r1_g, st["m1_g"], p0_g, r_g, st["p_g"]),
            ("d", r1_d, st["m1_d"], p0_d, r_d, st["p_d"])):
        g_ref = {k: v / (1 - b1) for k, v in m_ref.items()}
        g_prog = {k: v / (1 - b1) for k, v in m_prog.items()}
        gap, at, out = train_ref.norm_gap(g_prog, g_ref, g_ref)
        dgap, dat, _ = train_ref.norm_gap(
            {k: p_prog[k] - p0[k] for k in p0},
            {k: p_ref[k] - p0[k] for k in p0}, g_ref)
        print(f"train check {side}: first gradients {gap:.3e} at {at}, "
              f"changes {dgap:.3e} at {dat}, {out} of {len(g_ref)} leaves "
              f"left out", file=sys.stderr)
        grad_gap, delta_gap = max(grad_gap, gap), max(delta_gap, dgap)
    lim = cell.check.get("limits", {})
    return {"loss_gap": (loss_gap, lim.get("loss_gap")),
            "grad1_gap": (grad_gap, lim.get("grad1_gap")),
            "delta3_gap": (delta_gap, lim.get("delta3_gap"))}
