"""The plain f32 reference of the training cell: the flagship's GAN train
step (generator, the quantizer's training pass, both discriminator
families, the balancer, AdamP), from the frozen copy of the port's plain
code, built from the configuration file's sections as the port's
`train/loop.build_trainer` builds its own.

`make_weights` draws the initial generator and discriminator weights and
an initialized VQ state from the seed; the benchmark hands the same
tensors to the port. `compare` holds the port's first three steps
against the reference's on the same state, batches and draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from . import counter as C
from .frozen.models.codec import CodecModel, residual_vq
from .frozen.models.discriminators import Discriminators
from .frozen.models.hilcodec import HILCodec, params_to
from .frozen.models.losses import MelLoss
from .frozen.train.balancer import Balancer
from .frozen.train.optim import make_optimizer
from .frozen.train.schedulers import make_scheduler
from .frozen.train.step import Trainer, TrainState
from .frozen.utils.params import flatten


def build(config: Dict[str, Any], device) -> Trainer:
    """The reference trainer of a configuration file (f32, no remat)."""
    mk = dict(config["model_kwargs"])
    tr, data = config["train"], config["data"]
    model = CodecModel(HILCodec.from_config(mk),
                       residual_vq(dict(mk.get("vq_kwargs") or {})),
                       torch.device(device))
    disc = Discriminators(**config["disc_kwargs"])
    mel = MelLoss(data["sampling_rate"], data.get("clip_val", 1e-5),
                  no_zero=tr.get("no_zero_at_mel_filter", True),
                  n_mels_max=tr.get("n_mels_max", 80))
    optim_g, lr = make_optimizer(tr["optimizer"], tr["optimizer_kwargs"])
    optim_d, _ = make_optimizer(tr["optimizer"], tr["optimizer_kwargs"])
    sched = make_scheduler(tr.get("scheduler"),
                           tr.get("scheduler_kwargs", {}),
                           tr.get("max_epochs", 1))
    return Trainer(
        model=model, disc=disc, mel_loss=mel,
        balancer=Balancer.from_config(tr["balancer_kwargs"]),
        optim_g=optim_g, optim_d=optim_d, sched_g=sched, sched_d=sched,
        lr_g=lr, lr_d=lr, use_lsgan=tr.get("use_lsgan", False),
        use_normalized_fm=tr.get("use_normalized_fm_loss", True),
        lookahead=tr.get("lookahead", 0))


def make_weights(trainer: Trainer, seed: int) -> Dict[str, Any]:
    """The initial generator and discriminator params (the zero-init
    scales drawn nonzero) and an initialized VQ state (N(0, 1 / dim)
    codebooks), on the CPU."""
    from ..common import fill_zero_init
    gen = torch.Generator().manual_seed(seed)
    params_g = fill_zero_init(trainer.model.codec.init(gen), gen)
    params_d = trainer.disc.init(gen, "cpu")
    vq = trainer.model.vq
    embed = (torch.randn((vq.num_quantizers, vq.codebook_size, vq.dim),
                         generator=gen) / math.sqrt(vq.dim))
    vq_state = {"embed": embed, "ema_embed": embed * vq.ema_num_initial,
                "ema_num": torch.full(embed.shape[:2], vq.ema_num_initial),
                "initted": torch.tensor(True)}
    return {"params_g": params_g, "params_d": params_d, "vq_state": vq_state}


def start_iteration(config: Dict[str, Any]) -> int:
    """The step the window stands at: past the scheduler's warm-up, where
    the learning rate is the configured one."""
    return int(config["train"].get("scheduler_kwargs", {})
               .get("warmup_iterations", 0))


def init_state(trainer: Trainer, weights: Dict[str, Any], iteration: int
               ) -> TrainState:
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


def leaves(tree) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in flatten(tree).items()
            if v.is_floating_point()}


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             floor_of: Dict[str, torch.Tensor]) -> Tuple[float, str, int]:
    """The worst leaf's |‖prog‖ - ‖ref‖| over max(‖ref‖, the median
    leaf's ‖ref‖), over the leaves whose reference gradient
    (`floor_of`) is at least a thousandth of the median leaf's; returns
    (gap, its leaf, the leaves left out)."""
    gnorm = {k: float(v.double().norm()) for k, v in floor_of.items()}
    gmed = sorted(gnorm.values())[len(gnorm) // 2]
    rn = {k: float(v.double().norm()) for k, v in ref.items()}
    med = sorted(rn.values())[len(rn) // 2]
    worst, at, out = 0.0, "", 0
    for k, r in rn.items():
        if gnorm[k] < 1e-3 * gmed:
            out += 1
            continue
        p = float(prog[k].double().norm())
        gap = abs(p - r) / max(r, med)
        if gap > worst:
            worst, at = gap, k
    return worst, at, out


def step_flops(trainer: Trainer, batch: int, seg: int) -> float:
    """Convolution and product FLOPs of one reference train step at
    `batch` x `seg` samples, counted on meta tensors."""
    meta = torch.device("meta")
    t = dataclasses.replace(trainer, model=dataclasses.replace(
        trainer.model, device=meta))
    w = make_weights(t, 0)
    state = init_state(t, C.to_meta(w), 0)
    wav = torch.zeros((batch, 1, seg), device=meta)
    draws = t.sample_draws(torch.Generator().manual_seed(1), wav.shape)
    rows: List = C.analyze(t.train_step, state, wav, draws)
    tot = C.totals(rows)
    return tot["conv"] + tot["dot"]
