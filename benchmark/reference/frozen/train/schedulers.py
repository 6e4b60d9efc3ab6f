"""LR schedulers as functions of (iteration, epoch)
(`hilcodec_tpu/train/schedulers.py`).

Each scheduler maps (base_lr, iteration, epoch) to the step's learning
rate; iteration and epoch are 0-d tensors of the train state, so the rate
is computed on their device without a host read. ReduceLROnPlateau is
driven on the host once per epoch and rides `TrainState.lr_scale`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def _f32(iteration: torch.Tensor) -> torch.Tensor:
    return iteration.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class EmptyScheduler:
    """Constant LR."""

    def __call__(self, base_lr, iteration, epoch):
        return torch.full((), base_lr, dtype=torch.float32,
                          device=iteration.device)


@dataclasses.dataclass(frozen=True)
class CosineAnnealingWarmup:
    """Per-iteration linear warmup, then per-epoch cosine decay:

    lr = base * (it+1)/warmup                              while it < warmup
       = eta_min + (base-eta_min)*(1+cos(pi*epoch/T_max))/2   afterwards
    """
    warmup_iterations: int
    T_max: float
    eta_min: float = 0.0

    def __call__(self, base_lr, iteration, epoch):
        it, ep = _f32(iteration), _f32(epoch)
        warm = base_lr * torch.clamp(it + 1.0, max=self.warmup_iterations) \
            / self.warmup_iterations
        cos = self.eta_min + (base_lr - self.eta_min) * \
            (1.0 + torch.cos(ep * math.pi / self.T_max)) / 2.0
        return torch.where(it < self.warmup_iterations, warm, cos)


@dataclasses.dataclass(frozen=True)
class CosineAnnealingWarmupRestarts:
    """SGDR-style warm restarts with a linear warmup inside each cycle,
    indexed by epoch."""
    first_cycle_steps: int
    cycle_mult: float = 1.0
    max_lr: float = 0.1
    min_lr: float = 0.001
    warmup_steps: int = 0
    gamma: float = 1.0

    def __call__(self, base_lr, iteration, epoch):
        t = _f32(epoch)
        if self.cycle_mult == 1.0:
            cycle = torch.floor(t / self.first_cycle_steps)
            t_cur = t - cycle * self.first_cycle_steps
            cycle_steps = torch.full_like(t, self.first_cycle_steps)
        else:
            m = self.cycle_mult
            cycle = torch.floor(torch.log(
                t / self.first_cycle_steps * (m - 1) + 1) / math.log(m))
            t_cur = t - self.first_cycle_steps * (m ** cycle - 1) / (m - 1)
            cycle_steps = self.first_cycle_steps * m ** cycle
        max_lr = self.max_lr * (self.gamma ** cycle)
        warm = ((max_lr - self.min_lr) * (t_cur + 1) / self.warmup_steps
                + self.min_lr) if self.warmup_steps > 0 else max_lr
        cos = self.min_lr + (max_lr - self.min_lr) * (1 + torch.cos(
            math.pi * (t_cur - self.warmup_steps)
            / torch.clamp(cycle_steps - self.warmup_steps, min=1.0))) / 2
        return torch.where(t_cur < self.warmup_steps, warm, cos)


@dataclasses.dataclass(frozen=True)
class ReduceLROnPlateau:
    """Metric-driven decay, on the host: `update(state, metric)` once per
    epoch after validation; the loop puts `state['scale']` into
    TrainState.lr_scale. `initial_patience` epochs never reduce."""
    factor: float = 0.1
    patience: int = 10
    initial_patience: int = 0
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    mode: str = "min"
    min_lr: float = 0.0
    eps: float = 1e-8

    def init_state(self) -> dict:
        worst = math.inf if self.mode == "min" else -math.inf
        return {"best": worst, "bad_epochs": 0, "cooldown": 0,
                "scale": 1.0, "epoch": 0}

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min" and self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        if self.mode == "min":
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def update(self, state: dict, metric: float,
               base_lr: Optional[float] = None) -> dict:
        state = dict(state)
        state["epoch"] += 1
        if self._is_better(float(metric), state["best"]):
            state["best"] = float(metric)
            state["bad_epochs"] = 0
        else:
            state["bad_epochs"] += 1
        if state["epoch"] <= self.initial_patience:
            return state
        if state["cooldown"] > 0:
            state["cooldown"] -= 1
            state["bad_epochs"] = 0
        if state["bad_epochs"] > self.patience:
            # min_lr bounds the absolute LR: as a multiplier, min_lr/base_lr
            floor = self.min_lr / base_lr if base_lr else 0.0
            new_scale = max(state["scale"] * self.factor, floor)
            if state["scale"] - new_scale > self.eps:
                state["scale"] = new_scale
            state["cooldown"] = self.cooldown
            state["bad_epochs"] = 0
        return state

    def __call__(self, base_lr, iteration, epoch):
        return torch.full((), base_lr, dtype=torch.float32,
                          device=iteration.device)


def make_scheduler(name: Optional[str], kwargs: dict, max_epochs: int):
    """Scheduler by config name."""
    kw = dict(kwargs or {})
    kw.pop("warn", None)
    if name in (None, "EmptyScheduler"):
        return EmptyScheduler()
    if name == "CosineAnnealingWarmup":
        kw.setdefault("T_max", max_epochs)
        return CosineAnnealingWarmup(**kw)
    if name == "CosineAnnealingLR":
        kw.setdefault("T_max", max_epochs)
        return CosineAnnealingWarmup(warmup_iterations=0, **kw)
    if name == "CosineAnnealingWarmupRestarts":
        return CosineAnnealingWarmupRestarts(**kw)
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(**kw)
    raise ValueError(f"unknown scheduler {name}")
