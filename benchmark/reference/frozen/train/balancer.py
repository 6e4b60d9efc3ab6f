"""Gradient-norm loss balancer (`hilcodec_tpu/train/balancer.py`).

Each loss's gradient with respect to the generated waveform is normalized
by an EMA of its norm and re-weighted; the train step feeds the combined
gradient (plus `weight_others` for loss_vq) into one backward pass of the
generator. A non-finite EMA skips the generator update.

State: ema_norms [K] f32 (EMA of the per-loss gradient norms) and ema_fix
[] f32 (bias-correction accumulator).

`SimpleBalancer` is Avocodo's: a plain weighted sum of the losses, whose
total the Avocodo step differentiates directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from ..parallel import dist as D

BalancerState = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Balancer:
    """weights: ordered (key, weight); weight_others scales the extra
    differentiable scalar (loss_vq) fed through the same backward pass."""
    weights: Tuple[Tuple[str, float], ...]
    weight_others: float = 0.01
    ema_decay: float = 0.999
    per_batch_item: bool = True
    epsilon: float = 1e-12

    @classmethod
    def from_config(cls, balancer_kwargs: Dict[str, Any]) -> "Balancer":
        kw = dict(balancer_kwargs)
        return cls(weights=tuple(kw.pop("weights").items()), **kw)

    @property
    def keys(self) -> List[str]:
        return [k for k, _ in self.weights]

    def init_state(self, device="cpu") -> BalancerState:
        return {"ema_norms": torch.zeros(len(self.weights), device=device),
                "ema_fix": torch.zeros((), device=device)}

    def combine(self, grads: Dict[str, torch.Tensor], state: BalancerState,
                group=None) -> Tuple[torch.Tensor, BalancerState,
                                     torch.Tensor, Dict[str, torch.Tensor]]:
        """grads: per-loss gradient with respect to wav_g (each [B, 1, T]).

        Returns (combined gradient, new_state, finite flag, debiased EMA
        norms by `ema_norm/{key}`). On non-finite norms the state is kept
        and the combined gradient is zero. With a process group the norms
        stay each rank's own and the updated EMA is meaned over the ranks
        (JAX's pmean of it)."""
        norms = []
        for key in self.keys:
            g = grads[key].float()
            if self.per_batch_item:
                norms.append(torch.mean(torch.sqrt(torch.sum(
                    torch.square(g.reshape(g.shape[0], -1)), dim=1))))
            else:
                norms.append(torch.sqrt(torch.sum(torch.square(g))))
        norms = torch.stack(norms)
        d = self.ema_decay
        ema = D.mean(d * state["ema_norms"] + (1.0 - d) * norms, group)
        ema_fix = state["ema_fix"] * d + (1.0 - d)

        finite = torch.all(torch.isfinite(ema))
        safe_ema = torch.where(torch.isfinite(ema), ema, state["ema_norms"])
        new_state = {
            "ema_norms": torch.where(finite, ema, state["ema_norms"]),
            "ema_fix": torch.where(finite, ema_fix, state["ema_fix"])}
        debiased = safe_ema / torch.clamp(ema_fix, min=1e-30)
        recip = 1.0 / (debiased + self.epsilon)
        out = torch.zeros_like(grads[self.keys[0]], dtype=torch.float32)
        for i, (key, w) in enumerate(self.weights):
            out = out + (w * recip[i]) * grads[key].float()
        out = torch.where(finite, out, torch.zeros_like(out))
        logs = {f"ema_norm/{k}": debiased[i]
                for i, k in enumerate(self.keys)}
        return out, new_state, finite, logs


@dataclasses.dataclass(frozen=True)
class SimpleBalancer:
    """A weighted sum of the losses plus weight_others x the VQ loss; no
    gradient rescaling (a config's `ema_decay` is dropped)."""
    weights: Tuple[Tuple[str, float], ...]
    weight_others: float = 1.0

    @classmethod
    def from_config(cls, balancer_kwargs: Dict[str, Any]
                    ) -> "SimpleBalancer":
        kw = dict(balancer_kwargs)
        return cls(weights=tuple(kw.pop("weights").items()),
                   weight_others=kw.get("weight_others", 1.0))

    def total(self, losses: Dict[str, torch.Tensor],
              others: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((), device=others.device)
        for k, w in self.weights:
            out = out + w * losses[k].float()
        return out + self.weight_others * others
