"""The Avocodo GAN train step (`hilcodec_tpu/train/step_avocodo.py`).

One step: the generator forward once, keeping its graph, giving the
outputs at three scales; the discriminator's gradients from its LSGAN
loss on the detached outputs and the real PQMF targets (the discriminator
updates first); the generator's gradients through the *old*
discriminator params and the real feature maps (the same logits the
discriminator saw), of the plain weighted sum (`SimpleBalancer`) of the
mel loss, the adversarial and feature-matching losses, and weight_others
x the VQ loss. The losses are un-normalized sums over the logit and
feature-map tensors (`normalize=False`). AdamP updates both sides with
one scheduler. The JAX step runs the generator forward twice, once for
the discriminator and once inside the generator's gradient, on the same
inputs and draws: the same values, computed once here.

With a process `group`, the VQ statistics, both sides' gradients (one
bucket a side, before the clipper) and the float metrics are meaned over
the ranks, as in the JAX step's `shard_map`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..models import losses as Lo
from ..models.avocodo import AvocodoDiscriminators, pqmf_targets
from ..models.codec import CodecModel
from ..ops import rvq as Q
from ..parallel import dist as D
from ..utils.params import flatten, unflatten
from .balancer import SimpleBalancer
from .step import _with_grad, mean_metrics


class AvocodoTrainState(NamedTuple):
    params_g: Any
    params_d: Any
    vq_state: Any
    opt_g: Any
    opt_d: Any
    iteration: torch.Tensor     # int32
    epoch: torch.Tensor         # int32
    lr_scale: torch.Tensor      # ReduceLROnPlateau multiplier, f32


@dataclasses.dataclass(frozen=True)
class AvocodoCodecModel(CodecModel):
    """`CodecModel` over `AvocodoFullRate(AvocodoModel)`: `forward` and the
    offline `encode` / `decode` (the RVQ kernel) give the full-rate
    output, as the train loop's epochs and eval take it; the trainer adds
    the multi-scale forward."""

    def forward_multiscale(self, params, vq_state, wav: torch.Tensor,
                           draws: Optional[Q.RVQDraws] = None,
                           training: bool = True, group=None):
        """wav [B, 1, T] -> (the three scales' outputs, new_vq_state,
        loss_vq, num_replaces)."""
        z = self.codec.encoder.apply(params["encoder"], wav)
        q, vq_state, loss_vq, n_rep, _ = self.vq(z.float(), vq_state, draws,
                                                 training, group)
        ys = self.codec.base.decoder.apply(params["decoder"], q.to(z.dtype))
        return ys, vq_state, loss_vq, n_rep


@dataclasses.dataclass(frozen=True)
class AvocodoTrainer:
    model: AvocodoCodecModel
    disc: AvocodoDiscriminators
    mel_loss: Any
    balancer: SimpleBalancer
    optim_g: Any
    optim_d: Any
    sched_g: Any
    sched_d: Any
    lr_g: float
    lr_d: float
    pqmf_config: Dict[str, Tuple]
    use_lsgan: bool = True
    use_normalized_fm: bool = False
    clipper: Optional[Any] = None
    group: Optional[Any] = None     # data-parallel process group

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init_state(self, gen: torch.Generator) -> AvocodoTrainState:
        """Seeded state on the model's device."""
        dev = self.device
        params_g, vq_state = self.model.init(gen)
        params_d = self.disc.init(gen, dev)
        return AvocodoTrainState(
            params_g=params_g, params_d=params_d, vq_state=vq_state,
            opt_g=self.optim_g.init(params_g),
            opt_d=self.optim_d.init(params_d),
            iteration=torch.zeros((), dtype=torch.int32, device=dev),
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            lr_scale=torch.ones((), device=dev))

    def sample_draws(self, gen: torch.Generator, wav_shape) -> Q.RVQDraws:
        """The step's random draws for a batch [B, 1, T], on the device."""
        rows = wav_shape[0] * (wav_shape[-1] // self.model.hop_length)
        return self.model.vq.sample_draws(gen, rows).to(self.device)

    # -- losses (un-normalized sums) ------------------------------------------
    def _g_loss(self, logits):
        fn = Lo.generator_loss_lsgan if self.use_lsgan else Lo.generator_loss
        return fn(logits, normalize=False)

    def _fm_loss(self, fg, fr):
        fn = (Lo.feature_loss_normalized if self.use_normalized_fm
              else Lo.feature_loss)
        return fn(fg, fr, normalize=False)

    def _d_loss(self, lg, lr):
        fn = (Lo.discriminator_loss_lsgan if self.use_lsgan
              else Lo.discriminator_loss)
        return fn(lg, lr, normalize=False)

    # -- gradients --------------------------------------------------------------
    def compute_grads(self, state: AvocodoTrainState, wav_r: torch.Tensor,
                      draws: Q.RVQDraws) -> Dict[str, Any]:
        """The D and G gradients as the update takes them (clipped when a
        clipper is set) and every auxiliary output."""
        ys_r = pqmf_targets(wav_r, self.pqmf_config)
        with torch.enable_grad():
            params_g, leaves_g = _with_grad(state.params_g)
            ys_g, new_vq, loss_vq, n_rep = self.model.forward_multiscale(
                params_g, state.vq_state, wav_r, draws, training=True,
                group=self.group)

            # the discriminator first, on the detached outputs
            params_d, leaves_d = _with_grad(state.params_d)
            lg, _ = self.disc.apply(params_d, [y.detach() for y in ys_g])
            lr, _ = self.disc.apply(params_d, ys_r)
            d_loss = self._d_loss(lg, lr)
            d_list = torch.autograd.grad(d_loss, leaves_d)
            del params_d, leaves_d, lg, lr

            # the generator through the old discriminator params
            with torch.no_grad():
                _, fmaps_r = self.disc.apply(state.params_d, ys_r)
            lg, fg = self.disc.apply(state.params_d, ys_g)
            losses = dict(self.mel_loss(ys_g[-1], wav_r))
            losses.update(self._g_loss(lg))
            losses.update(self._fm_loss(fg, fmaps_r))
            g_total = self.balancer.total(losses, loss_vq)
            g_list = torch.autograd.grad(g_total, leaves_g,
                                         allow_unused=True)
        g_grads = unflatten(dict(zip(
            flatten(state.params_g),
            D.mean_leaves([torch.zeros_like(p) if g is None else g
                           for g, p in zip(g_list, leaves_g)], self.group))))
        d_grads = unflatten(dict(zip(flatten(state.params_d),
                                     D.mean_leaves(d_list, self.group))))
        if self.clipper is not None:
            g_grads = self.clipper(g_grads)
            d_grads = self.clipper(d_grads)
        return dict(g_grads=g_grads, d_grads=d_grads, d_loss=d_loss.detach(),
                    g_total=g_total.detach(),
                    losses={k: v.detach() for k, v in losses.items()},
                    loss_vq=loss_vq.detach(), new_vq_state=new_vq,
                    num_replaces=n_rep)

    # -- the step ---------------------------------------------------------------
    def train_step(self, state: AvocodoTrainState, wav_r: torch.Tensor,
                   draws: Q.RVQDraws
                   ) -> Tuple[AvocodoTrainState, Dict[str, Any]]:
        """wav_r: [B, 1, T] on the model's device. Returns (new_state,
        metrics), the metrics as 0-d (num_replaces [n_q]) device tensors."""
        return self.apply_grads(state, self.compute_grads(state, wav_r,
                                                          draws))

    def apply_grads(self, state: AvocodoTrainState, aux: Dict[str, Any]
                    ) -> Tuple[AvocodoTrainState, Dict[str, Any]]:
        """The optimizer half of train_step: D, then G."""
        with torch.no_grad():
            lr_d = self.sched_d(self.lr_d, state.iteration,
                                state.epoch) * state.lr_scale
            params_d, new_opt_d = self.optim_d.apply(
                aux["d_grads"], state.opt_d, state.params_d, lr_d)
            lr_g = self.sched_g(self.lr_g, state.iteration,
                                state.epoch) * state.lr_scale
            params_g, new_opt_g = self.optim_g.apply(
                aux["g_grads"], state.opt_g, state.params_g, lr_g)
        new_state = AvocodoTrainState(
            params_g=params_g, params_d=params_d,
            vq_state=aux["new_vq_state"], opt_g=new_opt_g, opt_d=new_opt_d,
            iteration=state.iteration + 1, epoch=state.epoch,
            lr_scale=state.lr_scale)
        metrics = {f"loss/{k}": v for k, v in aux["losses"].items()}
        metrics["loss/d"] = aux["d_loss"]
        metrics["loss/vq"] = aux["loss_vq"]
        metrics["loss/g_total"] = aux["g_total"]
        metrics["lr"] = lr_g
        metrics["finite"] = torch.ones((), device=aux["d_loss"].device)
        metrics["num_replaces"] = aux["num_replaces"]
        return new_state, mean_metrics(metrics, self.group)

    # -- evaluation ---------------------------------------------------------------
    def valid_step(self, state: AvocodoTrainState,
                   wav_r: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every loss, every quantizer stage, no update."""
        with torch.no_grad():
            ys_r = pqmf_targets(wav_r, self.pqmf_config)
            ys_g, _, loss_vq, _ = self.model.forward_multiscale(
                state.params_g, state.vq_state, wav_r, None, training=False)
            logits_g, fmaps_g = self.disc.apply(state.params_d, ys_g)
            logits_r, fmaps_r = self.disc.apply(state.params_d, ys_r)
            losses = dict(self.mel_loss(ys_g[-1], wav_r))
            losses.update(self._g_loss(logits_g))
            losses.update(self._fm_loss(fmaps_g, fmaps_r))
            losses["d"] = self._d_loss(logits_g, logits_r)
            losses["vq"] = loss_vq
        return {f"loss/{k}": v for k, v in losses.items()}
