"""The GAN train step (`hilcodec_tpu/train/step.py`), on one device.

One step: the generator forward keeps its graph; each loss family's
gradient with respect to the generated waveform comes from
`torch.autograd.grad` on a detached copy of it (the mel loss, then per
discriminator family its adversarial and feature-matching losses with the
discriminator's params and the real feature maps detached); the balancer
combines them, and one backward pass of the generator takes the combined
gradient for wav_g and `weight_others` for loss_vq. The discriminator's
gradients come from a separate forward of its loss on the detached
generated and the real waveform. AdamP updates both sides; the generator
update is masked by the balancer's finite flag and the discriminator's by
`do_d` (update ratio and its own non-finite guard), as selects on the
device. Nothing in the step reads a value back to the host.

The JAX package's `fam_mode` "vmap" and "joint" restructure the same
values for XLA; here every mode is this "separate" plumbing (build_trainer
accepts the three names). Its `remat` (rematerialization, later
`torch.utils.checkpoint`) and a bf16 `compute_dtype` are not ported yet:
build_trainer raises for them. With `disc_update_ratio`
r1 > 1 the discriminator's gradients are computed on every step and masked,
where JAX skips the computation under `lax.cond`: the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import losses as Lo
from ..models.codec import CodecModel
from ..models.discriminators import Discriminators
from ..ops.rvq import RVQDraws
from ..utils.params import flatten, tree_map, unflatten
from .balancer import Balancer


class TrainState(NamedTuple):
    params_g: Any
    params_d: Any
    vq_state: Any
    opt_g: Any
    opt_d: Any
    balancer: Any
    iteration: torch.Tensor     # global step counter, int32
    epoch: torch.Tensor         # int32
    lr_scale: torch.Tensor      # ReduceLROnPlateau multiplier, f32


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array or tensor on `device`, through pinned memory without
    waiting for the device when that is a card."""
    t = torch.as_tensor(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _with_grad(tree):
    """(tree of fresh leaves that require grad, their list in flatten
    order)."""
    flat = {k: v.detach().requires_grad_(True)
            for k, v in flatten(tree).items()}
    return unflatten(flat), list(flat.values())


@dataclasses.dataclass(frozen=True)
class Trainer:
    """Model, discriminators, losses, balancer and optimizers as one step
    function."""
    model: CodecModel
    disc: Discriminators
    mel_loss: Any
    balancer: Balancer
    optim_g: Any
    optim_d: Any
    sched_g: Any
    sched_d: Any
    lr_g: float
    lr_d: float
    use_lsgan: bool = False
    use_normalized_fm: bool = True
    lookahead: int = 0
    disc_update_ratio: Tuple[int, int] = (1, 1)
    clipper: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    # -- state ----------------------------------------------------------------
    def init_state(self, gen: torch.Generator) -> TrainState:
        """Seeded state on the model's device."""
        dev = self.device
        params_g, vq_state = self.model.init(gen)
        params_d = self.disc.init(gen, dev)
        return TrainState(
            params_g=params_g, params_d=params_d, vq_state=vq_state,
            opt_g=self.optim_g.init(params_g),
            opt_d=self.optim_d.init(params_d),
            balancer=self.balancer.init_state(dev),
            iteration=torch.zeros((), dtype=torch.int32, device=dev),
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            lr_scale=torch.ones((), device=dev))

    def sample_draws(self, gen: torch.Generator, wav_shape):
        """The step's random draws for a batch of shape [B, 1, T], on the
        model's device: the quantizer's (`RVQDraws`: the dropout depth and
        the expiry candidate rows; `ShapeGainDraws` for shape-gain)."""
        rows = wav_shape[0] * (wav_shape[-1] // self.model.hop_length)
        return self.model.vq.sample_draws(gen, rows).to(self.device)

    # -- loss plumbing --------------------------------------------------------
    def _g_loss_fn(self, logits):
        return (Lo.generator_loss_lsgan(logits) if self.use_lsgan
                else Lo.generator_loss(logits))

    def _fm_loss_fn(self, fg, fr):
        return (Lo.feature_loss_normalized(fg, fr)
                if self.use_normalized_fm else Lo.feature_loss(fg, fr))

    def _d_loss_fn(self, lg, lr):
        return (Lo.discriminator_loss_lsgan(lg, lr) if self.use_lsgan
                else Lo.discriminator_loss(lg, lr))

    # -- gradients ------------------------------------------------------------
    def compute_grads(self, state: TrainState, wav_r: torch.Tensor,
                      draws: RVQDraws) -> Dict[str, Any]:
        """Forward, balancer and both backward passes: the (clipped) grads
        the optimizers take and every auxiliary output."""
        la = self.lookahead
        with torch.enable_grad():
            params_g, leaves_g = _with_grad(state.params_g)
            wav_g, new_vq, loss_vq, num_replaces = self.model.forward(
                params_g, state.vq_state, wav_r, draws, training=True)
            wav_r_in = wav_r[:, :, :-la] if la > 0 else wav_r
            w = (wav_g[:, :, la:] if la > 0 else wav_g).detach()
            w.requires_grad_(True)

            losses: Dict[str, torch.Tensor] = {}
            grads: Dict[str, torch.Tensor] = {}
            mel = self.mel_loss(w, wav_r_in)["freq"]
            losses["freq"] = mel.detach()
            grads["freq"] = torch.autograd.grad(mel, w)[0]

            with torch.no_grad():
                _, fmaps_r = self.disc.apply(state.params_d, wav_r_in)
            for name, d in self.disc.discs.items():
                lg, fg = d.apply(state.params_d[name], w)
                g_l = self._g_loss_fn({name: lg})[f"{name}_g"]
                fm_l = self._fm_loss_fn(
                    {name: fg}, {name: fmaps_r[name]})[f"{name}_fm"]
                losses[f"{name}_g"] = g_l.detach()
                losses[f"{name}_fm"] = fm_l.detach()
                grads[f"{name}_g"] = torch.autograd.grad(
                    g_l, w, retain_graph=True)[0]
                grads[f"{name}_fm"] = torch.autograd.grad(fm_l, w)[0]
            del fmaps_r

            out_grad, new_bal, finite, ema_logs = self.balancer.combine(
                grads, state.balancer)
            if la > 0:
                out_grad = torch.nn.functional.pad(out_grad, (0, la))
            outs, grad_outs = [wav_g], [out_grad.to(wav_g.dtype)]
            if loss_vq.requires_grad:       # `vq: ''` has a constant zero
                outs.append(loss_vq)
                grad_outs.append(torch.full((), self.balancer.weight_others,
                                            device=wav_g.device))
            g_list = torch.autograd.grad(outs, leaves_g,
                                         grad_outputs=grad_outs,
                                         allow_unused=True)
            g_grads = unflatten(dict(zip(
                flatten(state.params_g),
                [torch.zeros_like(p) if g is None else g
                 for g, p in zip(g_list, leaves_g)])))
            wav_sg = w.detach()
            del wav_g, params_g, leaves_g, w, grads

            # the discriminator's loss on the detached generated waveform
            params_d, leaves_d = _with_grad(state.params_d)
            logits_g, _ = self.disc.apply(params_d, wav_sg)
            logits_r, _ = self.disc.apply(params_d, wav_r_in)
            d_loss = self._d_loss_fn(logits_g, logits_r)
            d_list = torch.autograd.grad(d_loss, leaves_d)
        d_loss = d_loss.detach()
        d_grads = unflatten(dict(zip(flatten(state.params_d), d_list)))

        r0, r1 = self.disc_update_ratio
        if r1 > 1:
            # update D when (iteration + 1) % r1 < r0
            do_d = ((state.iteration + 1) % r1) < r0
            d_loss = torch.where(do_d, d_loss, torch.zeros_like(d_loss))
            d_grads = tree_map(lambda g: torch.where(do_d, g, 0.0), d_grads)
        else:
            do_d = torch.ones((), dtype=torch.bool, device=d_loss.device)
        # a NaN/Inf in d_loss or any D gradient skips the D update
        d_finite = torch.stack([torch.isfinite(d_loss)]
                               + [torch.isfinite(g).all() for g in d_list])
        do_d = do_d & d_finite.all()

        if self.clipper is not None:
            g_grads = self.clipper(g_grads)
            d_grads = self.clipper(d_grads)
        return dict(g_grads=g_grads, d_grads=d_grads, d_loss=d_loss,
                    do_d=do_d, losses=losses, loss_vq=loss_vq.detach(),
                    new_vq_state=new_vq, num_replaces=num_replaces,
                    finite=finite, new_bal=new_bal, ema_logs=ema_logs)

    # -- the step -------------------------------------------------------------
    def train_step(self, state: TrainState, wav_r: torch.Tensor,
                   draws: RVQDraws) -> Tuple[TrainState, Dict[str, Any]]:
        """wav_r: [B, 1, T] on the model's device. Returns (new_state,
        metrics), the metrics as 0-d (num_replaces [n_q]) device tensors."""
        return self.apply_grads(state, self.compute_grads(state, wav_r,
                                                          draws))

    def apply_grads(self, state: TrainState, aux: Dict[str, Any]
                    ) -> Tuple[TrainState, Dict[str, Any]]:
        """The optimizer half of train_step on compute_grads' output."""
        finite, do_d = aux["finite"], aux["do_d"]
        with torch.no_grad():
            lr_g = self.sched_g(self.lr_g, state.iteration,
                                state.epoch) * state.lr_scale
            upd_g, new_opt_g = self.optim_g.update(
                aux["g_grads"], state.opt_g, state.params_g, lr_g)
            params_g = tree_map(lambda p, u: torch.where(finite, p + u, p),
                                state.params_g, upd_g)
            new_opt_g = tree_map(lambda new, old: torch.where(finite, new,
                                                              old),
                                 new_opt_g, state.opt_g)
            lr_d = self.sched_d(self.lr_d, state.iteration,
                                state.epoch) * state.lr_scale
            upd_d, new_opt_d = self.optim_d.update(
                aux["d_grads"], state.opt_d, state.params_d, lr_d)
            params_d = tree_map(lambda p, u: torch.where(do_d, p + u, p),
                                state.params_d, upd_d)
            new_opt_d = tree_map(lambda new, old: torch.where(do_d, new,
                                                              old),
                                 new_opt_d, state.opt_d)
        # the VQ codebooks advance whatever the balancer decided (their
        # EMA statistics take no gradient)
        new_state = TrainState(
            params_g=params_g, params_d=params_d,
            vq_state=aux["new_vq_state"], opt_g=new_opt_g, opt_d=new_opt_d,
            balancer=aux["new_bal"], iteration=state.iteration + 1,
            epoch=state.epoch, lr_scale=state.lr_scale)

        metrics = {"loss/" + k: v for k, v in aux["losses"].items()}
        metrics["loss/vq"] = aux["loss_vq"]
        # NaN on skipped D steps, so epoch means cover update steps only
        metrics["loss/d"] = torch.where(do_d, aux["d_loss"],
                                        torch.full_like(aux["d_loss"],
                                                        float("nan")))
        metrics["lr"] = lr_g
        metrics["finite"] = finite.float()
        metrics["num_replaces"] = aux["num_replaces"]
        metrics.update(aux["ema_logs"])
        return new_state, metrics

    # -- evaluation -----------------------------------------------------------
    def valid_step(self, state: TrainState,
                   wav_r: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every loss, every quantizer stage, no update."""
        with torch.no_grad():
            wav_g, _, loss_vq, _ = self.model.forward(
                state.params_g, state.vq_state, wav_r, None, training=False)
            logits_g, fmaps_g = self.disc.apply(state.params_d, wav_g)
            logits_r, fmaps_r = self.disc.apply(state.params_d, wav_r)
            losses = dict(self.mel_loss(wav_g, wav_r))
            losses.update(self._g_loss_fn(logits_g))
            losses.update(self._fm_loss_fn(fmaps_g, fmaps_r))
            losses["d"] = self._d_loss_fn(logits_g, logits_r)
            losses["vq"] = loss_vq
        return {f"loss/{k}": v for k, v in losses.items()}


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """One device-to-host copy of a step's metrics: floats, and
    num_replaces as an int array."""
    keys = [k for k in metrics if k != "num_replaces"]
    vals = torch.stack([metrics[k].float() for k in keys]).cpu().numpy()
    out: Dict[str, Any] = dict(zip(keys, vals.tolist()))
    if "num_replaces" in metrics:
        out["num_replaces"] = np.asarray(metrics["num_replaces"].cpu())
    return out
