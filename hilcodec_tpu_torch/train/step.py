"""The GAN train step (`hilcodec_tpu/train/step.py`).

One step: the generator forward keeps its graph; each loss family's
gradient with respect to the generated waveform comes from
`torch.autograd.grad` on a detached copy of it (the mel loss, then per
discriminator family its adversarial and feature-matching losses with the
discriminator's params and the real feature maps detached); the balancer
combines them, and one backward pass of the generator takes the combined
gradient for wav_g and `weight_others` for loss_vq. The discriminator's
gradients come from a separate forward of its loss on the detached
generated and the real waveform. The optimizers update both sides
(`apply`; on the card AdamP is one multi-leaf kernel a side); the
generator update is masked by the balancer's finite flag and the
discriminator's by `do_d` (update ratio and its own non-finite guard), on
the device; then every spectral-norm `{v, u}` pair of the
discriminators takes one power iteration. Nothing in the step reads a
value back to the host.

`compute_dtype` bfloat16 is JAX's mixed precision: every floating leaf of
both param trees and the input waveform are cast inside the graph (the
gradients reach the f32 masters through the casts); the quantizer runs on
f32 latents, wav_g, the mel loss and the balancer are f32, the
discriminators' logits and feature maps go back to f32 before the losses,
and the optimizer, VQ and balancer states stay f32. `remat` selects
`torch.utils.checkpoint` (non-reentrant) around the generator forward
(`gen`), the mel loss (`mel`), each family's G-side losses and the D-loss
forward (`disc`), or all (`all`), comma-separable: the same values, the
forwards run again in the backward (the generator's, and with it the RVQ
kernel, once more a step).

Data parallelism: with a process `group` (`parallel/dist.py`) each rank
steps on its own rows of the batch from the same state and the same
draws, and the step has a collective at each site of the JAX step's
`shard_map`: the VQ statistics and expiry candidates, the balancer's EMA
(the per-loss norms stay each rank's), the G and D gradients meaned in
f32 as one bucket a side before the D finite guard and the clipper (so
that a NaN on any rank gates every rank), and the float metrics meaned
after the update (`num_replaces`, identical on every rank, is not).

The JAX package's `fam_mode` "vmap" and "joint" restructure the same
values for XLA; here every mode is this "separate" plumbing (build_trainer
accepts the three names). With `disc_update_ratio` r1 > 1 the
discriminator's gradients are computed on every step and masked, where JAX
skips the computation under `lax.cond`: the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models import losses as Lo
from ..models.codec import CodecModel
from ..models.discriminators import Discriminators
from ..ops import reparam as R
from ..ops.rvq import RVQDraws
from ..parallel import dist as D
from ..utils.params import flatten, tree_map, unflatten
from ..utils.spans import span
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
    compute_dtype: torch.dtype = torch.float32
    remat: str = "none"
    group: Optional[Any] = None     # data-parallel process group

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _want_remat(self, which: str) -> bool:
        sel = {s.strip() for s in self.remat.split(",")}
        return "all" in sel or which in sel

    def _run(self, which: str, fn, *args):
        """fn(*args), under torch.utils.checkpoint when `which` is
        selected by `remat`."""
        if self._want_remat(which):
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _cast(self, tree):
        """Every floating leaf of `tree` in the compute dtype."""
        if self.compute_dtype == torch.float32:
            return tree
        cd = self.compute_dtype
        return tree_map(lambda x: x.to(cd) if x.is_floating_point() else x,
                        tree)

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
        with span("train.draws"):
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
        the optimizers take and every auxiliary output. Its spans
        (`utils/spans.py`) tile it: every statement lies in one `train.*`
        part."""
        with torch.enable_grad():
            with span("train.generator"):
                la = self.lookahead
                cast = self._cast
                params_g, leaves_g = _with_grad(state.params_g)
                wav_g, new_vq, loss_vq, num_replaces = self._run(
                    "gen", lambda: self.model.forward(
                        cast(params_g), state.vq_state, cast(wav_r), draws,
                        training=True, group=self.group))
                wav_r_in = wav_r[:, :, :-la] if la > 0 else wav_r
                w = (wav_g[:, :, la:] if la > 0 else wav_g).detach()
                w.requires_grad_(True)

            with span("train.mel"):
                losses: Dict[str, torch.Tensor] = {}
                grads: Dict[str, torch.Tensor] = {}
                mel = self._run(
                    "mel", lambda w: self.mel_loss(w, wav_r_in)["freq"], w)
                losses["freq"] = mel.detach()
                grads["freq"] = torch.autograd.grad(mel, w)[0]

            with span("train.real_fmaps"):
                params_d_c = cast(state.params_d)
                with torch.no_grad():
                    _, fmaps_r = self.disc.apply(params_d_c, cast(wav_r_in))
                    fmaps_r = _f32(fmaps_r)
            for name, d in self.disc.discs.items():
                with span(f"train.family.{name}"):
                    def fam(w, d=d, name=name):
                        lg, fg = d.apply(params_d_c[name], cast(w))
                        g_l = self._g_loss_fn({name: _f32(lg)})[f"{name}_g"]
                        fm_l = self._fm_loss_fn(
                            {name: _f32(fg)},
                            {name: fmaps_r[name]})[f"{name}_fm"]
                        return g_l, fm_l
                    g_l, fm_l = self._run("disc", fam, w)
                    losses[f"{name}_g"] = g_l.detach()
                    losses[f"{name}_fm"] = fm_l.detach()
                    grads[f"{name}_g"] = torch.autograd.grad(
                        g_l, w, retain_graph=True)[0]
                    grads[f"{name}_fm"] = torch.autograd.grad(fm_l, w)[0]
            with span("train.balancer"):
                del fmaps_r, params_d_c
                out_grad, new_bal, finite, ema_logs = self.balancer.combine(
                    grads, state.balancer, group=self.group)
                if la > 0:
                    out_grad = torch.nn.functional.pad(out_grad, (0, la))
            with span("train.generator_backward"):
                outs, grad_outs = [wav_g], [out_grad.to(wav_g.dtype)]
                if loss_vq.requires_grad:   # `vq: ''` has a constant zero
                    outs.append(loss_vq)
                    grad_outs.append(torch.full(
                        (), self.balancer.weight_others,
                        device=wav_g.device))
                g_list = torch.autograd.grad(outs, leaves_g,
                                             grad_outputs=grad_outs,
                                             allow_unused=True)
                g_grads = unflatten(dict(zip(
                    flatten(state.params_g),
                    D.mean_leaves(_zeros_for_none(g_list, leaves_g),
                                  self.group))))
                wav_sg = w.detach()
                del wav_g, params_g, leaves_g, w, grads

        with span("train.discriminator"):
            # the discriminator's loss on the detached generated waveform;
            # a spectral-norm `u` takes no gradient: zeros, as in JAX
            with torch.enable_grad():
                params_d, leaves_d = _with_grad(state.params_d)

                def d_fn():
                    p_c = cast(params_d)
                    logits_g, _ = self.disc.apply(p_c, cast(wav_sg))
                    logits_r, _ = self.disc.apply(p_c, cast(wav_r_in))
                    return self._d_loss_fn(_f32(logits_g), _f32(logits_r))
                d_loss = self._run("disc", d_fn)
                d_list = _zeros_for_none(
                    torch.autograd.grad(d_loss, leaves_d, allow_unused=True),
                    leaves_d)
            d_loss = d_loss.detach()

            r0, r1 = self.disc_update_ratio
            if r1 > 1:
                # update D when (iteration + 1) % r1 < r0
                do_d = ((state.iteration + 1) % r1) < r0
                d_loss = torch.where(do_d, d_loss, torch.zeros_like(d_loss))
                d_list = [torch.where(do_d, g, 0.0) for g in d_list]
            else:
                do_d = torch.ones((), dtype=torch.bool, device=d_loss.device)
            d_list = D.mean_leaves(d_list, self.group)
            d_grads = unflatten(dict(zip(flatten(state.params_d), d_list)))
            # a NaN/Inf in d_loss or any (meaned) D gradient skips the D
            # update
            d_finite = torch.stack([torch.isfinite(d_loss)]
                                   + [torch.isfinite(g).all()
                                      for g in d_list])
            do_d = do_d & d_finite.all()

        with span("train.clip"):
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
        """The optimizer half of train_step on compute_grads' output,
        tiled by its spans as compute_grads is."""
        with span("train.optim_g"), torch.no_grad():
            finite, do_d = aux["finite"], aux["do_d"]
            lr_g = self.sched_g(self.lr_g, state.iteration,
                                state.epoch) * state.lr_scale
            params_g, new_opt_g = self.optim_g.apply(
                aux["g_grads"], state.opt_g, state.params_g, lr_g, finite)
        with span("train.optim_d"), torch.no_grad():
            lr_d = self.sched_d(self.lr_d, state.iteration,
                                state.epoch) * state.lr_scale
            params_d, new_opt_d = self.optim_d.apply(
                aux["d_grads"], state.opt_d, state.params_d, lr_d, do_d)
        with span("train.spectral_norm"), torch.no_grad():
            params_d = spectral_norm_power_iteration(params_d)
        with span("train.metrics"):
            # the VQ codebooks advance whatever the balancer decided
            # (their EMA statistics take no gradient)
            new_state = TrainState(
                params_g=params_g, params_d=params_d,
                vq_state=aux["new_vq_state"], opt_g=new_opt_g,
                opt_d=new_opt_d, balancer=aux["new_bal"],
                iteration=state.iteration + 1, epoch=state.epoch,
                lr_scale=state.lr_scale)

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
            return new_state, mean_metrics(metrics, self.group)

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


def mean_metrics(metrics: Dict[str, torch.Tensor], group
                 ) -> Dict[str, torch.Tensor]:
    """A step's floating metrics meaned over the group's ranks in one
    bucket; the integer ones (num_replaces) as they are."""
    if group is None:
        return metrics
    keys = [k for k, v in metrics.items() if v.is_floating_point()]
    vals = D.mean(torch.stack([metrics[k].float() for k in keys]), group)
    return dict(metrics, **dict(zip(keys, vals.unbind(0))))


def _f32(tree):
    return tree_map(lambda x: x.float(), tree)


def _zeros_for_none(grads, leaves):
    """autograd.grad's None (a leaf the loss does not reach) as zeros."""
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)]


def spectral_norm_power_iteration(params: Any) -> Any:
    """Every spectral-norm `{v, u}` pair of a param tree with u advanced
    by one power iteration."""
    if isinstance(params, dict):
        if "u" in params and "v" in params:
            return dict(params, u=R.spectral_norm_power_iter(params["v"],
                                                             params["u"]))
        return {k: spectral_norm_power_iteration(v)
                for k, v in params.items()}
    if isinstance(params, list):
        return [spectral_norm_power_iteration(v) for v in params]
    return params


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """One device-to-host copy of a step's metrics: floats, and
    num_replaces as an int array."""
    keys = [k for k in metrics if k != "num_replaces"]
    vals = torch.stack([metrics[k].float() for k in keys]).cpu().numpy()
    out: Dict[str, Any] = dict(zip(keys, vals.tolist()))
    if "num_replaces" in metrics:
        out["num_replaces"] = np.asarray(metrics["num_replaces"].cpu())
    return out
