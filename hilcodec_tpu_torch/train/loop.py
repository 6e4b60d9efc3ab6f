"""The training loop (`hilcodec_tpu/train/loop.py`), one device.

`build_trainer(hps, device)` builds the HILCodec GAN trainer from a config;
`TrainLoop` runs epochs of train steps on a DirectoriesDataset (k-means
init of the codebooks on the first batch), a validation pass when the
config has a valid filelist, the ReduceLROnPlateau host update, and
checkpoints in the JAX package's `.ckpt.npz` layout with resume from the
newest. TensorBoard summaries, parameter histograms, the infer and pesq
epochs and multi-process training are not ported yet.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device, set_f32_parity_mode
from ..data.loader import get_dataset_dataloader
from ..models.discriminators import Discriminators
from ..models.losses import MelLoss
from ..models.registry import build_codec_model
from ..utils import checkpoint as ckpt
from .balancer import Balancer
from .grad_clip import make_clipper
from .optim import make_optimizer
from .schedulers import ReduceLROnPlateau, make_scheduler
from .step import Trainer, TrainState, metrics_to_host, to_device

_NOT_PORTED = "is not ported to hilcodec_tpu_torch yet; see ROADMAP.md " \
    "(Queue 1, what is left of the training stack)"


def _plain(v):
    return v.to_dict() if hasattr(v, "to_dict") else v


def _mel_loss_from_config(hps) -> MelLoss:
    hp = hps.train
    for flag in ("hifigan_mel_loss", "mel_grad_function"):
        if hp.get(flag, False):
            raise NotImplementedError(f"train.{flag} {_NOT_PORTED}")
    return MelLoss(hps.data.sampling_rate, hps.data.get("clip_val", 1.0e-5),
                   no_zero=hp.get("no_zero_at_mel_filter", True),
                   n_mels_max=hp.get("n_mels_max", 80))


def _optim_sched_from_config(hps):
    hp = hps.train
    groups = [_plain(g) for g in hp.get("optimizer_groups", None) or []]
    kw = _plain(hp.optimizer_kwargs)
    optim_g, lr_g = make_optimizer(hp.optimizer, kw, groups or None)
    optim_d, lr_d = make_optimizer(hp.optimizer, kw, groups or None)
    if hp.get("disc_lr_ratio"):
        lr_d = lr_g * hp.disc_lr_ratio
    sched = make_scheduler(hp.get("scheduler"),
                           _plain(hp.get("scheduler_kwargs", {})),
                           hp.get("max_epochs", 1))
    clipper = (make_clipper(hp.clip_grad,
                            _plain(hp.get("clip_grad_kwargs", {})))
               if hp.get("clip_grad") else None)
    return optim_g, optim_d, lr_g, lr_d, sched, clipper


def build_trainer(hps, device=None) -> Trainer:
    """The HILCodec GAN trainer of a config on `device` (CUDA when None,
    which must then be available). `train.fbd_lowering` may name either
    JAX lowering; both are the filter-bank discriminator's one conv1d
    lowering here."""
    hp = hps.train
    lowering = hp.get("fbd_lowering", "conv2d")
    if lowering not in ("conv2d", "bands1d"):
        raise ValueError(f"unknown fbd lowering {lowering!r}")
    if hp.get("compute_dtype") not in (None, "float32", "fp32") or \
            hp.get("fp16_g", False) or hp.get("fp16", False):
        raise NotImplementedError(f"a half-precision compute_dtype "
                                  f"{_NOT_PORTED}")
    if hp.get("remat", "none") != "none":
        raise NotImplementedError(f"train.remat {_NOT_PORTED}")
    if hp.get("fam_mode", "separate") not in ("separate", "vmap", "joint"):
        raise ValueError(f"unknown fam_mode {hp.fam_mode!r}")
    if hp.get("depthwise_lowering", "conv") != "conv":
        raise NotImplementedError(f"train.depthwise_lowering {_NOT_PORTED}")
    name = hps.get("model", "hilcodec")
    if name != "hilcodec" or hp.get("trainer", None) not in (None,
                                                             "hilcodec"):
        raise NotImplementedError(f"training model {name!r} {_NOT_PORTED}")
    model = build_codec_model(name, _plain(hps.model_kwargs),
                              device=resolve_device(device))
    disc = Discriminators(**{k: _plain(v)
                             for k, v in hps.disc_kwargs.items()})
    optim_g, optim_d, lr_g, lr_d, sched, clipper = \
        _optim_sched_from_config(hps)
    return Trainer(
        model=model, disc=disc, mel_loss=_mel_loss_from_config(hps),
        balancer=Balancer.from_config(_plain(hp.balancer_kwargs)),
        optim_g=optim_g, optim_d=optim_d, sched_g=sched, sched_d=sched,
        lr_g=lr_g, lr_d=lr_d, use_lsgan=hp.get("use_lsgan", False),
        use_normalized_fm=hp.get("use_normalized_fm_loss", True),
        lookahead=hp.get("lookahead", 0),
        disc_update_ratio=tuple(hp.get("disc_update_ratio", None)
                                or (1, 1)),
        clipper=clipper)


def step_generator(seed: int, iteration: int) -> torch.Generator:
    """The generator of one step's draws, keyed by (seed, iteration), so a
    resumed run draws what an uninterrupted one would."""
    s = int(np.random.SeedSequence([seed, iteration]).generate_state(1)[0])
    return torch.Generator().manual_seed(s)


class TrainLoop:
    def __init__(self, hps, run_dir: Optional[str] = None, device=None):
        self.hps = hps
        self.run_dir = run_dir or hps.get("model_dir", "logs/run")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_parity_mode()
        self.trainer = build_trainer(hps, self.device)
        self.seed = hps.train.get("seed", 1)
        self.epoch = 0
        self.iteration = 0          # host copy of state.iteration
        self.state: Optional[TrainState] = None
        self.train_ds, self.train_loader = get_dataset_dataloader(
            hps, "train", ["wav"])
        try:
            self.valid_ds, self.valid_loader = get_dataset_dataloader(
                hps, "valid", ["wav"])
        except (FileNotFoundError, KeyError, AttributeError):
            self.valid_ds = self.valid_loader = None
        sched = self.trainer.sched_g
        self.plateau = sched if isinstance(sched, ReduceLROnPlateau) \
            else None
        self.plateau_state = self.plateau.init_state() if self.plateau \
            else None
        self.scheduler_metric = hps.train.get("scheduler_metric",
                                              "loss/freq")

    # -- state ----------------------------------------------------------------
    def init_or_resume(self) -> None:
        self.state = self.trainer.init_state(
            torch.Generator().manual_seed(self.seed))
        latest = ckpt.latest_checkpoint(self.run_dir)
        if latest is None:
            return
        epoch, path = latest
        self.state, extras = ckpt.load_checkpoint(path, self.state)
        self.epoch = int(extras.get("epoch", epoch))
        self.iteration = int(self.state.iteration)
        if self.plateau_state is not None:
            for k in list(self.plateau_state):
                if f"plateau_{k}" in extras:
                    self.plateau_state[k] = type(self.plateau_state[k])(
                        extras[f"plateau_{k}"].item())
        print(f"resumed from {path} (epoch {self.epoch}, iteration "
              f"{self.iteration})")

    def save(self) -> str:
        extra: Dict[str, Any] = {"epoch": self.epoch}
        for k, v in (self.plateau_state or {}).items():
            extra[f"plateau_{k}"] = v
        return ckpt.save_checkpoint(self.run_dir, self.epoch, self.state,
                                    extra)

    def initialize_vq(self, wav: np.ndarray) -> None:
        """k-means init of the codebooks on the first batch's latents."""
        vq = self.trainer.model.vq
        if not vq.kmeans_init or bool(self.state.vq_state["initted"]):
            return
        with torch.no_grad():
            z = self.trainer.model.codec.encoder.apply(
                self.state.params_g["encoder"], to_device(wav, self.device))
        init_idx = vq.kmeans_init_indices(
            torch.Generator().manual_seed(self.seed + 7),
            z.shape[0] * z.shape[-1])
        self.state = self.state._replace(
            vq_state=vq.kmeans_init_state(self.state.vq_state, z, init_idx))

    # -- epochs ---------------------------------------------------------------
    @staticmethod
    def _batch_wav(batch: Dict[str, Any]) -> np.ndarray:
        wav = batch["wav"]
        return wav[:, None, :] if wav.ndim == 2 else wav

    def train_epoch(self) -> Dict[str, float]:
        """One pass of the train loader; the metrics of each step are read
        to the host in one copy, in groups of up to 10 steps."""
        t0 = time.time()
        sums: Dict[str, float] = {}
        counts: Dict[str, float] = {}
        replaces = None
        pending: List[Any] = []
        n_steps = len(self.train_loader)
        last: Dict[str, Any] = {}

        def flush():
            nonlocal replaces, last
            for bsz, mt in pending:
                last = metrics_to_host(mt)
                for k, v in last.items():
                    # skipped D steps report loss/d as NaN: each key is
                    # averaged over the steps that produced it
                    if k.startswith("loss/") and math.isfinite(v):
                        sums[k] = sums.get(k, 0.0) + v * bsz
                        counts[k] = counts.get(k, 0.0) + bsz
                rep = last["num_replaces"]
                replaces = rep if replaces is None else replaces + rep
            pending.clear()

        for idx, batch in enumerate(self.train_loader, start=1):
            wav = self._batch_wav(batch)
            if idx == 1:
                self.initialize_vq(wav)
            draws = self.trainer.sample_draws(
                step_generator(self.seed, self.iteration), wav.shape)
            self.state, m = self.trainer.train_step(
                self.state, to_device(wav, self.device), draws)
            self.iteration += 1
            pending.append((wav.shape[0], m))
            if idx % 10 == 0 or idx == n_steps:
                flush()
                line = f"Epoch {self.epoch} - Train {idx}/{n_steps}"
                for k, v in sums.items():
                    line += f"  {k.split('/')[1]}: {v / counts[k]:.3f}"
                print(line + f"  lr: {last['lr']:.2e}", flush=True)
        flush()
        scalars = {k: v / max(counts[k], 1) for k, v in sums.items()}
        scalars["lr"] = last.get("lr", 0.0)
        scalars["epoch_time"] = time.time() - t0
        for i, r in enumerate(replaces if replaces is not None else []):
            scalars[f"n_replaces/{i}"] = float(r)
        # the per-epoch scheduler clock
        self.state = self.state._replace(epoch=self.state.epoch + 1)
        return scalars

    def valid_epoch(self) -> Dict[str, float]:
        if self.valid_loader is None:
            return {}
        sums: Dict[str, float] = {}
        n_items = 0
        for batch in self.valid_loader:
            wav = self._batch_wav(batch)
            losses = metrics_to_host(self.trainer.valid_step(
                self.state, to_device(wav, self.device)))
            n_items += wav.shape[0]
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v * wav.shape[0]
        return {k: v / max(n_items, 1) for k, v in sums.items()}

    def run(self, max_epochs: Optional[int] = None) -> None:
        max_epochs = max_epochs or self.hps.train.max_epochs
        if self.state is None:
            self.init_or_resume()
        save_interval = self.hps.train.get("save_interval", 1)
        while self.epoch < max_epochs:
            self.epoch += 1
            if hasattr(self.train_ds, "shuffle"):
                self.train_ds.shuffle(self.seed + self.epoch)
            scalars = self.train_epoch()
            print(f"Epoch {self.epoch} train: " + ", ".join(
                f"{k} {v:.4g}" for k, v in scalars.items()), flush=True)
            valid = self.valid_epoch()
            if valid:
                print(f"Epoch {self.epoch} valid: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in valid.items()), flush=True)
            if self.plateau is not None:
                metric = valid.get(self.scheduler_metric,
                                   scalars.get(self.scheduler_metric))
                if metric is not None:
                    self.plateau_state = self.plateau.update(
                        self.plateau_state, metric,
                        base_lr=self.trainer.lr_g)
                    self.state = self.state._replace(lr_scale=torch.full(
                        (), self.plateau_state["scale"],
                        device=self.device))
            if self.epoch % save_interval == 0:
                print(f"saved {self.save()}", flush=True)
