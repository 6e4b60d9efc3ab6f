"""The training loop (`hilcodec_tpu/train/loop.py`).

`build_trainer(hps, device)` builds the GAN trainer of a config: one
balancer trainer for HILCodec and EnCodec (and the Avocodo generator under
`train.trainer: hilcodec`), Avocodo's own trainer
(`train/step_avocodo.py`) for `model: avocodo`, as in the JAX package;
`TrainLoop` runs epochs in the JAX loop's order: the train steps on a
DirectoriesDataset (k-means init of the codebooks on the first batch;
with `train.plot_param_and_grad`, parameter and gradient histograms of the
epoch's last batch), a validation pass when the config has a valid
filelist, the ReduceLROnPlateau host update, every `pesq.interval` epochs
the objective metrics of the pesq filelist (`metric/{name}`), every
`infer.interval` epochs the infer filelist's reconstructions at
`train.infer_n` quantizers (audio and log-mel images), and checkpoints in
the JAX package's `.ckpt.npz` layout with resume from the newest.

Summaries go to TensorBoard under `{run_dir}/train` and `{run_dir}/valid`.
Where `tensorboard` (every summary) or `matplotlib` (the images) is not
installed, the loop names in one line at start what it will not write,
and trains on.

Data parallelism: under an initialized process group (`python -m
torch.distributed.run`, `parallel/dist.init_from_env`) each process
trains on its own card with the group in its trainer. The train and valid
loaders are sharded by rank, the first batch is gathered over the ranks
for the k-means init (every rank computes the same codebooks), the valid
sums and the pesq means are reduced over the ranks, summaries, the infer
epoch and checkpoints come from rank 0 only, and every epoch ends with a
check that each rank holds rank 0's discriminator params. Every rank
resumes from the same newest checkpoint.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, set_f32_parity_mode
from ..data.loader import get_dataset_dataloader
from ..models.avocodo import (AvocodoDiscriminators, AvocodoFullRate,
                              AvocodoModel)
from ..models.codec import CodecModel, residual_vq
from ..models.discriminators import Discriminators
from ..models.losses import HifiGANMelLoss, MelGradLoss, MelLoss
from ..models.registry import build_codec_model
from ..ops import conv as C
from ..ops import mel as M
from ..ops import stft as ST
from ..ops.rvq import RVQDraws
from ..parallel import dist as D
from ..utils import checkpoint as ckpt
from ..utils import summarize as S
from .balancer import Balancer, SimpleBalancer
from .grad_clip import make_clipper
from .metrics import Metrics
from .optim import make_optimizer
from .schedulers import ReduceLROnPlateau, make_scheduler
from .step import Trainer, TrainState, metrics_to_host, to_device
from .step_avocodo import AvocodoCodecModel, AvocodoTrainer

REMAT_SELECTORS = ("none", "disc", "gen", "mel", "all")


def _plain(v):
    return v.to_dict() if hasattr(v, "to_dict") else v


def _mel_loss_from_config(hps):
    hp = hps.train
    if hp.get("hifigan_mel_loss", False):
        d = hps.data
        return HifiGANMelLoss(d.sampling_rate, d.get("clip_val", 1.0e-5),
                              d.n_fft, d.get("num_mels", 80), d.hop_size,
                              d.win_size)
    if hp.get("mel_grad_function", False):
        return MelGradLoss(hps.data.sampling_rate,
                           hps.data.get("clip_val", 1.0e-5),
                           hp.get("n_mels_max", 80), hp.get("mel_norm"))
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


def _compute_dtype_from_config(hp) -> torch.dtype:
    """`train.compute_dtype` bfloat16 (or bf16, float16, fp16) selects
    mixed precision in bf16, as does `fp16_g` / `fp16` when it is unset;
    float32 / fp32 / unset the f32 step."""
    name = hp.get("compute_dtype", None)
    if name is None and (hp.get("fp16_g", False) or hp.get("fp16", False)):
        name = "bfloat16"
    if name in (None, "float32", "fp32"):
        return torch.float32
    if name in ("bfloat16", "bf16", "float16", "fp16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {name!r}")


def build_avocodo_trainer(hps, device=None, group=None) -> AvocodoTrainer:
    """The Avocodo trainer of a `model: avocodo` config: LSGAN and plain
    feature matching, the weighted-sum balancer, D before G, PQMF
    multi-scale targets, and the single-resolution HiFi-GAN mel loss at
    the model's hop (not data.hop_size), as the JAX trainer has it."""
    mk = _plain(hps.model_kwargs)
    codec = AvocodoModel.from_config(mk)
    model = AvocodoCodecModel(AvocodoFullRate(codec),
                              residual_vq(mk.get("vq_kwargs") or {}),
                              resolve_device(device))
    disc = AvocodoDiscriminators(**{k: _plain(v)
                                    for k, v in hps.disc_kwargs.items()})
    hp, d = hps.train, hps.data
    optim_g, optim_d, lr_g, lr_d, sched, clipper = \
        _optim_sched_from_config(hps)
    mel_loss = HifiGANMelLoss(d.sampling_rate, d.clip_val, d.n_fft,
                              d.get("num_mels", 80), codec.hop_length,
                              d.win_size)
    return AvocodoTrainer(
        model=model, disc=disc, mel_loss=mel_loss,
        balancer=SimpleBalancer.from_config(_plain(hp.balancer_kwargs)),
        optim_g=optim_g, optim_d=optim_d, sched_g=sched, sched_d=sched,
        lr_g=lr_g, lr_d=lr_d,
        pqmf_config={k: tuple(v)
                     for k, v in _plain(hps.pqmf_config).items()},
        use_lsgan=hp.get("use_lsgan", True),
        use_normalized_fm=hp.get("use_normalized_fm_loss", False),
        clipper=clipper, group=group)


def build_trainer(hps, device=None, group=None):
    """The trainer of a config on `device` (CUDA when None, which must
    then be available), data-parallel over the process `group` when one
    is given: the balancer GAN trainer for HILCodec and EnCodec
    and for Avocodo under `train.trainer: hilcodec` (its generator with
    the full-rate head only), Avocodo's own trainer otherwise; AudioDec
    is deploy-only and raises the JAX loop's ValueError.
    `train.depthwise_lowering` and `train.fbd_lowering` may name either
    of the JAX loop's lowerings, which choose how XLA lowers the same
    function; each is one convolution here
    (`ops/conv.DEPTHWISE_LOWERINGS`). `optimizer: SAM` raises: the step
    takes one gradient a step, and SAM needs two, as in the JAX trainer,
    which cannot drive it either."""
    if hps.get("model", "hilcodec") == "audiodec":
        raise ValueError(
            "model: audiodec is deploy-only (the reference has no audiodec "
            "training wrapper; weights are imported — SURVEY.md §2.8)")
    hp = hps.train
    lowering = hp.get("fbd_lowering", "conv2d")
    if lowering not in ("conv2d", "bands1d"):
        raise ValueError(f"unknown fbd lowering {lowering!r}")
    lowering = hp.get("depthwise_lowering", "conv")
    if lowering not in C.DEPTHWISE_LOWERINGS:
        raise ValueError(f"unknown depthwise lowering {lowering!r}")
    if hp.get("fam_mode", "separate") not in ("separate", "vmap", "joint"):
        raise ValueError(f"unknown fam_mode {hp.fam_mode!r}")
    compute_dtype = _compute_dtype_from_config(hp)
    remat = hp.get("remat", "none")
    unknown = {r.strip() for r in remat.split(",")} - set(REMAT_SELECTORS)
    if unknown:
        raise ValueError(f"unknown remat selector(s) {sorted(unknown)}; "
                         f"choose from {REMAT_SELECTORS}")
    if hp.optimizer == "SAM":
        raise ValueError(
            "optimizer: SAM needs two gradients a step (first_step at the "
            "params, second_step at the perturbed ones); the reference "
            "Trainer takes one and calls optim.update, which SAM lacks, so "
            "it cannot drive SAM: choose AdamP, SGDP, RAdam or Adam")
    name = hps.get("model", "hilcodec")
    if name == "avocodo" and hp.get("trainer", None) != "hilcodec":
        if compute_dtype != torch.float32 or remat != "none":
            raise ValueError(
                "the Avocodo trainer has no compute_dtype or remat (the "
                "reference's runs f32 without rematerialization); set "
                "train.trainer: hilcodec or drop the option")
        return build_avocodo_trainer(hps, device, group)
    if name == "avocodo":
        mk = _plain(hps.model_kwargs)
        model = CodecModel(AvocodoFullRate(AvocodoModel.from_config(mk)),
                           residual_vq(mk.get("vq_kwargs") or {}),
                           resolve_device(device))
    else:
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
        clipper=clipper, compute_dtype=compute_dtype, remat=remat,
        group=group)


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
        # the default process group when one is initialized: one process
        # per card, each on its shard of the data
        self.group = D.default_group()
        self.n_proc, self.proc = D.world(), D.rank()
        self.trainer = build_trainer(hps, self.device, self.group)
        self.seed = hps.train.get("seed", 1)
        self.epoch = 0
        self.iteration = 0          # host copy of state.iteration
        self.state: Optional[TrainState] = None
        self.train_ds, self.train_loader = get_dataset_dataloader(
            hps, "train", ["wav"], num_shards=self.n_proc, shard=self.proc)
        try:
            self.valid_ds, self.valid_loader = get_dataset_dataloader(
                hps, "valid", ["wav"], num_shards=self.n_proc,
                shard=self.proc)
        except (FileNotFoundError, KeyError, AttributeError):
            self.valid_ds = self.valid_loader = None
        # what an epoch cannot do for want of data, named at start
        self._no_data: List[str] = []
        self.infer_loader = self._eval_loader("infer", ["wav", "filename"])
        pesq = hps.get("pesq", {})
        self.metrics = Metrics(
            pesq.get("metrics_to_calculate", {}) or {},
            sampling_rate=hps.data.sampling_rate,
            num_workers=pesq.get("num_workers_executor", 4),
            world_size=self.n_proc, rank=self.proc)
        self.pesq_loader = (self._eval_loader("pesq", ["wav"])
                            if self.metrics.enabled else None)
        self.plot_param_and_grad = hps.train.get("plot_param_and_grad",
                                                 False)
        self.writer_train = self.writer_valid = None
        self._images = False
        sched = self.trainer.sched_g
        self.plateau = sched if isinstance(sched, ReduceLROnPlateau) \
            else None
        self.plateau_state = self.plateau.init_state() if self.plateau \
            else None
        self.scheduler_metric = hps.train.get("scheduler_metric",
                                              "loss/freq")

    def _say(self, line: str) -> None:
        """Print a line from rank 0."""
        if self.proc == 0:
            print(line, flush=True)

    def _eval_loader(self, mode: str, keys: List[str]):
        try:
            return get_dataset_dataloader(self.hps, mode, keys)[1]
        except (FileNotFoundError, KeyError, AttributeError) as e:
            self._no_data.append(f"the {mode} epoch (no {mode} data: "
                                 f"{type(e).__name__} {e})")
            return None

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
        self.metrics.load_state_dict({k[5:]: float(v)
                                      for k, v in extras.items()
                                      if k.startswith("best_")})
        if self.plateau_state is not None:
            for k in list(self.plateau_state):
                if f"plateau_{k}" in extras:
                    self.plateau_state[k] = type(self.plateau_state[k])(
                        extras[f"plateau_{k}"].item())
        self._say(f"resumed from {path} (epoch {self.epoch}, iteration "
                  f"{self.iteration})")

    def save(self) -> str:
        extra: Dict[str, Any] = {"epoch": self.epoch}
        for k, v in self.metrics.state_dict().items():
            extra[f"best_{k}"] = v
        for k, v in (self.plateau_state or {}).items():
            extra[f"plateau_{k}"] = v
        return ckpt.save_checkpoint(self.run_dir, self.epoch, self.state,
                                    extra)

    def initialize_vq(self, wav: np.ndarray) -> None:
        """k-means init of the codebooks on the first batch's latents; the
        batch gathered over the ranks in rank order, so that every rank
        computes the same codebooks."""
        vq = self.trainer.model.vq
        if not vq.kmeans_init or bool(self.state.vq_state["initted"]):
            return
        wav_t = D.all_gather_rows(to_device(wav, self.device), self.group)
        with torch.no_grad():
            z = self.trainer.model.codec.encoder.apply(
                self.state.params_g["encoder"], wav_t)
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

    def train_epoch(self, hists: Optional[Dict[str, np.ndarray]] = None
                    ) -> Dict[str, float]:
        """One pass of the train loader; the metrics of each step are read
        to the host in one copy, in groups of up to 10 steps. With
        plot_param_and_grad and a `hists` dict, the histograms of the
        last batch go into it."""
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
            wav_t = to_device(wav, self.device)
            if idx == n_steps and self.plot_param_and_grad \
                    and hists is not None and self.n_proc == 1:
                self._param_and_grad_hists(hists, wav_t, draws)
            self.state, m = self.trainer.train_step(self.state, wav_t,
                                                    draws)
            self.iteration += 1
            pending.append((wav.shape[0], m))
            if idx % 10 == 0 or idx == n_steps:
                flush()
                line = f"Epoch {self.epoch} - Train {idx}/{n_steps}"
                for k, v in sums.items():
                    line += f"  {k.split('/')[1]}: {v / counts[k]:.3f}"
                if self.proc == 0:
                    S.progress_line(line + f"  lr: {last['lr']:.2e}")
        flush()
        if self.proc == 0:
            print()
        scalars = {k: v / max(counts[k], 1) for k, v in sums.items()}
        scalars["lr"] = last.get("lr", 0.0)
        scalars["epoch_time"] = time.time() - t0
        for i, r in enumerate(replaces if replaces is not None else []):
            scalars[f"n_replaces/{i}"] = float(r)
        # the per-epoch scheduler clock
        self.state = self.state._replace(epoch=self.state.epoch + 1)
        return scalars

    def _param_and_grad_hists(self, hists: Dict[str, np.ndarray],
                              wav: torch.Tensor, draws: RVQDraws) -> None:
        """The step's gradients on this batch with this step's draws,
        computed once more before the step, and the parameters into
        `hists`."""
        aux = self.trainer.compute_grads(self.state, wav, draws)
        S.plot_param_and_grad(hists, self.state.params_g, aux["g_grads"],
                              "model")
        S.plot_param_and_grad(hists, self.state.params_d, aux["d_grads"],
                              "disc")

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
        if self.n_proc > 1:
            # each rank validated its shard: sum [sums..., n] over ranks
            keys = sorted(sums)
            tot = D.all_sum_host([sums[k] for k in keys] + [n_items],
                                 self.group)
            sums, n_items = dict(zip(keys, tot[:-1].tolist())), tot[-1]
        return {k: v / max(n_items, 1) for k, v in sums.items()}

    def _log_mel(self, wav: np.ndarray) -> np.ndarray:
        """The log-mel image of an infer epoch: the loss STFT (reflect pad
        of (n_fft - hop) / 2, periodic Hann of win_size centred in n_fft),
        magnitude, mel filterbank, log of the clipped mel."""
        d = self.hps.data
        n_fft, hop, win = d.n_fft, d.hop_size, d.win_size
        p = (n_fft - hop) // 2
        x = np.pad(np.asarray(wav, np.float32), (p, p), mode="reflect")
        window = np.zeros(n_fft, np.float32)
        window[(n_fft - win) // 2:(n_fft - win) // 2 + win] = \
            ST.hann_window_np(win)
        n = 1 + (len(x) - n_fft) // hop
        frames = x[np.arange(n)[:, None] * hop + np.arange(n_fft)] * window
        mag = np.abs(np.fft.rfft(frames, axis=-1)).T.astype(np.float32)
        basis = M.mel_filterbank(d.sampling_rate, n_fft,
                                 d.get("num_mels", 80))
        return np.log(np.clip(basis @ mag, d.get("clip_val", 1e-5), None))

    def _reconstruct(self, wav: np.ndarray) -> np.ndarray:
        """The codec's forward at train.infer_n quantizers (all when
        unset), no update: [B, 1, T] -> [B, 1, T] on the host."""
        n = self.hps.train.get("infer_n", None)
        with torch.no_grad():
            wav_g, _, _, _ = self.trainer.model.forward(
                self.state.params_g, self.state.vq_state,
                to_device(wav, self.device),
                RVQDraws(n) if n else None, training=False)
        return wav_g.cpu().numpy()

    def infer_epoch(self) -> Tuple[Dict[str, np.ndarray],
                                   Dict[str, np.ndarray]]:
        """(audios, log-mel images) of the infer filelist's
        reconstructions; the ground truth too in the first epoch."""
        if self.infer_loader is None:
            return {}, {}
        audios: Dict[str, np.ndarray] = {}
        specs: Dict[str, np.ndarray] = {}
        for i, batch in enumerate(self.infer_loader):
            wav = self._batch_wav(batch)
            wav_g = self._reconstruct(wav)
            audios[f"gen/wav_{i}"] = wav_g[0, 0]
            specs[f"gen/mel_{i}"] = self._log_mel(wav_g[0, 0])
            if self.epoch <= 1:
                audios[f"gt/wav_{i}"] = wav[0, 0]
                specs[f"gt/mel_{i}"] = self._log_mel(wav[0, 0])
        return audios, specs

    def pesq_epoch(self) -> Dict[str, float]:
        """The enabled objective metrics (`pesq.metrics_to_calculate`) of
        the pesq filelist's reconstructions; none enabled, nothing run."""
        if self.pesq_loader is None:
            return {}
        self.metrics.initialize()
        for batch in self.pesq_loader:
            wav = self._batch_wav(batch)
            self.metrics.submit(wav[:, 0], self._reconstruct(wav)[:, 0])
        if self.n_proc == 1:
            return self.metrics.retrieve()
        # each rank scored its stride: weighted means over the ranks
        return self.metrics.retrieve(reduce_fn=lambda mean, n: D.process_mean(
            mean, n, self.group))

    def _open_writers(self) -> None:
        """The train / valid writers (rank 0's only); one line naming what
        will not be written, where a package or an epoch's data is
        missing."""
        if self.proc != 0:
            self.plot_param_and_grad = False
            return
        absent = S.missing()
        lost = list(self._no_data)
        if "tensorboard" in absent:
            what = "the train and valid scalars, metric/*, "
            if self.plot_param_and_grad:
                what += ("the parameter and gradient histograms "
                         "(plot_param_and_grad), ")
            lost.insert(0, what + "the infer epoch's audio and log-mel "
                        "images (tensorboard is not installed)")
            self.plot_param_and_grad = False
        else:
            self.writer_train = S.get_writer(os.path.join(self.run_dir,
                                                          "train"))
            self.writer_valid = S.get_writer(os.path.join(self.run_dir,
                                                          "valid"))
            if "matplotlib" in absent:
                lost.insert(0, "the infer epoch's log-mel images "
                            "(matplotlib is not installed)")
        self._images = not absent
        if lost:
            self._say(f"TrainLoop: not writing {'; '.join(lost)}")

    def _close(self) -> None:
        self.metrics.close()
        for w in (self.writer_train, self.writer_valid):
            if w is not None:
                w.close()
        self.writer_train = self.writer_valid = None

    def run(self, max_epochs: Optional[int] = None) -> None:
        hps = self.hps
        max_epochs = max_epochs or hps.train.max_epochs
        if self.state is None:
            self.init_or_resume()
        self._open_writers()
        infer_interval = hps.get("infer", {}).get("interval", 10)
        pesq_interval = hps.get("pesq", {}).get("interval", 1000)
        save_interval = hps.train.get("save_interval", 1)
        try:
            while self.epoch < max_epochs:
                self.epoch += 1
                if hasattr(self.train_ds, "shuffle"):
                    self.train_ds.shuffle(self.seed + self.epoch)
                hists: Dict[str, np.ndarray] = {}
                scalars = self.train_epoch(hists)
                self._say(f"Epoch {self.epoch} train: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in scalars.items()))
                if self.writer_train is not None:
                    S.summarize(self.writer_train, self.epoch, scalars,
                                hists=hists or None, echo=False)
                if self.n_proc > 1:
                    # every rank must hold rank 0's discriminator
                    D.assert_replicas_consistent(self.state.params_d,
                                                 group=self.group)
                valid = self.valid_epoch()
                if valid:
                    self._say(f"Epoch {self.epoch} valid: " + ", ".join(
                        f"{k} {v:.4g}" for k, v in valid.items()))
                    if self.writer_valid is not None:
                        S.summarize(self.writer_valid, self.epoch, valid,
                                    echo=False)
                if self.plateau is not None:
                    metric = valid.get(self.scheduler_metric,
                                       scalars.get(self.scheduler_metric))
                    if metric is not None:
                        self.plateau_state = self.plateau.update(
                            self.plateau_state, metric,
                            base_lr=self.trainer.lr_g)
                        self.state = self.state._replace(
                            lr_scale=torch.full(
                                (), self.plateau_state["scale"],
                                device=self.device))
                if self.epoch % pesq_interval == 0:
                    for k, v in self.pesq_epoch().items():
                        self._say(f"Epoch {self.epoch} metric/{k} {v:.4g}")
                        if self.writer_valid is not None:
                            self.writer_valid.add_scalar(f"metric/{k}", v,
                                                         self.epoch)
                if self.epoch % infer_interval == 0 \
                        and self.writer_valid is not None:
                    audios, specs = self.infer_epoch()
                    if audios:
                        S.summarize(self.writer_valid, self.epoch,
                                    audios=audios,
                                    specs=specs if self._images else None,
                                    sampling_rate=hps.data.sampling_rate,
                                    echo=False)
                if self.epoch % save_interval == 0:
                    if self.proc == 0:
                        self._say(f"saved {self.save()}")
                    # no rank moves on (or resumes) before the file is
                    # written
                    D.barrier(self.group)
        finally:
            self._close()
