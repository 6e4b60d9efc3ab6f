"""Shape-gain product VQ (`hilcodec_tpu/ops/shape_gain.py`): a shape
codebook of directions times a scalar (log-)gain codebook, in a residual
cascade, behind the trainer's quantizer interface (`vq:
ResidualShapeGainVQ`).

Per stage, the state holds

  shape     [scs, C]  shape codewords
  shape_num [scs]     EMA usage
  gain      [gcs]     scalar (log-)gains
  gain_num  [gcs]     EMA usage (scaled by the scs/gcs ratio)

stacked over the stages. Quantization takes the shape of largest inner
product (`torch.argmax`, the first index on ties as `jnp.argmax`), the
gain target <x, shape> (log-compressed when log_gain) and its nearest
gain; the reconstruction is exp(gain) * shape. The inner-product GEMM is
a plain `torch.matmul` in f32, as it is a plain product outside any
kernel in the JAX package. The random expiry candidates are drawn by the
caller and passed in (`ShapeGainDraws`), like `RVQDraws.expire_idx`.
Given a process group, a training step sums its statistics bucket over
the ranks and takes rank 0's shape and gain candidates, as the JAX
codebook does under its `axis_name`.
Token encode / decode and the streaming drivers need a Euclidean codebook
and do not take this quantizer; the codec reconstructs through `forward`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import dist as D

SGState = Dict[str, torch.Tensor]


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


@dataclasses.dataclass(frozen=True)
class ShapeGainDraws:
    """The random draws of one training pass: the stage count `n` (None:
    all) and, per stage, the rows whose shapes and gain targets replace
    expired codewords: `shape_idx` [n_q, scs], `gain_idx` [n_q, gcs]."""
    n: Optional[int] = None
    shape_idx: Optional[torch.Tensor] = None
    gain_idx: Optional[torch.Tensor] = None

    def to(self, device) -> "ShapeGainDraws":
        if self.shape_idx is None:
            return self
        return dataclasses.replace(self, shape_idx=self.shape_idx.to(device),
                                   gain_idx=self.gain_idx.to(device))


@dataclasses.dataclass(frozen=True)
class ShapeGainCodebook:
    dim: int
    shape_codebook_size: int
    gain_codebook_size: int
    decay: float = 0.99
    eps: float = 1e-5
    ema_num_threshold: float = 0.0
    ema_num_initial: float = 1.0
    log_gain: bool = True

    @property
    def gain_num_ratio(self) -> float:
        return self.shape_codebook_size / self.gain_codebook_size

    def init_state(self, gen: torch.Generator) -> SGState:
        """N(0, 1) shapes and Uniform(1.0, 1.9) gains from `gen` (CPU)."""
        scs, gcs = self.shape_codebook_size, self.gain_codebook_size
        return {
            "shape": torch.randn((scs, self.dim), generator=gen),
            "shape_num": torch.full((scs,), self.ema_num_initial),
            "gain": torch.empty(gcs).uniform_(1.0, 1.9, generator=gen),
            "gain_num": torch.full((gcs,), self.ema_num_initial
                                   * self.gain_num_ratio)}

    def quantize(self, flatten: torch.Tensor, state: SGState
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """flatten [M, C] -> (quantize [M, C], shape_ind, gain_ind,
        gain_target [M, 1])."""
        shape = state["shape"]
        sim = torch.matmul(flatten, shape.T)
        shape_ind = torch.argmax(sim, dim=-1)
        shape_q = shape[shape_ind]
        gain_target = torch.sum(flatten * shape_q, dim=1, keepdim=True)
        if self.log_gain:
            gain_target = torch.log(torch.clamp(gain_target, min=self.eps))
        g = state["gain"][None, :]
        dist = -(gain_target ** 2 - 2.0 * gain_target @ g + g ** 2)
        gain_ind = torch.argmax(dist, dim=-1)
        gain_q = state["gain"][gain_ind]
        if self.log_gain:
            gain_q = torch.exp(gain_q)
        return gain_q[:, None] * shape_q, shape_ind, gain_ind, gain_target

    def train_step(self, flatten: torch.Tensor, state: SGState,
                   shape_idx: Optional[torch.Tensor] = None,
                   gain_idx: Optional[torch.Tensor] = None, group=None
                   ) -> Tuple[torch.Tensor, SGState, torch.Tensor,
                              torch.Tensor]:
        """One EMA update (no gradient); `shape_idx` / `gain_idx` are the
        expiry candidate rows; `group` the process group the statistics
        are summed over. Returns (quantize, new_state, n_shape_replace,
        n_gain_replace)."""
        flatten = flatten.float()
        quantize, shape_ind, gain_ind, gain_target = self.quantize(
            flatten, state)
        scs, gcs = self.shape_codebook_size, self.gain_codebook_size
        shape_onehot = F.one_hot(shape_ind, scs).float()
        gain_onehot = F.one_hot(gain_ind, gcs).float()
        shape_num_new = shape_onehot.sum(0)
        shape_new = flatten.T @ shape_onehot                    # [C, scs]
        gain_num_new = gain_onehot.sum(0)
        gain_new = (gain_target.T @ gain_onehot).squeeze(0)
        if group is not None:
            bucket = D.all_sum(torch.cat([gain_num_new, shape_num_new,
                                          gain_new, shape_new.reshape(-1)]),
                               group)
            gain_num_new, shape_num_new, gain_new, shape_new = bucket.split(
                [gcs, scs, gcs, self.dim * scs])
            shape_new = shape_new.reshape(self.dim, scs)
        shape_new = shape_new / torch.clamp(
            torch.linalg.norm(shape_new, dim=0, keepdim=True), min=self.eps)
        gain_new = gain_new / torch.clamp(gain_num_new, min=self.eps)

        d = self.decay
        gain_num = state["gain_num"] * d + gain_num_new * (1 - d)
        gain = state["gain"] * d + gain_new * (1 - d)
        shape_num = state["shape_num"] * d + shape_num_new * (1 - d)
        shape = _l2norm(state["shape"] * d + shape_new.T * (1 - d))

        zero = torch.zeros((), dtype=torch.int32, device=flatten.device)
        n_shape_rep = n_gain_rep = zero
        if self.ema_num_threshold > 0.0:
            if shape_idx is None or gain_idx is None:
                raise ValueError("shape-gain expiry needs candidate rows "
                                 "(ShapeGainDraws)")
            expired_s = shape_num < self.ema_num_threshold
            cand = D.broadcast0(_l2norm(flatten)[shape_idx], group)
            shape = torch.where(expired_s[:, None], cand, shape)
            shape_num = torch.where(expired_s, torch.full_like(
                shape_num, self.ema_num_initial), shape_num)
            n_shape_rep = expired_s.sum().to(torch.int32)

            thr_g = self.ema_num_threshold * self.gain_num_ratio
            expired_g = gain_num < thr_g
            gcand = D.broadcast0(gain_target.squeeze(1)[gain_idx], group)
            gain = torch.where(expired_g, gcand, gain)
            gain_num = torch.where(expired_g, torch.full_like(
                gain_num, self.ema_num_initial * self.gain_num_ratio),
                gain_num)
            n_gain_rep = expired_g.sum().to(torch.int32)

        new_state = {"shape": shape, "shape_num": shape_num, "gain": gain,
                     "gain_num": gain_num}
        return quantize, new_state, n_shape_rep, n_gain_rep


@dataclasses.dataclass(frozen=True)
class ResidualShapeGainVQ:
    """Residual cascade of shape-gain codebooks with a straight-through
    output and an MSE commit loss, over x [B, C, T]."""
    dim: int
    num_quantizers: int
    shape_codebook_size: int = 1024
    gain_codebook_size: int = 16
    decay: float = 0.99
    ema_num_threshold: float = 0.0
    ema_num_initial: float = 1.0
    log_gain: bool = True

    def __post_init__(self):
        object.__setattr__(self, "codebook", ShapeGainCodebook(
            self.dim, self.shape_codebook_size, self.gain_codebook_size,
            self.decay, ema_num_threshold=self.ema_num_threshold,
            ema_num_initial=self.ema_num_initial, log_gain=self.log_gain))

    def init_state(self, gen: torch.Generator, device="cpu") -> SGState:
        states = [self.codebook.init_state(gen)
                  for _ in range(self.num_quantizers)]
        return {k: torch.stack([s[k] for s in states]).to(device)
                for k in states[0]}

    def __call__(self, x: torch.Tensor, state: SGState,
                 draws: Optional[Any] = None, training: bool = True,
                 group=None
                 ) -> Tuple[torch.Tensor, SGState, torch.Tensor,
                            torch.Tensor]:
        """(quantized [B, C, T], new_state, loss, replaces [n_q] int32).
        `draws.n` (None: all) stages are active; with training each
        active stage takes one EMA step, the rest keep their state."""
        xcl = x.transpose(1, 2)
        B, T, C = xcl.shape
        n = None if draws is None else draws.n
        n_q = self.num_quantizers if n is None else int(n)
        if training and self.ema_num_threshold > 0.0 and (
                draws is None or getattr(draws, "shape_idx", None) is None):
            raise ValueError("training with expiry needs ShapeGainDraws")
        zero = torch.zeros((), dtype=torch.int32, device=x.device)
        new_states, replaces = [], []
        with torch.no_grad():
            residual = xcl.detach().float().reshape(B * T, C)
            q_sum = torch.zeros_like(residual)
            for i in range(self.num_quantizers):
                st = {k: v[i] for k, v in state.items()}
                if training and i < n_q:
                    idx = ((None, None) if self.ema_num_threshold <= 0.0
                           else (draws.shape_idx[i], draws.gain_idx[i]))
                    q, st, nr_s, nr_g = self.codebook.train_step(
                        residual, st, *idx, group=group)
                    replaces.append(nr_s + nr_g)
                else:
                    q = self.codebook.quantize(residual, st)[0]
                    replaces.append(zero)
                if i < n_q:
                    residual, q_sum = residual - q, q_sum + q
                new_states.append(st)
        quantized = q_sum.reshape(B, T, C)
        loss = torch.mean(torch.square(xcl.float() - quantized))
        if training:
            quantized = xcl + (quantized - xcl).detach()
        new_state = {k: torch.stack([s[k] for s in new_states])
                     for k in state}
        return (quantized.transpose(1, 2), new_state, loss,
                torch.stack(replaces))


@dataclasses.dataclass(frozen=True)
class ShapeGainVQBridge:
    """ResidualShapeGainVQ behind the codec's quantizer interface: the
    trainer's 5-tuple (no token indices: a stage has two index sets and
    no deployment path). No k-means warm-up and no structured quantizer
    dropout: the shapes and gains start random and every step runs the
    whole stack."""
    rvq: ResidualShapeGainVQ
    kmeans_init: bool = False
    dropout: bool = False

    @classmethod
    def from_kwargs(cls, vq_kwargs: Dict[str, Any]) -> "ShapeGainVQBridge":
        return cls(ResidualShapeGainVQ(
            dim=vq_kwargs.get("dim", 128),
            num_quantizers=vq_kwargs.get("num_quantizers", 8),
            shape_codebook_size=vq_kwargs.get(
                "shape_codebook_size", vq_kwargs.get("codebook_size", 1024)),
            gain_codebook_size=vq_kwargs.get("gain_codebook_size", 16),
            decay=vq_kwargs.get("decay", 0.99),
            ema_num_threshold=vq_kwargs.get("ema_num_threshold", 0.0),
            ema_num_initial=vq_kwargs.get("ema_num_initial", 1.0),
            log_gain=vq_kwargs.get("log_gain", True)))

    @property
    def num_quantizers(self) -> int:
        return self.rvq.num_quantizers

    def init_state(self, gen: torch.Generator, device="cpu") -> SGState:
        return self.rvq.init_state(gen, device)

    def sample_draws(self, gen: torch.Generator, rows: int
                     ) -> ShapeGainDraws:
        """Every stage active (n None); expiry candidates for every
        stage's shapes and gains."""
        r = self.rvq
        return ShapeGainDraws(
            None,
            torch.randint(0, rows, (r.num_quantizers, r.shape_codebook_size),
                          generator=gen),
            torch.randint(0, rows, (r.num_quantizers, r.gain_codebook_size),
                          generator=gen))

    def kmeans_init_state(self, state: SGState, x: torch.Tensor,
                          init_idx: torch.Tensor, group=None) -> SGState:
        """No-op: the codebooks start random (no k-means warm-up)."""
        return state

    def __call__(self, x, state, draws=None, training=True, group=None):
        q, state, loss, replaces = self.rvq(x, state, draws, training,
                                            group)
        return q, state, loss, replaces, None
