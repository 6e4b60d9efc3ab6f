"""Residual vector quantization (`hilcodec_tpu/ops/rvq.py`).

Inference: `quantize` is the plain PyTorch cascade, per stage: f32 distance
||r||^2 - 2 r.e^T + ||e||^2, first-index argmin, gather, residual subtract.
It is the plain version of the CUDA kernel in `ops/rvq_kernel.py`, which
is what the codec calls. `dequantize` is a gather-sum (no kernel in the
JAX package either).

Training: `ResidualVQ.__call__` takes the stage indices of the active
stages from that kernel (the plain cascade for CPU tensors), rebuilds each
stage's residual from them, and updates the EMA statistics (Laplace
smoothing when expiry is off, dead-code expiry from drawn candidate rows,
inactive stages left as they were) without gradients; the output is the
straight-through quantized latent and `loss_vq`. `kmeans_init_state`
initializes the codebooks from a first batch. Everything random (the
dropout depth, the expiry candidates, the k-means seeds) is drawn by the
caller and passed in (`RVQDraws`, `kmeans_init_indices`).

Data parallelism: given a process group, the training pass sums each
stage's `[num; embed]` statistics bucket over the ranks and takes rank
0's expiry candidates, and k-means runs on rank 0's rows, as the JAX
quantizer does under its `axis_name`; every rank then holds the same
state.

`NoVQ` is the `vq: ''` ablation: the latents pass straight through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import dist as D
from .conv import row_matmul

VQState = Dict[str, torch.Tensor]


def _stage_indices(residual: torch.Tensor,
                   embed: torch.Tensor) -> torch.Tensor:
    """First-min-index nearest codeword. residual [M, C], embed [K, C]."""
    r32, e32 = residual.float(), embed.float()
    dist = (torch.sum(r32 * r32, dim=1, keepdim=True)
            - 2.0 * row_matmul(r32, e32.T)
            + torch.sum(e32 * e32, dim=1)[None, :])
    # torch.argmin returns the first index among equal minima
    return torch.argmin(dist, dim=1)


def quantize(x: torch.Tensor, codebooks: torch.Tensor,
             n: Optional[int] = None) -> torch.Tensor:
    """x: [B, T, C]; codebooks: [n_q, K, C] -> indices [n, B, T] (int32)."""
    n_q = codebooks.shape[0] if n is None else n
    B, T, C = x.shape
    residual = x.reshape(B * T, C)
    out = []
    for s in range(n_q):
        idx = _stage_indices(residual, codebooks[s])
        residual = residual - codebooks[s][idx].to(residual.dtype)
        out.append(idx)
    if not out:
        return torch.zeros((0, B, T), dtype=torch.int32, device=x.device)
    return torch.stack(out).to(torch.int32).reshape(n_q, B, T)


def dequantize(indices: torch.Tensor, codebooks: torch.Tensor
               ) -> torch.Tensor:
    """indices: [n, B, T]; codebooks: [n_q, K, C] -> [B, T, C], the sum of
    the chosen codewords in stage order."""
    n, B, T = indices.shape
    out = torch.zeros((B, T, codebooks.shape[-1]), dtype=codebooks.dtype,
                      device=codebooks.device)
    for s in range(n):
        out = out + codebooks[s][indices[s].long()]
    return out


def quantize_dequantize(x: torch.Tensor, codebooks: torch.Tensor,
                        n: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode-side path returning (quantized [B, T, C], indices)."""
    n_q = codebooks.shape[0] if n is None else n
    B, T, C = x.shape
    residual = x.reshape(B * T, C)
    acc = torch.zeros_like(residual)
    out = []
    for s in range(n_q):
        idx = _stage_indices(residual, codebooks[s])
        q = codebooks[s][idx].to(residual.dtype)
        residual, acc = residual - q, acc + q
        out.append(idx)
    indices = torch.stack(out).to(torch.int32).reshape(n_q, B, T)
    return acc.reshape(B, T, C), indices


def token_parity_report(ours: torch.Tensor, ref: torch.Tensor,
                        x: torch.Tensor, codebooks: torch.Tensor,
                        tie_rel: Optional[float] = None) -> Dict[str, float]:
    """Hold tokens `ours` against reference tokens `ref` (both [n, ...])
    of the latents `x` ([..., C]), allowing only provable f32 ties.

    Each first-divergence mismatch (a position whose earlier stages agree)
    is a tie when the float64 distances of the two chosen codewords, taken
    from the reference path's f32 residual, differ by less than the f32
    accumulation bound of a C-term distance, 2*C*eps_f32 relative (or
    `tie_rel`, where the two sides' latents differ by more than f32
    rounding). Later stages of a diverged position see other residuals and
    are not judged. `ok` needs no non-tie and a mismatch rate of at most
    1e-3."""
    n = ref.shape[0]
    C = codebooks.shape[-1]
    ref = ref.reshape(n, -1).long().cpu()
    ours = ours.reshape(n, -1).long().cpu()
    books = codebooks[:n].float().cpu()
    residual = x.reshape(-1, C).float().cpu()
    bound = (2.0 * C * torch.finfo(torch.float32).eps if tie_rel is None
             else tie_rel)
    mism = ref != ours
    diverged = torch.zeros(ref.shape[1], dtype=torch.bool)
    ties = not_ties = 0
    worst = 0.0
    for s in range(n):
        first = mism[s] & ~diverged
        for p in torch.nonzero(first).flatten().tolist():
            r = residual[p].double()
            e = books[s][[int(ref[s, p]), int(ours[s, p])]].double()
            d = ((r[None, :] - e) ** 2).sum(1)
            rel = float(abs(d[0] - d[1]) / max(float(d.max()), 1e-12))
            worst = max(worst, rel)
            if rel < bound:
                ties += 1
            else:
                not_ties += 1
        diverged |= mism[s]
        residual = residual - books[s][ref[s]]
    rate = float(mism.float().mean()) if mism.numel() else 0.0
    return {"mismatches": int(mism.sum()), "ties": ties,
            "not_ties": not_ties, "rate": rate, "worst_rel_gap": worst,
            "ok": not_ties == 0 and rate <= 1e-3}


@dataclasses.dataclass(frozen=True)
class RVQDraws:
    """The random draws of one training pass: the number of active stages
    `n` (quantizer dropout) and, per stage, the K candidate rows
    `expire_idx` [n_q, K] that replace expired codewords."""
    n: int
    expire_idx: Optional[torch.Tensor] = None

    def to(self, device) -> "RVQDraws":
        """The same draws with the candidate rows on `device`."""
        if self.expire_idx is None:
            return self
        return dataclasses.replace(self,
                                   expire_idx=self.expire_idx.to(device))


@dataclasses.dataclass(frozen=True)
class ResidualVQ:
    """Quantizer config and its functional EMA / k-means training."""
    dim: int = 128
    codebook_size: int = 1024
    num_quantizers: int = 8
    kmeans_init: bool = True
    kmeans_iters: int = 20
    decay: float = 0.99
    eps: float = 1e-7
    ema_num_threshold: float = 0.5
    ema_num_initial: float = 0.5
    dropout: bool = True
    dropout_index: Optional[Tuple[int, ...]] = None

    def init_state(self, gen: torch.Generator, device="cpu") -> VQState:
        """{embed, ema_embed, ema_num, initted}: zero codebooks when k-means
        init is pending, N(0, 1) codebooks from `gen` otherwise."""
        n, K, C = self.num_quantizers, self.codebook_size, self.dim
        if self.kmeans_init:
            embed = torch.zeros((n, K, C))
        else:
            embed = torch.randn((n, K, C), generator=gen)
        state = {"embed": embed,
                 "ema_embed": embed * self.ema_num_initial,
                 "ema_num": torch.full((n, K), self.ema_num_initial),
                 "initted": torch.tensor(not self.kmeans_init)}
        return {k: v.to(device) for k, v in state.items()}

    # -- random draws ---------------------------------------------------------
    def sample_n(self, gen: torch.Generator) -> int:
        """The quantizer-dropout depth of a training pass."""
        if not self.dropout:
            return self.num_quantizers
        idx = tuple(self.dropout_index or range(1, self.num_quantizers + 1))
        return int(idx[int(torch.randint(0, len(idx), (1,), generator=gen))])

    def sample_draws(self, gen: torch.Generator, rows: int) -> RVQDraws:
        """Everything random in one training pass over `rows` latents."""
        n = self.sample_n(gen)
        cand = torch.randint(0, rows, (self.num_quantizers,
                                       self.codebook_size), generator=gen)
        return RVQDraws(n, cand)

    def kmeans_init_indices(self, gen: torch.Generator,
                            rows: int) -> torch.Tensor:
        """[n_q, K] initial k-means rows per stage: a random permutation's
        head when there are enough rows, else rows drawn with replacement."""
        K = self.codebook_size
        out = [torch.randperm(rows, generator=gen)[:K] if rows >= K
               else torch.randint(0, rows, (K,), generator=gen)
               for _ in range(self.num_quantizers)]
        return torch.stack(out)

    # -- k-means initialization -----------------------------------------------
    def kmeans_init_state(self, state: VQState, x: torch.Tensor,
                          init_idx: torch.Tensor, group=None) -> VQState:
        """Every codebook from k-means on the residuals of the latents
        x [B, C, T], stage by stage; `init_idx` from kmeans_init_indices.
        With a group, the rows are rank 0's."""
        if not self.kmeans_init:
            return state
        with torch.no_grad():
            residual = x.transpose(1, 2).reshape(-1, self.dim).float()
            residual = D.broadcast0(residual, group)
            init_idx = init_idx.to(residual.device)
            embeds = []
            for s in range(self.num_quantizers):
                means = _kmeans(residual, self.codebook_size,
                                self.kmeans_iters, init_idx[s])
                residual = residual - means[_stage_indices(residual, means)]
                embeds.append(means)
            embed = torch.stack(embeds)
        return {"embed": embed,
                "ema_embed": embed * self.ema_num_initial,
                "ema_num": torch.full(embed.shape[:2], self.ema_num_initial,
                                      device=embed.device),
                "initted": torch.ones((), dtype=torch.bool,
                                      device=embed.device)}

    # -- the training pass ----------------------------------------------------
    def __call__(self, x: torch.Tensor, state: VQState,
                 draws: Optional[RVQDraws] = None, training: bool = True,
                 group=None
                 ) -> Tuple[torch.Tensor, VQState, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
        """One RVQ pass over latents x [B, C, T].

        `draws=None` runs every stage (evaluation); `group` is the process
        group the EMA statistics are summed over. Returns (quantized
        [B, C, T], new_state, loss_vq, num_replaces [n_q] int32, indices
        [n_q, B, T] int32); inactive stages give index 0, contribute
        nothing and keep their state."""
        from . import rvq_kernel

        xcl = x.transpose(1, 2)
        B, T, C = xcl.shape
        n_q, K = self.num_quantizers, self.codebook_size
        n = n_q if draws is None else draws.n
        embed = state["embed"]
        new = {k: list(state[k].unbind(0))
               for k in ("embed", "ema_embed", "ema_num")}
        replaces = [torch.zeros((), dtype=torch.int32, device=x.device)] * n_q
        with torch.no_grad():
            flat0 = xcl.detach().float().reshape(B * T, C)
            idx = rvq_kernel.quantize(flat0.view(B, T, C), embed, n)
            idx = idx.reshape(n, B * T).long()
            residual, q_sum = flat0, torch.zeros_like(flat0)
            for s in range(n):
                q = embed[s][idx[s]]
                if training:
                    self._ema_update(s, new, replaces, residual, idx[s],
                                     flat0, draws, group)
                residual, q_sum = residual - q, q_sum + q
        quantized = q_sum.reshape(B, T, C)
        loss_vq = torch.mean(torch.square(xcl.float() - quantized))
        if training:
            # straight-through: value = quantized, gradient = identity
            quantized = xcl + (quantized - xcl).detach()
        indices = torch.zeros((n_q, B * T), dtype=torch.int32,
                              device=x.device)
        indices[:n] = idx
        new_state = {k: torch.stack(v) for k, v in new.items()}
        new_state["initted"] = state["initted"]
        return (quantized.transpose(1, 2), new_state, loss_vq,
                torch.stack(replaces), indices.reshape(n_q, B, T))

    def _ema_update(self, s: int, new: Dict[str, list], replaces: list,
                    residual: torch.Tensor, idx: torch.Tensor,
                    flat0: torch.Tensor, draws: Optional[RVQDraws],
                    group=None) -> None:
        """Stage s's EMA statistics (summed over the group's ranks as one
        [K, 1 + C] bucket), codebook and dead-code expiry (rank 0's
        candidates)."""
        K = self.codebook_size
        onehot = F.one_hot(idx, K).float()
        num_curr = onehot.sum(0)
        embed_curr = onehot.T @ residual
        if group is not None:
            bucket = D.all_sum(torch.cat([num_curr[:, None], embed_curr], 1),
                               group)
            num_curr, embed_curr = bucket[:, 0], bucket[:, 1:]
        d = self.decay
        ema_num = new["ema_num"][s] * d + num_curr * (1 - d)
        ema_embed = new["ema_embed"][s] * d + embed_curr * (1 - d)
        if self.ema_num_threshold > 0.0:
            denom = ema_num[:, None]
        else:
            # Laplace smoothing when expiry is off
            total = torch.sum(ema_num)
            denom = ((ema_num + self.eps) / (total + K * self.eps)
                     * total)[:, None]
        embed = ema_embed / denom
        if self.ema_num_threshold > 0.0:
            if draws is None or draws.expire_idx is None:
                raise ValueError("dead-code expiry needs candidate rows "
                                 "(RVQDraws.expire_idx)")
            expired = ema_num < self.ema_num_threshold
            cand = D.broadcast0(flat0[draws.expire_idx[s].to(flat0.device)],
                                group)
            embed = torch.where(expired[:, None], cand, embed)
            ema_embed = torch.where(expired[:, None],
                                    cand * self.ema_num_initial, ema_embed)
            ema_num = torch.where(expired, torch.full_like(
                ema_num, self.ema_num_initial), ema_num)
            replaces[s] = expired.sum().to(torch.int32)
        new["embed"][s], new["ema_embed"][s], new["ema_num"][s] = (
            embed, ema_embed, ema_num)


@dataclasses.dataclass(frozen=True)
class NoVQ:
    """The `vq: ''` ablation: the codec without a quantizer. Latents pass
    straight through with a zero VQ loss and an empty num_replaces; the
    ResidualVQ call protocol, so every trainer and loop path runs as is."""
    num_quantizers: int = 0
    kmeans_init: bool = False
    dropout: bool = False

    def init_state(self, gen: torch.Generator, device="cpu") -> VQState:
        # "initted" keeps the state tree non-empty for checkpoints
        return {"initted": torch.ones((), dtype=torch.bool, device=device)}

    def sample_draws(self, gen: torch.Generator, rows: int) -> RVQDraws:
        return RVQDraws(0)

    def kmeans_init_state(self, state: VQState, x: torch.Tensor,
                          init_idx: torch.Tensor, group=None) -> VQState:
        return state

    def __call__(self, x: torch.Tensor, state: VQState,
                 draws: Optional[RVQDraws] = None, training: bool = True,
                 group=None):
        zero = torch.zeros((), device=x.device)
        return (x, state, zero,
                torch.zeros((0,), dtype=torch.int32, device=x.device), None)


def _kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int,
            init_idx: torch.Tensor) -> torch.Tensor:
    """Euclidean k-means from the rows `init_idx`; a cluster left empty
    keeps its mean."""
    means = samples[init_idx]
    sq = torch.sum(samples ** 2, 1, keepdim=True)
    for _ in range(num_iters):
        dist = sq - 2 * samples @ means.T + torch.sum(means ** 2, 1)[None, :]
        onehot = F.one_hot(torch.argmin(dist, 1), num_clusters).to(
            samples.dtype)
        bins = onehot.sum(0)
        zero = bins == 0
        new_means = (onehot.T @ samples) / torch.where(
            zero, torch.ones_like(bins), bins)[:, None]
        means = torch.where(zero[:, None], means, new_means)
    return means
