"""Residual vector quantization, inference half (`hilcodec_tpu/ops/rvq.py`).

`quantize` is the plain PyTorch cascade, per stage: f32 distance
||r||^2 - 2 r.e^T + ||e||^2, first-index argmin, gather, residual subtract.
It is the plain version of the CUDA kernel in `ops/rvq_kernel.py`, which
is what the codec calls. `dequantize` is a gather-sum (no kernel in the
JAX package either). EMA / k-means training and quantizer dropout are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

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
                        x: torch.Tensor, codebooks: torch.Tensor
                        ) -> Dict[str, float]:
    """Hold tokens `ours` against reference tokens `ref` (both [n, ...])
    of the latents `x` ([..., C]), allowing only provable f32 ties.

    Each first-divergence mismatch (a position whose earlier stages agree)
    is a tie when the float64 distances of the two chosen codewords, taken
    from the reference path's f32 residual, differ by less than the f32
    accumulation bound of a C-term distance, 2*C*eps_f32 relative. Later
    stages of a diverged position see other residuals and are not judged.
    `ok` needs no non-tie and a mismatch rate of at most 1e-3."""
    n = ref.shape[0]
    C = codebooks.shape[-1]
    ref = ref.reshape(n, -1).long().cpu()
    ours = ours.reshape(n, -1).long().cpu()
    books = codebooks[:n].float().cpu()
    residual = x.reshape(-1, C).float().cpu()
    bound = 2.0 * C * torch.finfo(torch.float32).eps
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
class ResidualVQ:
    """Quantizer config; `init_state` gives the codebook stack `embed`."""
    dim: int = 128
    codebook_size: int = 1024
    num_quantizers: int = 8
    kmeans_init: bool = True

    def init_state(self, gen: torch.Generator, device="cpu") -> VQState:
        """Zero codebooks when k-means init is pending (as in training),
        N(0, 1) codebooks from `gen` otherwise."""
        shape = (self.num_quantizers, self.codebook_size, self.dim)
        embed = (torch.zeros(shape) if self.kmeans_init
                 else torch.randn(shape, generator=gen))
        return {"embed": embed.to(device)}
