"""The codec wrapper of the frozen reference: encoder -> RVQ -> decoder.

A trimmed copy of the port's `models/codec.py` with its kernel wrappers
taken out: the quantizer here is the plain cascade of `ops/rvq.py`, and
there are no streaming drivers. `forward` is the training graph the
frozen train step drives; `encode_latent` / `decode_latent` are the
offline passes the streaming references compare against.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import rvq as Q

Params = Dict[str, Any]


def residual_vq(vq_kwargs: Dict[str, Any]) -> Q.ResidualVQ:
    """The Euclidean residual VQ of a config's `vq_kwargs`."""
    return Q.ResidualVQ(
        dim=vq_kwargs.get("dim", 128),
        codebook_size=vq_kwargs.get("codebook_size", 1024),
        num_quantizers=vq_kwargs.get("num_quantizers", 8),
        kmeans_init=vq_kwargs.get("kmeans_init", True),
        decay=vq_kwargs.get("decay", 0.99),
        ema_num_threshold=vq_kwargs.get("ema_num_threshold", 0.0),
        ema_num_initial=vq_kwargs.get("ema_num_initial", 1.0),
        dropout=vq_kwargs.get("dropout", False),
        dropout_index=tuple(vq_kwargs["dropout_index"])
        if vq_kwargs.get("dropout_index") else None)


@dataclasses.dataclass(frozen=True)
class CodecModel:
    """A codec and its quantizer, bound to a device."""
    codec: Any
    vq: Any
    device: torch.device

    @property
    def hop_length(self) -> int:
        return self.codec.hop_length

    def init(self, gen: torch.Generator) -> Tuple[Params, Q.VQState]:
        params = self.codec.init(gen, self.device)
        return params, self.vq.init_state(gen, self.device)

    def forward(self, params: Params, vq_state: Q.VQState, wav: torch.Tensor,
                draws: Optional[Q.RVQDraws] = None, training: bool = True,
                group=None):
        z = self.codec.encoder.apply(params["encoder"], wav)
        q, vq_state, loss_vq, num_replaces, _ = self.vq(
            z.float(), vq_state, draws, training, group)
        wav_g = self.codec.decoder.apply(params["decoder"], q.to(z.dtype))
        return wav_g.float(), vq_state, loss_vq, num_replaces

    def encode_latent(self, params: Params, wav: torch.Tensor
                      ) -> torch.Tensor:
        """wav [B, 1, T] -> latents [B, C, T / hop]."""
        return self.codec.encoder.apply(params["encoder"], wav)

    def decode_latent(self, params: Params, q: torch.Tensor) -> torch.Tensor:
        """quantized latents [B, C, L] -> wav [B, 1, L * hop]."""
        return self.codec.decoder.apply(params["decoder"], q)

    def fold_params(self, params: Params) -> Params:
        return self.codec.fold_params(params)
