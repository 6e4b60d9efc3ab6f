"""Full codec: encoder -> RVQ -> decoder, offline and streaming.

Counterpart of `hilcodec_tpu/models/codec.py`. `forward` is the training
graph (encoder, training RVQ pass, decoder). The streaming drivers are
Python loops over frames (the JAX package's `lax.scan`), one encoder /
decoder step per frame, with the caches in the JAX order and the JAX
output shapes (tokens `[n, B, L]`, wav `[B, 1, L*hop]`). The quantizer is
the CUDA kernel wrapper `ops/rvq_kernel.quantize`, which runs the plain
version for CPU tensors only. `encode_stream` / `decode_stream` take
`megakernel=True` to run each frame step as one launch of the encoder /
decoder frame kernel; it is off by default, as in the JAX package, whose
automatic choice never selects it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import resolve_device
from ..ops import decoder_kernel, encoder_kernel
from ..ops import rvq as Q
from ..ops import rvq_kernel
from .hilcodec import HILCodec, params_to

Params = Dict[str, Any]
Cache = List[torch.Tensor]


@functools.lru_cache(maxsize=16)
def _decoder_megakernel(decoder) -> decoder_kernel.DecoderMegakernel:
    return decoder_kernel.DecoderMegakernel(decoder)


@functools.lru_cache(maxsize=16)
def _encoder_megakernel(encoder) -> encoder_kernel.EncoderMegakernel:
    return encoder_kernel.EncoderMegakernel(encoder)


@dataclasses.dataclass(frozen=True)
class CodecModel:
    """HILCodec + residual VQ, bound to the device it runs on."""
    codec: HILCodec
    vq: Q.ResidualVQ
    device: torch.device

    @classmethod
    def from_config(cls, model_kwargs: Dict[str, Any],
                    device=None) -> "CodecModel":
        """Build from a YAML `model_kwargs`; `device=None` means CUDA and
        raises when it is unavailable."""
        vq_name = model_kwargs.get("vq", "ResidualVQ")
        if vq_name != "ResidualVQ":
            raise NotImplementedError(
                f"vq {vq_name!r} is not ported yet (see ROADMAP.md)")
        vq_kwargs = dict(model_kwargs.get("vq_kwargs", {}))
        vq = Q.ResidualVQ(
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
        return cls(HILCodec.from_config(model_kwargs), vq,
                   resolve_device(device))

    @property
    def hop_length(self) -> int:
        return self.codec.hop_length

    def init(self, gen: torch.Generator) -> Tuple[Params, Q.VQState]:
        """Seeded (params, vq_state) on the model's device."""
        params = self.codec.init(gen, self.device)
        return params, self.vq.init_state(gen, self.device)

    def param_template(self, folded: bool) -> Params:
        """A param tree with this model's names and shapes (CPU tensors)."""
        params = self.codec.init(torch.Generator().manual_seed(0))
        return self.fold_params(params) if folded else params

    def to_device(self, params: Params, vq_state: Q.VQState
                  ) -> Tuple[Params, Q.VQState]:
        return (params_to(params, self.device),
                {k: v.to(self.device) for k, v in vq_state.items()})

    # -- training graph -----------------------------------------------------
    def forward(self, params: Params, vq_state: Q.VQState, wav: torch.Tensor,
                draws: Optional[Q.RVQDraws] = None, training: bool = True
                ) -> Tuple[torch.Tensor, Q.VQState, torch.Tensor,
                           torch.Tensor]:
        """wav [B, 1, T] -> (wav_g [B, 1, T], new_vq_state, loss_vq,
        num_replaces): encoder, RVQ (the kernel's stage indices, EMA update
        when training, straight-through output), decoder."""
        z = self.codec.encoder.apply(params["encoder"], wav)
        q, vq_state, loss_vq, num_replaces, _ = self.vq(
            z.float(), vq_state, draws, training)
        wav_g = self.codec.decoder.apply(params["decoder"], q.to(z.dtype))
        return wav_g.float(), vq_state, loss_vq, num_replaces

    # -- offline (whole-utterance) coding -----------------------------------
    def encode(self, params: Params, vq_state: Q.VQState, wav: torch.Tensor,
               n: Optional[int] = None) -> torch.Tensor:
        """wav [B, 1, T] -> tokens [n, B, T/hop] (int32)."""
        z = self.codec.encoder.apply(params["encoder"], wav)
        return rvq_kernel.quantize(z.transpose(1, 2), vq_state["embed"], n)

    def decode(self, params: Params, vq_state: Q.VQState,
               tokens: torch.Tensor) -> torch.Tensor:
        """tokens [n, B, T'] -> wav [B, 1, T'*hop]."""
        q = Q.dequantize(tokens, vq_state["embed"])
        return self.codec.decoder.apply(params["decoder"], q.transpose(1, 2))

    # -- streaming ----------------------------------------------------------
    def _frames(self, wav: torch.Tensor) -> List[torch.Tensor]:
        hop = self.hop_length
        return [wav[:, :, t * hop:(t + 1) * hop]
                for t in range(wav.shape[-1] // hop)]

    def encode_stream(self, params: Params, vq_state: Q.VQState,
                      wav: torch.Tensor, cache: Cache,
                      n: Optional[int] = None, megakernel: bool = False
                      ) -> Tuple[torch.Tensor, Cache]:
        """wav [B, 1, L*hop] -> (tokens [n, B, L], new_cache).

        megakernel=True runs each frame's encoder step as one launch of the
        encoder frame kernel (ops/encoder_kernel.py; its plain version for
        CPU tensors), on folded params; the cache list handed in and out
        keeps its order and shapes."""
        books = vq_state["embed"]
        step = self.codec.encoder.step
        if megakernel:
            mk = _encoder_megakernel(self.codec.encoder)
            cache, step = mk.cache_to_time_major(cache), mk.step
        toks = []
        for x in self._frames(wav):
            z, cache = step(params["encoder"], cache, x)
            toks.append(rvq_kernel.quantize(z.transpose(1, 2), books, n))
        if megakernel:
            cache = mk.cache_from_time_major(cache)
        return torch.cat(toks, dim=-1), cache

    def decode_stream(self, params: Params, vq_state: Q.VQState,
                      tokens: torch.Tensor, cache: Cache,
                      megakernel: bool = False) -> Tuple[torch.Tensor, Cache]:
        """tokens [n, B, L] -> (wav [B, 1, L*hop], new_cache).

        megakernel=True runs each frame's decoder step as one launch of the
        decoder frame kernel (ops/decoder_kernel.py; its plain version for
        CPU tensors), on folded params; the cache list handed in and out
        keeps its order and shapes."""
        books = vq_state["embed"]
        dtype = cache[0].dtype if cache else torch.float32
        step = self.codec.decoder.step
        if megakernel:
            mk = _decoder_megakernel(self.codec.decoder)
            cache, step = mk.cache_to_time_major(cache), mk.step
        outs = []
        for t in range(tokens.shape[-1]):
            q = Q.dequantize(tokens[:, :, t:t + 1], books).to(dtype)
            y, cache = step(params["decoder"], cache, q.transpose(1, 2))
            outs.append(y)
        if megakernel:
            cache = mk.cache_from_time_major(cache)
        return torch.cat(outs, dim=-1), cache

    def encode_decode_stream(self, params: Params, vq_state: Q.VQState,
                             wav: torch.Tensor, cache_enc: Cache,
                             cache_dec: Cache, n: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        Cache, Cache]:
        """Per frame: encoder step -> RVQ -> dequantize -> decoder step.

        wav [B, 1, L*hop] -> (tokens [n, B, L], wav_out [B, 1, L*hop],
        new cache_enc, new cache_dec)."""
        books = vq_state["embed"]
        dtype = cache_dec[0].dtype if cache_dec else torch.float32
        toks, outs = [], []
        for x in self._frames(wav):
            z, cache_enc = self.codec.encoder.step(params["encoder"],
                                                   cache_enc, x)
            idx = rvq_kernel.quantize(z.transpose(1, 2), books, n)
            q = Q.dequantize(idx, books).to(dtype)
            y, cache_dec = self.codec.decoder.step(params["decoder"],
                                                   cache_dec,
                                                   q.transpose(1, 2))
            toks.append(idx)
            outs.append(y)
        return (torch.cat(toks, dim=-1), torch.cat(outs, dim=-1),
                cache_enc, cache_dec)

    def init_cache(self, batch: int, dtype=torch.float32, device=None
                   ) -> Tuple[Cache, Cache]:
        """Zero (encoder, decoder) caches, on the model's device unless
        another is named."""
        return self.codec.init_cache(batch, dtype, device or self.device)

    def fold_params(self, params: Params) -> Params:
        """Deployment fold: weight norm removed, static scales merged."""
        return self.codec.fold_params(params)
