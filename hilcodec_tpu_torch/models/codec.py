"""Full codec: encoder -> RVQ -> decoder, offline and streaming.

Counterpart of `hilcodec_tpu/models/codec.py`: one codec of any family
(HILCodec, `models/hilcodec.py`; EnCodec, `models/encodec.py`; Avocodo,
`models/avocodo.py`; AudioDec, `models/audiodec.py`) with its quantizer,
built by `models/registry.py`. A HILCodec config routes its quantizer by its `vq`
key (`vq_from_kwargs`): the residual VQ, none (`vq: ''`) or shape-gain
(`ops/shape_gain.py`); only the residual VQ has the Euclidean codebooks
token coding and the streaming drivers need. `forward` is the
training graph (encoder, training quantizer pass, decoder). The streaming drivers are
Python loops over frames (the JAX package's `lax.scan`), one encoder /
decoder step per frame, with the caches in the JAX order and the JAX
output shapes (tokens `[n, B, L]`, wav `[B, 1, L*hop]`). The quantizer is
the CUDA kernel wrapper `ops/rvq_kernel.quantize`, which runs the plain
version for CPU tensors only. The streaming drivers take
`frames_per_step` frames a step (1 by default), as the JAX drivers do.
`encode_stream` / `decode_stream` take `megakernel=True` to run each step
as one launch of the encoder / decoder frame kernel; it is off by default,
as in the JAX package, whose automatic choice never selects it, and a
codec the frame kernels do not cover (EnCodec, Avocodo, AudioDec) raises
for it. `cast_streaming_params` is the deployment precision cast of the
JAX package (`--dtype bf16w` / `bf16` of the bench): the streaming drivers
take their activation dtype from the caches, and the latents reach the
quantizer in f32 whatever the dtype, so token identity is decided in f32.
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
from ..ops.shape_gain import ShapeGainVQBridge
from .hilcodec import HILCodec, params_to

Params = Dict[str, Any]
Cache = List[torch.Tensor]


@functools.lru_cache(maxsize=16)
def _decoder_megakernel(decoder) -> decoder_kernel.DecoderMegakernel:
    return decoder_kernel.DecoderMegakernel(decoder)


@functools.lru_cache(maxsize=16)
def _encoder_megakernel(encoder) -> encoder_kernel.EncoderMegakernel:
    return encoder_kernel.EncoderMegakernel(encoder)


def cast_streaming_params(params: Params, dtype=torch.bfloat16,
                          kernels_only: bool = True) -> Params:
    """Deployment-time precision cast of a folded param tree: leaves of
    rank 3 or more (the conv kernels, nearly all the bytes) with
    kernels_only, every leaf without. Under `bf16w` (kernels only, f32
    activations) each conv widens its bf16-rounded weight to the input's
    dtype, so the arithmetic stays f32; `bf16` casts everything. The RVQ
    codebooks are not in this tree and stay f32."""
    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(leaf(v) for v in x)
        if x.ndim >= 3 or not kernels_only:
            return x.to(dtype)
        return x
    return leaf(params)


def residual_vq(vq_kwargs: Dict[str, Any]) -> Q.ResidualVQ:
    """The Euclidean residual VQ of a YAML `vq_kwargs` (the JAX registry's
    `_vq_from_kwargs`)."""
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


def vq_from_kwargs(model_kwargs: Dict[str, Any]):
    """The quantizer a HILCodec `model_kwargs` routes to by its `vq` key
    (JAX `CodecModel.from_config`): "ResidualVQ" (the default), "" for
    none (`NoVQ`, the ablation) or "ResidualShapeGainVQ"."""
    vq_name = model_kwargs.get("vq", "ResidualVQ")
    vq_kwargs = dict(model_kwargs.get("vq_kwargs") or {})
    if vq_name == "":
        return Q.NoVQ()
    if vq_name == "ResidualShapeGainVQ":
        return ShapeGainVQBridge.from_kwargs(vq_kwargs)
    if vq_name != "ResidualVQ":
        raise ValueError(f"Unknown vq: {vq_name!r} (supported: "
                         f"'ResidualVQ', 'ResidualShapeGainVQ', '')")
    return residual_vq(vq_kwargs)


def slot_axes(caches_a: List[torch.Tensor],
              caches_b: List[torch.Tensor]) -> List[int]:
    """The axis on which each pair of cache tensors, made at two batch
    sizes, differ in length: its batch (slot) axis."""
    return [next(i for i, (m, n) in enumerate(zip(a.shape, b.shape))
                 if m != n) for a, b in zip(caches_a, caches_b)]


def _require_frame_kernels(codec) -> None:
    """The frame kernels cover HILCodec only (JAX `_megakernel_supported`;
    the kernels' builders refuse a HILCodec variant they do not cover)."""
    if not isinstance(codec, HILCodec):
        raise ValueError(f"megakernel=True: the frame kernels run HILCodec "
                         f"only, not {type(codec).__name__}; stream it with "
                         f"megakernel=False")


@dataclasses.dataclass(frozen=True)
class CodecModel:
    """A codec (HILCodec, EnCodec, Avocodo or AudioDec) + its quantizer,
    bound to the device it runs on."""
    codec: Any
    vq: Any
    device: torch.device

    @classmethod
    def from_config(cls, model_kwargs: Dict[str, Any],
                    device=None) -> "CodecModel":
        """HILCodec from a YAML `model_kwargs`; `device=None` means CUDA
        and raises when it is unavailable."""
        return cls(HILCodec.from_config(model_kwargs),
                   vq_from_kwargs(model_kwargs), resolve_device(device))

    @property
    def hop_length(self) -> int:
        return self.codec.hop_length

    def init(self, gen: torch.Generator) -> Tuple[Params, Q.VQState]:
        """Seeded (params, vq_state) on the model's device."""
        params = self.codec.init(gen, self.device)
        return params, self.vq.init_state(gen, self.device)

    def seeded(self, random_books: bool = True) -> Tuple[Params, Q.VQState]:
        """Weights for a run without a checkpoint: `init` from seed 0 and,
        with random_books, N(0, 1) codebooks drawn after it from the same
        generator (the JAX CLIs' untrained operating point; no torch
        generator reproduces JAX's draws)."""
        gen = torch.Generator().manual_seed(0)
        params, vq_state = self.init(gen)
        if random_books and "embed" in vq_state:
            vq_state["embed"] = torch.randn(
                tuple(vq_state["embed"].shape), generator=gen
            ).to(self.device)
        return params, vq_state

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
                draws: Optional[Q.RVQDraws] = None, training: bool = True,
                group=None) -> Tuple[torch.Tensor, Q.VQState, torch.Tensor,
                                     torch.Tensor]:
        """wav [B, 1, T] -> (wav_g [B, 1, T], new_vq_state, loss_vq,
        num_replaces): encoder, RVQ (the kernel's stage indices, EMA update
        when training, straight-through output), decoder. `group`: the
        process group of a data-parallel step (its VQ statistics are
        summed over the ranks)."""
        z = self.codec.encoder.apply(params["encoder"], wav)
        q, vq_state, loss_vq, num_replaces, _ = self.vq(
            z.float(), vq_state, draws, training, group)
        wav_g = self.codec.decoder.apply(params["decoder"], q.to(z.dtype))
        return wav_g.float(), vq_state, loss_vq, num_replaces

    # -- offline (whole-utterance) coding -----------------------------------
    def _books(self, vq_state: Q.VQState) -> torch.Tensor:
        """The Euclidean codebooks token coding needs; a quantizer without
        them (`vq: ''`, shape-gain) reconstructs through `forward` only,
        as in the JAX package."""
        if not isinstance(self.vq, Q.ResidualVQ):
            raise ValueError(
                f"quantizer {type(self.vq).__name__} has no Euclidean "
                f"codebook: token encode / decode and the streaming drivers "
                f"are unavailable; reconstruct through forward")
        return vq_state["embed"]

    def encode(self, params: Params, vq_state: Q.VQState, wav: torch.Tensor,
               n: Optional[int] = None) -> torch.Tensor:
        """wav [B, 1, T] -> tokens [n, B, T/hop] (int32)."""
        books = self._books(vq_state)
        z = self.codec.encoder.apply(params["encoder"], wav)
        return rvq_kernel.quantize(z.transpose(1, 2).float(), books, n)

    def decode(self, params: Params, vq_state: Q.VQState,
               tokens: torch.Tensor):
        """tokens [n, B, T'] -> wav [B, 1, T'*hop] (Avocodo: the list of
        its three scales, as its decoder's apply gives them)."""
        q = Q.dequantize(tokens, self._books(vq_state))
        return self.codec.decoder.apply(params["decoder"], q.transpose(1, 2))

    # -- streaming ----------------------------------------------------------
    def _blocks(self, wav: torch.Tensor, frames_per_step: int
                ) -> List[torch.Tensor]:
        """wav [B, 1, L*hop] -> L / f steps of [B, 1, f*hop]."""
        hop = self.hop_length
        L = wav.shape[-1] // hop
        if frames_per_step < 1 or L % frames_per_step:
            raise ValueError(f"{L} frames are not a multiple of "
                             f"frames_per_step={frames_per_step}")
        n = frames_per_step * hop
        return [wav[:, :, i * n:(i + 1) * n]
                for i in range(L // frames_per_step)]

    def encode_stream(self, params: Params, vq_state: Q.VQState,
                      wav: torch.Tensor, cache: Cache,
                      n: Optional[int] = None, frames_per_step: int = 1,
                      megakernel: bool = False
                      ) -> Tuple[torch.Tensor, Cache]:
        """wav [B, 1, L*hop] -> (tokens [n, B, L], new_cache).

        Each step takes frames_per_step (f) frames: L must be a multiple of
        f, each step sees f*hop samples, and the token and cache shapes do
        not depend on f. The JAX driver's `unroll` and `stream_chunks` are
        XLA scheduling knobs and have no counterpart here.

        megakernel=True runs each step's encoder as one launch of the
        encoder frame kernel (ops/encoder_kernel.py; its plain version for
        CPU tensors) over f frames, on folded params; the cache list handed
        in and out keeps its order and shapes."""
        books = self._books(vq_state)
        step = self.codec.encoder.step
        if megakernel:
            _require_frame_kernels(self.codec)
            mk = _encoder_megakernel(self.codec.encoder)
            cache, step = mk.cache_to_time_major(cache), mk.step
        toks = []
        for x in self._blocks(wav, frames_per_step):
            z, cache = step(params["encoder"], cache, x)
            toks.append(rvq_kernel.quantize(z.transpose(1, 2).float(), books,
                                            n))
        if megakernel:
            cache = mk.cache_from_time_major(cache)
        return torch.cat(toks, dim=-1), cache

    def decode_stream(self, params: Params, vq_state: Q.VQState,
                      tokens: torch.Tensor, cache: Cache,
                      frames_per_step: int = 1, megakernel: bool = False
                      ) -> Tuple[torch.Tensor, Cache]:
        """tokens [n, B, L] -> (wav [B, 1, L*hop], new_cache).

        frames_per_step (f) frames a step, L a multiple of f (see
        encode_stream). megakernel=True runs each step's decoder as one
        launch of the decoder frame kernel (ops/decoder_kernel.py; its
        plain version for CPU tensors) over f frames, on folded params; the
        cache list handed in and out keeps its order and shapes."""
        books = self._books(vq_state)
        dtype = cache[0].dtype if cache else torch.float32
        L, f = tokens.shape[-1], frames_per_step
        if f < 1 or L % f:
            raise ValueError(f"{L} frames are not a multiple of "
                             f"frames_per_step={f}")
        step = self.codec.decoder.step
        if megakernel:
            _require_frame_kernels(self.codec)
            mk = _decoder_megakernel(self.codec.decoder)
            cache, step = mk.cache_to_time_major(cache), mk.step
        outs = []
        for t in range(0, L, f):
            q = Q.dequantize(tokens[:, :, t:t + f], books).to(dtype)
            y, cache = step(params["decoder"], cache, q.transpose(1, 2))
            outs.append(y)
        if megakernel:
            cache = mk.cache_from_time_major(cache)
        return torch.cat(outs, dim=-1), cache

    def encode_decode_stream(self, params: Params, vq_state: Q.VQState,
                             wav: torch.Tensor, cache_enc: Cache,
                             cache_dec: Cache, n: Optional[int] = None,
                             frames_per_step: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        Cache, Cache]:
        """Per step of frames_per_step frames: encoder step -> RVQ ->
        dequantize -> decoder step.

        wav [B, 1, L*hop] -> (tokens [n, B, L], wav_out [B, 1, L*hop],
        new cache_enc, new cache_dec)."""
        books = self._books(vq_state)
        dtype = cache_dec[0].dtype if cache_dec else torch.float32
        toks, outs = [], []
        for x in self._blocks(wav, frames_per_step):
            z, cache_enc = self.codec.encoder.step(params["encoder"],
                                                   cache_enc, x)
            idx = rvq_kernel.quantize(z.transpose(1, 2).float(), books, n)
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

    def cache_axes(self) -> Tuple[List[int], List[int]]:
        """The batch (slot) axis of each (encoder, decoder) cache tensor:
        0 for a conv cache, 1 for an LSTM's [layers, B, H] state."""
        one, two = self.codec.init_cache(1), self.codec.init_cache(2)
        return slot_axes(one[0], two[0]), slot_axes(one[1], two[1])

    def fold_params(self, params: Params) -> Params:
        """Deployment fold: weight norm removed, static scales merged."""
        return self.codec.fold_params(params)
