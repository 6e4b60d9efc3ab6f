"""Mimi, Kyutai's streaming speech codec (Défossez et al., "Moshi",
arXiv:2410.00037, §3.3; github.com/kyutai-labs/moshi, `models/loaders.py`).

24 kHz in, 12.5 Hz frames (hop 1920):

  encoder: SEANet (`EncodecEncoder` at lstm 0, no norm, identity skips,
           last kernel 3; 64 -> 1024 channels, ratios 8-6-5-4 run
           reversed) to 512 dims at 25 Hz -> a streaming transformer
           (`models/transformer.py`) -> a learnt down-conv (512 -> 512,
           k 4, stride 2, replicate padding, no bias) to 12.5 Hz;
  quantizer: `SplitResidualVQ`, a semantic RVQ of 1 codebook and an
           acoustic RVQ of 7, each behind its own 1x1 projection 512 ->
           256, both on the same latent; codebooks 2048 x 256, Euclidean;
  decoder: a depthwise transposed up-conv (k 4, stride 2, no bias) to
           25 Hz -> a second transformer -> SEANet (`EncodecDecoder`).

A frame step takes 1920 samples a stream: the SEANet step gives two 25 Hz
positions, the transformer steps over both, the down-conv gives one
latent; the decoder mirrors it. The caches are flat lists with the batch
on axis 0 (the transformers' ring KV caches and row positions
included), so `CodecModel.cache_axes` finds it.

The down-conv pads by replicating its first input, in `apply` and in
`step` (moshi's streaming conv fills its history with the first sample
on a row's first step): a row whose transformer position is 0 fills the
down-conv's cache from its first input.

`MimiCodecModel` is the `CodecModel` of this family: the same interface
(`init`, `seeded`, `encode` / `decode`, `encode_stream` /
`decode_stream`, `init_cache`, `cache_axes`, `fold_params`), with the
split quantizer's projections around K1 (`ops/rvq_kernel.quantize`, one
launch a quantizer: n = 1 and n = 7 at C = 256, K = 2048) and around the
dequantize. Its drivers open the codec's spans (`codec.encoder_step`,
`codec.quantize`, `codec.dequantize`, `codec.decoder_step`) and, inside
the steps, `mimi.encoder_transformer` / `mimi.decoder_transformer` once a
frame step. There are no frame kernels for Mimi: `megakernel=True`
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops import conv as C
from ..ops import reparam as R
from ..ops import rvq as Q
from ..ops import rvq_kernel
from ..utils.spans import span
from .codec import CodecModel, _require_frame_kernels
from .encodec import EncodecDecoder, EncodecEncoder
from .hilcodec import params_to
from .transformer import StreamingTransformer

Params = Dict[str, Any]
Cache = List[torch.Tensor]

# moshi `loaders.py`'s `_transformer_kwargs` (context 250 at 25 Hz)
TRANSFORMER_DEFAULTS = dict(d_model=512, num_heads=8, num_layers=8,
                            dim_feedforward=2048, context=250,
                            max_period=10000.0, layer_scale=0.01,
                            norm_eps=1e-5)


@dataclasses.dataclass(frozen=True)
class MimiEncoder:
    """SEANet -> transformer -> learnt down-conv (replicate padding)."""
    seanet: EncodecEncoder
    transformer: StreamingTransformer
    stride: int = 2

    @property
    def dimension(self) -> int:
        return self.seanet.dimension

    def init(self, gen: torch.Generator) -> Params:
        C_ = self.dimension
        k = 2 * self.stride
        s = 1.0 / (C_ * k) ** 0.5
        return {"seanet": self.seanet.init(gen),
                "transformer": self.transformer.init(gen),
                "down": {"w": torch.empty((C_, C_, k)).uniform_(
                    -s, s, generator=gen)}}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        y = self.seanet.apply(params["seanet"], x)
        y = self.transformer.apply(params["transformer"], y)
        return C.causal_conv1d(y, params["down"]["w"].to(y.dtype), None,
                               self.stride, pad_mode="edge")

    def _split(self, cache: Cache) -> Tuple[Cache, Cache, torch.Tensor]:
        n = sum(self.seanet._counts)
        m = 1 + 2 * self.transformer.num_layers
        return cache[:n], cache[n:n + m], cache[n + m]

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        down = torch.zeros((batch, self.dimension, self.stride),
                           dtype=dtype, device=device)
        return (self.seanet.init_cache(batch, dtype, device)
                + self.transformer.init_cache(batch, dtype, device)
                + [down])

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        cs, ct, cd = self._split(cache)
        y, cs = self.seanet.step(params["seanet"], cs, x)
        first = (ct[0] == 0)[:, None, None]
        with span("mimi.encoder_transformer"):
            y, ct = self.transformer.step(params["transformer"], ct, y)
        cd = torch.where(first, y[:, :, :1].expand_as(cd), cd)
        z, cd = C.causal_conv1d_step(y, cd, params["down"]["w"].to(y.dtype),
                                     None, self.stride)
        return z, cs + ct + [cd]


@dataclasses.dataclass(frozen=True)
class MimiDecoder:
    """Depthwise transposed up-conv -> transformer -> SEANet."""
    seanet: EncodecDecoder
    transformer: StreamingTransformer
    stride: int = 2

    @property
    def dimension(self) -> int:
        return self.seanet.dimension

    def init(self, gen: torch.Generator) -> Params:
        k = 2 * self.stride
        s = 1.0 / k ** 0.5
        return {"up": {"w": torch.empty((self.dimension, 1, k)).uniform_(
                    -s, s, generator=gen)},
                "transformer": self.transformer.init(gen),
                "seanet": self.seanet.init(gen)}

    def _up(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        return C.causal_conv_transpose1d(z, params["up"]["w"].to(z.dtype),
                                         None, self.stride,
                                         groups=self.dimension)

    def apply(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        y = self._up(params, z)
        y = self.transformer.apply(params["transformer"], y)
        return self.seanet.apply(params["seanet"], y)

    def _split(self, cache: Cache) -> Tuple[torch.Tensor, Cache, Cache]:
        m = 1 + 2 * self.transformer.num_layers
        return cache[0], cache[1:1 + m], cache[1 + m:]

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        up = torch.zeros((batch, self.dimension,
                          C.causal_conv_transpose1d_cache_len(
                              2 * self.stride, self.stride)),
                         dtype=dtype, device=device)
        return ([up] + self.transformer.init_cache(batch, dtype, device)
                + self.seanet.init_cache(batch, dtype, device))

    def step(self, params: Params, cache: Cache, z: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        cu, ct, cs = self._split(cache)
        y, cu = C.causal_conv_transpose1d_step(
            z, cu, params["up"]["w"].to(z.dtype), None, self.stride,
            groups=self.dimension)
        with span("mimi.decoder_transformer"):
            y, ct = self.transformer.step(params["transformer"], ct, y)
        y, cs = self.seanet.step(params["seanet"], cs, y)
        return y, [cu] + ct + cs


@dataclasses.dataclass(frozen=True)
class Mimi:
    """The codec without its quantizer (which `MimiCodecModel` attaches).
    Defaults are the published widths (moshi `_seanet_kwargs`,
    `_transformer_kwargs`)."""
    channels: int = 1
    n_filters: int = 64
    ratios: Tuple[int, ...] = (8, 6, 5, 4)
    dimension: int = 512
    n_residual_layers: int = 1
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_base: int = 2
    compress: int = 2
    true_skip: bool = True
    activation: str = "ELU"
    norm: str = R.NONE
    pad_mode: str = "constant"
    resample_stride: int = 2
    transformer: Tuple[Tuple[str, Any], ...] = tuple(
        TRANSFORMER_DEFAULTS.items())

    def __post_init__(self):
        shared = dict(channels=self.channels, dimension=self.dimension,
                      n_filters=self.n_filters,
                      n_residual_layers=self.n_residual_layers,
                      ratios=tuple(self.ratios), activation=self.activation,
                      norm=self.norm, kernel_size=self.kernel_size,
                      last_kernel_size=self.last_kernel_size,
                      residual_kernel_size=self.residual_kernel_size,
                      dilation_base=self.dilation_base,
                      true_skip=self.true_skip, compress=self.compress,
                      lstm=0, pad_mode=self.pad_mode)
        tkw = dict(TRANSFORMER_DEFAULTS, **dict(self.transformer))
        enc = MimiEncoder(EncodecEncoder(**shared),
                          StreamingTransformer(**tkw), self.resample_stride)
        dec = MimiDecoder(EncodecDecoder(**shared),
                          StreamingTransformer(**tkw), self.resample_stride)
        object.__setattr__(self, "encoder", enc)
        object.__setattr__(self, "decoder", dec)
        object.__setattr__(self, "hop_length",
                           enc.seanet.hop_length * self.resample_stride)

    @classmethod
    def from_config(cls, model_kwargs: Dict[str, Any]) -> "Mimi":
        """Build from a YAML `model_kwargs` (unknown keys ignored; the
        quantizer's are `vq` / `vq_kwargs`)."""
        keep = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in model_kwargs.items() if k in keep}
        if "ratios" in kw:
            kw["ratios"] = tuple(kw["ratios"])
        if "transformer" in kw:
            kw["transformer"] = tuple(sorted(dict(kw["transformer"]).items()))
        return cls(**kw)

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        """Seeded init: draws on the CPU from `gen`, then moves to device."""
        return params_to({"encoder": self.encoder.init(gen),
                          "decoder": self.decoder.init(gen)}, device)

    def init_cache(self, batch: int, dtype=torch.float32, device="cpu"
                   ) -> Tuple[Cache, Cache]:
        return (self.encoder.init_cache(batch, dtype, device),
                self.decoder.init_cache(batch, dtype, device))

    def fold_params(self, params: Params) -> Params:
        """No weight norm to fold (norm: none): the tree as it is."""
        return R.fold_tree(params, self.norm)


@dataclasses.dataclass(frozen=True)
class SplitResidualVQ:
    """Mimi's quantizer: `n_semantic` codebooks on one projection of the
    latent and the rest, a residual cascade, on another (moshi
    `SplitResidualVectorQuantizer`); decoding sums both output
    projections. State: `semantic` [n_semantic, K, C], `acoustic`
    [n_q - n_semantic, K, C], the input projections `semantic_in` /
    `acoustic_in` [C, input_dim] and the output ones `semantic_out` /
    `acoustic_out` [input_dim, C] (1x1 convs without bias)."""
    input_dim: int = 512
    dim: int = 256
    codebook_size: int = 2048
    num_quantizers: int = 8
    n_semantic: int = 1

    @classmethod
    def from_kwargs(cls, vq_kwargs: Dict[str, Any]) -> "SplitResidualVQ":
        keep = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vq_kwargs.items() if k in keep})

    def init_state(self, gen: torch.Generator, device="cpu"
                   ) -> Dict[str, torch.Tensor]:
        """N(0, 1) codebooks and torch's default 1x1-conv draws for the
        projections, from `gen`."""
        K, Cd, Ci = self.codebook_size, self.dim, self.input_dim
        ns = self.n_semantic

        def proj(out_f, in_f):
            s = 1.0 / in_f ** 0.5
            return torch.empty((out_f, in_f)).uniform_(-s, s, generator=gen)

        state = {"semantic": torch.randn((ns, K, Cd), generator=gen),
                 "acoustic": torch.randn((self.num_quantizers - ns, K, Cd),
                                         generator=gen),
                 "semantic_in": proj(Cd, Ci), "acoustic_in": proj(Cd, Ci),
                 "semantic_out": proj(Ci, Cd), "acoustic_out": proj(Ci, Cd)}
        return {k: v.to(device) for k, v in state.items()}

    def quantize(self, state: Dict[str, torch.Tensor], z: torch.Tensor,
                 n: Optional[int] = None) -> torch.Tensor:
        """z [B, input_dim, T] -> tokens [n, B, T] (int32): the semantic
        codebooks first, then the acoustic cascade; K1 for each."""
        n = self.num_quantizers if n is None else int(n)
        x = z.transpose(1, 2).float()
        ns = min(n, self.n_semantic)
        toks = [rvq_kernel.quantize(x @ state["semantic_in"].T,
                                    state["semantic"], ns)]
        if n > ns:
            toks.append(rvq_kernel.quantize(x @ state["acoustic_in"].T,
                                            state["acoustic"], n - ns))
        return torch.cat(toks, dim=0)

    def dequantize(self, state: Dict[str, torch.Tensor],
                   tokens: torch.Tensor) -> torch.Tensor:
        """tokens [n, B, T] -> [B, T, input_dim]: each quantizer's sum of
        codewords through its output projection, summed."""
        ns = self.n_semantic
        out = Q.dequantize(tokens[:ns], state["semantic"]) \
            @ state["semantic_out"].T
        if tokens.shape[0] > ns:
            out = out + Q.dequantize(tokens[ns:], state["acoustic"]) \
                @ state["acoustic_out"].T
        return out


@dataclasses.dataclass(frozen=True)
class MimiCodecModel(CodecModel):
    """`CodecModel` for Mimi and its split quantizer: `init`, `seeded`,
    `init_cache`, `cache_axes` and `fold_params` are `CodecModel`'s; the
    coding drivers put the quantizer's projections around K1 and the
    dequantize."""

    def encode(self, params, vq_state, wav, n=None):
        """wav [B, 1, T] -> tokens [n, B, T/hop] (int32)."""
        with span("codec.encoder_step"):
            z = self.codec.encoder.apply(params["encoder"], wav)
        with span("codec.quantize"):
            return self.vq.quantize(vq_state, z, n)

    def decode(self, params, vq_state, tokens):
        """tokens [n, B, T'] -> wav [B, 1, T'*hop]."""
        with span("codec.dequantize"):
            q = self.vq.dequantize(vq_state, tokens)
        with span("codec.decoder_step"):
            return self.codec.decoder.apply(params["decoder"],
                                            q.transpose(1, 2))

    def encode_stream(self, params, vq_state, wav, cache, n=None,
                      frames_per_step: int = 1, megakernel: bool = False):
        """wav [B, 1, L*hop] -> (tokens [n, B, L], new_cache), as
        `CodecModel.encode_stream`."""
        if megakernel:
            _require_frame_kernels(self.codec)
        toks = []
        for x in self._blocks(wav, frames_per_step):
            with span("codec.encoder_step"):
                z, cache = self.codec.encoder.step(params["encoder"], cache,
                                                   x)
            with span("codec.quantize"):
                toks.append(self.vq.quantize(vq_state, z, n))
        return torch.cat(toks, dim=-1), cache

    def decode_stream(self, params, vq_state, tokens, cache,
                      frames_per_step: int = 1, megakernel: bool = False):
        """tokens [n, B, L] -> (wav [B, 1, L*hop], new_cache), as
        `CodecModel.decode_stream`."""
        if megakernel:
            _require_frame_kernels(self.codec)
        dtype = cache[0].dtype if cache else torch.float32
        L, f = tokens.shape[-1], frames_per_step
        if f < 1 or L % f:
            raise ValueError(f"{L} frames are not a multiple of "
                             f"frames_per_step={f}")
        outs = []
        for t in range(0, L, f):
            with span("codec.dequantize"):
                q = self.vq.dequantize(vq_state,
                                       tokens[:, :, t:t + f]).to(dtype)
            with span("codec.decoder_step"):
                y, cache = self.codec.decoder.step(params["decoder"], cache,
                                                   q.transpose(1, 2))
            outs.append(y)
        return torch.cat(outs, dim=-1), cache

    def encode_decode_stream(self, params, vq_state, wav, cache_enc,
                             cache_dec, n=None, frames_per_step: int = 1):
        tok, cache_enc = self.encode_stream(params, vq_state, wav, cache_enc,
                                            n, frames_per_step)
        out, cache_dec = self.decode_stream(params, vq_state, tok, cache_dec,
                                            frames_per_step)
        return tok, out, cache_enc, cache_dec


def build_mimi(model_kwargs: Dict[str, Any], device=None) -> MimiCodecModel:
    """Mimi with its split quantizer (the `vq` key routes it,
    `models/codec.vq_from_kwargs`), on `device` (CUDA when None)."""
    from .. import resolve_device
    from .codec import vq_from_kwargs
    kw = dict(model_kwargs)
    kw.setdefault("vq", "SplitResidualVQ")
    return MimiCodecModel(Mimi.from_config(kw), vq_from_kwargs(kw),
                          resolve_device(device))
