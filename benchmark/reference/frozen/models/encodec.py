"""EnCodec family: SEANet encoder / decoder with an LSTM bottleneck.

Counterpart of `hilcodec_tpu/models/encodec.py` (SLSTM, EncodecResnetBlock,
EncodecEncoder, EncodecDecoder, EncodecModel) and of its token LM, the
entropy model of the range coder (`sin_embedding`,
StreamingTransformerEncoder, LMModel; see the section at the end). Same
single-spec,
dual-mode design as `models/hilcodec.py`: `apply` for training, `step` for
streaming with the JAX flat cache list (the conv caches `[B, C, len]`
and each LSTM's (h, c) pair `[layers, B, H]`, batch on axis 1).

Convolutions pad by reflection (`pad_mode: reflect`, the family's default)
in `apply` and stream with zero caches in `step`, as in the JAX package, so
the two differ at the start of a sequence by design.

The LSTM takes torch's layout and gate order (i, f, g, o) with
b_ih + b_hh, as the JAX tree stores them. On the card the recurrence is
`torch.lstm` (cuDNN), which keeps f32 under `set_f32_parity_mode`; on the
CPU it is an explicit cell whose products are `row_matmul`s, so that a row
gives the same bits alone as inside a slot batch. No TPU kernel computes
it in the JAX package either.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import conv as C
from ..ops import reparam as R
from . import layers as L
from .hilcodec import params_to

Params = Dict[str, Any]
Cache = List[torch.Tensor]


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLSTM:
    """Multi-layer LSTM over conv-layout [B, C, T] with a residual skip;
    streaming carries (h, c) as two cache tensors [num_layers, B, H]."""
    dimension: int
    num_layers: int = 2
    skip: bool = True

    def init(self, gen: torch.Generator) -> Params:
        H = self.dimension
        bound = 1.0 / math.sqrt(H)
        shapes = (("w_ih", (4 * H, H)), ("w_hh", (4 * H, H)),
                  ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))
        return {"layers": [
            {k: torch.empty(s).uniform_(-bound, bound, generator=gen)
             for k, s in shapes} for _ in range(self.num_layers)]}

    def _run_cpu(self, params: Params, seq: torch.Tensor, h0: torch.Tensor,
                 c0: torch.Tensor):
        """seq [T, B, H]: the JAX cell, gates = x W_ih^T + h W_hh^T
        + (b_ih + b_hh), with every product a row_matmul."""
        H = self.dimension
        hs, cs = [], []
        for li, p in enumerate(params["layers"]):
            xw = C.row_matmul(seq, p["w_ih"].T)
            w_hh, bias = p["w_hh"].T, p["b_ih"] + p["b_hh"]
            h, c = h0[li], c0[li]
            ys = []
            for t in range(seq.shape[0]):
                gates = xw[t] + C.row_matmul(h, w_hh) + bias
                i = torch.sigmoid(gates[:, :H])
                f = torch.sigmoid(gates[:, H:2 * H])
                g = torch.tanh(gates[:, 2 * H:3 * H])
                o = torch.sigmoid(gates[:, 3 * H:])
                c = f * c + i * g
                h = o * torch.tanh(c)
                ys.append(h)
            seq = torch.stack(ys)
            hs.append(h)
            cs.append(c)
        return seq, torch.stack(hs), torch.stack(cs)

    def _run(self, params: Params, x: torch.Tensor, h0: torch.Tensor,
             c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
        """x [B, C, T]; h0 / c0 [num_layers, B, H] -> (y, h, c)."""
        seq = x.permute(2, 0, 1)                      # [T, B, C]
        if x.device.type == "cpu":
            ys, h, c = self._run_cpu(params, seq, h0, c0)
        else:
            weights = [p[k].to(x.dtype) for p in params["layers"]
                       for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
            with warnings.catch_warnings():
                # the weights are separate tensors of the param tree, so
                # cuDNN packs them into one buffer a call (16 MB a call at
                # width 512, some microseconds) and warns about it
                warnings.filterwarnings("ignore", "RNN module weights")
                ys, h, c = torch.lstm(seq.contiguous(),
                                      (h0.contiguous(), c0.contiguous()),
                                      weights, True, self.num_layers, 0.0,
                                      torch.is_grad_enabled(), False, False)
        y = ys.permute(1, 2, 0)
        if self.skip:
            y = y + x
        return y, h, c

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h0, c0 = self.init_cache(x.shape[0], x.dtype, x.device)
        return self._run(params, x, h0, c0)[0]

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        # two tensors, never one aliased twice: the engine updates caches
        # in place
        return [torch.zeros((self.num_layers, batch, self.dimension),
                            dtype=dtype, device=device) for _ in range(2)]

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        y, h, c = self._run(params, x, cache[0], cache[1])
        return y, [h, c]


def _cache_counts(mods) -> Tuple[int, ...]:
    """The number of cache tensors of each module, counted once."""
    return tuple(len(m.init_cache(1)) for m in mods)


class _Steps:
    """Runs a sequence of sub-module steps over one flat cache list, the
    modules taking `counts` tensors each, in order."""

    def __init__(self, cache: Cache, counts: Tuple[int, ...]):
        self.cache, self.counts, self.new, self.i, self.k = \
            cache, counts, [], 0, 0

    def __call__(self, mod, params: Params, x: torch.Tensor) -> torch.Tensor:
        n = self.counts[self.k]
        y, c = mod.step(params, self.cache[self.i:self.i + n], x)
        self.new.extend(c)
        self.i += n
        self.k += 1
        return y


# ---------------------------------------------------------------------------
# residual block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EncodecResnetBlock:
    """[act -> conv(k, d) dim->hidden -> act -> conv(1) hidden->dim] + skip
    (identity with true_skip, else a 1x1 conv)."""
    dim: int
    kernel_sizes: Tuple[int, ...] = (3, 1)
    dilations: Tuple[int, ...] = (1, 1)
    activation: str = "ELU"
    activation_params: Optional[dict] = None
    norm: str = R.WEIGHT_NORM
    compress: int = 2
    true_skip: bool = False
    pad_mode: str = "reflect"

    def __post_init__(self):
        hidden = self.dim // self.compress
        convs = []
        for i, (k, d) in enumerate(zip(self.kernel_sizes, self.dilations)):
            cin = self.dim if i == 0 else hidden
            cout = self.dim if i == len(self.kernel_sizes) - 1 else hidden
            convs.append(L.Conv1d(cin, cout, k, dilation=d, norm=self.norm,
                                  pad_mode=self.pad_mode))
        object.__setattr__(self, "convs", tuple(convs))
        object.__setattr__(self, "_counts", _cache_counts(convs))
        object.__setattr__(self, "_act", L.activation(
            self.activation, self.activation_params))
        object.__setattr__(self, "shortcut", None if self.true_skip else
                           L.Conv1d(self.dim, self.dim, 1, norm=self.norm))

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"convs": [c.init(gen) for c in self.convs]}
        if self.shortcut is not None:
            p["shortcut"] = self.shortcut.init(gen)
        return p

    def _skip(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut is None:
            return x
        return self.shortcut.apply(params["shortcut"], x)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        y = x
        for conv, cp in zip(self.convs, params["convs"]):
            y = conv.apply(cp, self._act(y))
        return self._skip(params, x) + y

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        return [t for c in self.convs
                for t in c.init_cache(batch, dtype, device)]

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        run = _Steps(cache, self._counts)
        y = x
        for conv, cp in zip(self.convs, params["convs"]):
            y = run(conv, cp, self._act(y))
        return self._skip(params, x) + y, run.new


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------

def _block(dim: int, j: int, cfg) -> EncodecResnetBlock:
    return EncodecResnetBlock(
        dim, kernel_sizes=(cfg.residual_kernel_size, 1),
        dilations=(cfg.dilation_base ** j, 1), activation=cfg.activation,
        activation_params=cfg.activation_params, norm=cfg.norm,
        compress=cfg.compress, true_skip=cfg.true_skip,
        pad_mode=cfg.pad_mode)


@dataclasses.dataclass(frozen=True)
class EncodecEncoder:
    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 1
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    activation: str = "ELU"
    activation_params: Optional[dict] = None
    norm: str = R.WEIGHT_NORM
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    true_skip: bool = False
    compress: int = 2
    lstm: int = 2
    pad_mode: str = "reflect"

    def __post_init__(self):
        # the encoder runs the ratios reversed (2, 4, 5, 8 by default)
        ratios = tuple(reversed(self.ratios))
        object.__setattr__(self, "hop_length", int(np.prod(ratios)))
        conv_pre = L.Conv1d(self.channels, self.n_filters, self.kernel_size,
                            norm=self.norm, pad_mode=self.pad_mode)
        stages, mult = [], 1
        for ratio in ratios:
            dim = mult * self.n_filters
            blocks = tuple(_block(dim, j, self)
                           for j in range(self.n_residual_layers))
            down = L.Conv1d(dim, dim * 2, ratio * 2, stride=ratio,
                            norm=self.norm, pad_mode=self.pad_mode)
            stages.append((blocks, down))
            mult *= 2
        slstm = SLSTM(mult * self.n_filters, self.lstm) if self.lstm \
            else None
        conv_post = L.Conv1d(mult * self.n_filters, self.dimension,
                             self.last_kernel_size, norm=self.norm,
                             pad_mode=self.pad_mode)
        object.__setattr__(self, "conv_pre", conv_pre)
        object.__setattr__(self, "stages", tuple(stages))
        object.__setattr__(self, "slstm", slstm)
        object.__setattr__(self, "conv_post", conv_post)
        object.__setattr__(self, "_act", L.activation(
            self.activation, self.activation_params))
        object.__setattr__(self, "_counts", _cache_counts(self._modules()))

    def _modules(self):
        """Modules in cache order: conv_pre, per stage its blocks then its
        down conv, the LSTM, conv_post."""
        mods = [self.conv_pre]
        for blocks, down in self.stages:
            mods += [*blocks, down]
        if self.slstm is not None:
            mods.append(self.slstm)
        return mods + [self.conv_post]

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"conv_pre": self.conv_pre.init(gen), "stages": []}
        for blocks, down in self.stages:
            p["stages"].append({"blocks": [b.init(gen) for b in blocks],
                                "down": down.init(gen)})
        if self.slstm is not None:
            p["lstm"] = self.slstm.init(gen)
        p["conv_post"] = self.conv_post.init(gen)
        return p

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre.apply(params["conv_pre"], x)
        for (blocks, down), sp in zip(self.stages, params["stages"]):
            for b, bp in zip(blocks, sp["blocks"]):
                x = b.apply(bp, x)
            x = down.apply(sp["down"], self._act(x))
        if self.slstm is not None:
            x = self.slstm.apply(params["lstm"], x)
        return self.conv_post.apply(params["conv_post"], self._act(x))

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        return [t for m in self._modules()
                for t in m.init_cache(batch, dtype, device)]

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        run = _Steps(cache, self._counts)
        x = run(self.conv_pre, params["conv_pre"], x)
        for (blocks, down), sp in zip(self.stages, params["stages"]):
            for b, bp in zip(blocks, sp["blocks"]):
                x = run(b, bp, x)
            x = run(down, sp["down"], self._act(x))
        if self.slstm is not None:
            x = run(self.slstm, params["lstm"], x)
        x = run(self.conv_post, params["conv_post"],
                self._act(x))
        return x, run.new


@dataclasses.dataclass(frozen=True)
class EncodecDecoder:
    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 1
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    activation: str = "ELU"
    activation_params: Optional[dict] = None
    norm: str = R.WEIGHT_NORM
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    true_skip: bool = False
    compress: int = 2
    lstm: int = 2
    final_activation: Optional[str] = None
    pad_mode: str = "reflect"

    def __post_init__(self):
        object.__setattr__(self, "hop_length", int(np.prod(self.ratios)))
        mult = int(2 ** len(self.ratios))
        conv_pre = L.Conv1d(self.dimension, mult * self.n_filters,
                            self.kernel_size, norm=self.norm,
                            pad_mode=self.pad_mode)
        slstm = SLSTM(mult * self.n_filters, self.lstm) if self.lstm \
            else None
        stages = []
        for ratio in self.ratios:
            dim = mult * self.n_filters
            up = L.ConvTranspose1d(dim, dim // 2, ratio * 2, stride=ratio,
                                   norm=self.norm)
            blocks = tuple(_block(dim // 2, j, self)
                           for j in range(self.n_residual_layers))
            stages.append((up, blocks))
            mult //= 2
        conv_post = L.Conv1d(self.n_filters, self.channels,
                             self.last_kernel_size, norm=self.norm,
                             pad_mode=self.pad_mode)
        object.__setattr__(self, "conv_pre", conv_pre)
        object.__setattr__(self, "slstm", slstm)
        object.__setattr__(self, "stages", tuple(stages))
        object.__setattr__(self, "conv_post", conv_post)
        object.__setattr__(self, "_act", L.activation(
            self.activation, self.activation_params))
        object.__setattr__(self, "_final_act", L.activation(
            self.final_activation or "Identity", None))
        object.__setattr__(self, "_counts", _cache_counts(self._modules()))

    def _modules(self):
        """Modules in cache order: conv_pre, the LSTM, per stage its up
        conv then its blocks, conv_post."""
        mods = [self.conv_pre]
        if self.slstm is not None:
            mods.append(self.slstm)
        for up, blocks in self.stages:
            mods += [up, *blocks]
        return mods + [self.conv_post]

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"conv_pre": self.conv_pre.init(gen), "stages": []}
        if self.slstm is not None:
            p["lstm"] = self.slstm.init(gen)
        for up, blocks in self.stages:
            p["stages"].append({"up": up.init(gen),
                                "blocks": [b.init(gen) for b in blocks]})
        p["conv_post"] = self.conv_post.init(gen)
        return p

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre.apply(params["conv_pre"], x)
        if self.slstm is not None:
            x = self.slstm.apply(params["lstm"], x)
        for (up, blocks), sp in zip(self.stages, params["stages"]):
            x = up.apply(sp["up"], self._act(x))
            for b, bp in zip(blocks, sp["blocks"]):
                x = b.apply(bp, x)
        x = self.conv_post.apply(params["conv_post"], self._act(x))
        return self._final_act(x)

    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        return [t for m in self._modules()
                for t in m.init_cache(batch, dtype, device)]

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        run = _Steps(cache, self._counts)
        x = run(self.conv_pre, params["conv_pre"], x)
        if self.slstm is not None:
            x = run(self.slstm, params["lstm"], x)
        for (up, blocks), sp in zip(self.stages, params["stages"]):
            x = run(up, sp["up"], self._act(x))
            for b, bp in zip(blocks, sp["blocks"]):
                x = run(b, bp, x)
        x = run(self.conv_post, params["conv_post"],
                self._act(x))
        return self._final_act(x), run.new


@dataclasses.dataclass(frozen=True)
class EncodecModel:
    """The EnCodec encoder and decoder; the quantizer is attached by
    `CodecModel`, as for HILCodec."""
    sample_rate: int = 24000
    channels_audio: int = 1
    channels_enc: int = 32
    channels_dec: int = 32
    n_residual_layers: int = 1
    strides: Tuple[int, ...] = (8, 5, 4, 2)
    activation: str = "ELU"
    norm: str = R.WEIGHT_NORM
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    true_skip: bool = False
    compress: int = 2
    lstm: int = 2
    final_activation: Optional[str] = None
    vq_dim: int = 128
    pad_mode: str = "reflect"

    def __post_init__(self):
        shared = dict(
            n_residual_layers=self.n_residual_layers,
            ratios=tuple(self.strides), activation=self.activation,
            norm=self.norm, kernel_size=self.kernel_size,
            last_kernel_size=self.last_kernel_size,
            residual_kernel_size=self.residual_kernel_size,
            dilation_base=self.dilation_base, true_skip=self.true_skip,
            compress=self.compress, lstm=self.lstm, pad_mode=self.pad_mode)
        enc = EncodecEncoder(self.channels_audio, self.vq_dim,
                             self.channels_enc, **shared)
        dec = EncodecDecoder(self.channels_audio, self.vq_dim,
                             self.channels_dec,
                             final_activation=self.final_activation,
                             **shared)
        object.__setattr__(self, "encoder", enc)
        object.__setattr__(self, "decoder", dec)
        object.__setattr__(self, "hop_length", enc.hop_length)

    @classmethod
    def from_config(cls, model_kwargs: Dict[str, Any]) -> "EncodecModel":
        """Build from a YAML `model_kwargs` dict (unknown keys ignored, as
        the JAX registry does)."""
        keep = {f.name for f in dataclasses.fields(cls)}
        mapped = {k: v for k, v in model_kwargs.items() if k in keep}
        if "strides" in mapped:
            mapped["strides"] = tuple(mapped["strides"])
        mapped["vq_dim"] = (model_kwargs.get("vq_kwargs") or {}).get(
            "dim", 128)
        return cls(**mapped)

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        """Seeded init: draws on the CPU from `gen`, then moves to device."""
        return params_to({"encoder": self.encoder.init(gen),
                          "decoder": self.decoder.init(gen)}, device)

    def init_cache(self, batch: int, dtype=torch.float32, device="cpu"
                   ) -> Tuple[Cache, Cache]:
        return (self.encoder.init_cache(batch, dtype, device),
                self.decoder.init_cache(batch, dtype, device))

    def fold_params(self, params: Params) -> Params:
        """Deployment fold: weight norm removed from every conv; the LSTM
        weights pass through."""
        return R.fold_tree(params, self.norm)


# ---------------------------------------------------------------------------
# Streaming transformer LM: the entropy model over RVQ tokens
# ---------------------------------------------------------------------------
#
# Plain products and a masked softmax, as the JAX LM (plain jnp, no Pallas
# kernel): `torch.matmul` on the card, so that both coder directions run
# one known program.

def sin_embedding(positions: torch.Tensor, dim: int,
                  max_period: float = 10000.0) -> torch.Tensor:
    """[..., T] positions -> [..., T, dim]: cos then sin of position /
    max_period ** (i / (half - 1))."""
    half = dim // 2
    adim = torch.arange(half, device=positions.device,
                        dtype=torch.float32)[None, None, :]
    phase = positions[..., None].float() / (max_period
                                            ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def _layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


@dataclasses.dataclass(frozen=True)
class StreamingTransformerEncoder:
    """Past-context-masked causal self-attention carrying its states:
    post-norm layers (torch's norm_first=False); each layer's state is its
    last `past_context` input frames."""
    dim: int
    hidden_scale: float = 4.0
    num_heads: int = 8
    num_layers: int = 5
    max_period: float = 10000.0
    past_context: int = 1000
    gelu: bool = True
    norm_in: bool = True

    def init(self, gen: torch.Generator) -> Params:
        C, H = self.dim, int(self.dim * self.hidden_scale)

        def uniform(shape, s):
            return torch.empty(shape).uniform_(-s, s, generator=gen)

        layers = []
        for _ in range(self.num_layers):
            s = 1.0 / math.sqrt(C)
            layers.append({
                "in_proj_w": uniform((3 * C, C), s),
                "in_proj_b": torch.zeros(3 * C),
                "out_proj_w": uniform((C, C), s),
                "out_proj_b": torch.zeros(C),
                "lin1_w": uniform((H, C), s), "lin1_b": torch.zeros(H),
                "lin2_w": uniform((C, H), 1.0 / math.sqrt(H)),
                "lin2_b": torch.zeros(C),
                "norm1_g": torch.ones(C), "norm1_b": torch.zeros(C),
                "norm2_g": torch.ones(C), "norm2_b": torch.zeros(C)})
        p: Params = {"layers": layers}
        if self.norm_in:
            p["norm_in_g"] = torch.ones(C)
            p["norm_in_b"] = torch.zeros(C)
        return p

    def _attn(self, p: Params, x: torch.Tensor,
              x_past: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        H = self.num_heads
        hd = C // H
        keys_in = torch.cat([x_past, x], dim=1)
        Tk = keys_in.shape[1]
        w, b = p["in_proj_w"], p["in_proj_b"]
        q = x @ w[:C].T + b[:C]
        k = keys_in @ w[C:2 * C].T + b[C:2 * C]
        v = keys_in @ w[2 * C:].T + b[2 * C:]
        q = q.reshape(B, T, H, hd).transpose(1, 2)
        k = k.reshape(B, Tk, H, hd).transpose(1, 2)
        v = v.reshape(B, Tk, H, hd).transpose(1, 2)
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
        hist = x_past.shape[1]
        delta = (torch.arange(hist, T + hist, device=x.device)[:, None]
                 - torch.arange(Tk, device=x.device)[None, :])
        valid = (delta >= 0) & (delta <= self.past_context)
        scores = scores.masked_fill(~valid[None, None], float("-inf"))
        out = torch.softmax(scores, dim=-1) @ v
        out = out.transpose(1, 2).reshape(B, T, C)
        return out @ p["out_proj_w"].T + p["out_proj_b"]

    def apply(self, params: Params, x: torch.Tensor,
              states: Optional[List[torch.Tensor]] = None, offset: int = 0
              ) -> Tuple[torch.Tensor, List[torch.Tensor], int]:
        """x: [B, T, C] -> (y, new_states, new_offset). With no states the
        first frame attends one zero state frame at position -1."""
        B, T, C = x.shape
        if states is None:
            states = [x.new_zeros((B, 1, C))
                      for _ in range(self.num_layers)]
        pos = torch.arange(T, device=x.device)[None, :] + offset
        if self.norm_in:
            x = _layer_norm(x, params["norm_in_g"], params["norm_in_b"])
        x = x + sin_embedding(pos, C, self.max_period).to(x.dtype)
        new_states = []
        for p, st in zip(params["layers"], states):
            sa_input = x
            x = _layer_norm(x + self._attn(p, x, st), p["norm1_g"],
                            p["norm1_b"])
            h = x @ p["lin1_w"].T + p["lin1_b"]
            h = _gelu(h) if self.gelu else torch.relu(h)
            x = _layer_norm(x + h @ p["lin2_w"].T + p["lin2_b"],
                            p["norm2_g"], p["norm2_b"])
            new_states.append(torch.cat([st, sa_input],
                                        dim=1)[:, -self.past_context:])
        return x, new_states, offset + T


@dataclasses.dataclass(frozen=True)
class LMModel:
    """Entropy model over RVQ tokens: summed per-codebook embeddings ->
    streaming transformer -> per-codebook softmax heads."""
    n_q: int = 32
    card: int = 1024
    dim: int = 200
    num_heads: int = 8
    num_layers: int = 5
    past_context: int = 1000

    def __post_init__(self):
        object.__setattr__(self, "transformer", StreamingTransformerEncoder(
            dim=self.dim, num_heads=self.num_heads,
            num_layers=self.num_layers, past_context=self.past_context))

    def init(self, gen: torch.Generator, device="cpu") -> Params:
        """Seeded init: draws on the CPU from `gen`, then moves to device."""
        s = 1.0 / math.sqrt(self.dim)
        emb = torch.randn((self.n_q, self.card + 1, self.dim), generator=gen)
        lin_w = torch.empty((self.n_q, self.card, self.dim)).uniform_(
            -s, s, generator=gen)
        return params_to({"emb": emb, "lin_w": lin_w,
                          "lin_b": torch.zeros((self.n_q, self.card)),
                          "transformer": self.transformer.init(gen)}, device)

    def apply(self, params: Params, indices: torch.Tensor,
              states: Optional[List[torch.Tensor]] = None, offset: int = 0):
        """indices: [B, n_q, T] (1 + codebook index; 0 = missing) ->
        (probs [B, card, n_q, T], states, offset)."""
        B, K, T = indices.shape
        emb = params["emb"]
        x = emb.new_zeros((B, T, self.dim))
        for k in range(K):
            x = x + emb[k][indices[:, k].long()]
        out, states, offset = self.transformer.apply(
            params["transformer"], x, states, offset)
        logits = torch.einsum("btc,kvc->bvkt", out, params["lin_w"]) \
            + params["lin_b"].T[None, :, :, None]
        return torch.softmax(logits, dim=1), states, offset
