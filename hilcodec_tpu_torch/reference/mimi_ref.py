"""Plain reference of Mimi's forward, whole sequence, in f32.

Written from the published description (Défossez et al., "Moshi",
arXiv:2410.00037, §3.3) and kyutai-labs/moshi's `models/loaders.py`
(`_seanet_kwargs`, `_quantizer_kwargs`, `_transformer_kwargs`), with
torch and math alone: it imports no module of the port. Every product is
`torch.matmul` / `F.conv1d` in IEEE f32 (`set_f32` turns TF32 off; each
entry point calls it).

  encode_latent: SEANet encoder (causal convs, left padding
      d(k-1) - (s-1) of zeros, right padding to a full last window; ELU;
      one residual block a stage with an identity skip) -> transformer
      over the whole sequence (pre-LayerNorm, RoPE in interleaved pairs,
      causal attention over the 250 latest positions, LayerScale on each
      branch, exact GELU, no biases, no final norm) -> learnt down-conv
      (k 4, stride 2, replicate padding, no bias).
  quantize: the split RVQ as nearest-codeword products: 1 semantic
      codebook on one 1x1 projection of the latent, 7 acoustic codebooks
      as a residual cascade on another; distance ||r||^2 - 2 r.e + ||e||^2,
      first index of the minimum.
  decode_latent / decode: the sum of both quantizers' codewords through
      their output projections -> depthwise transposed up-conv (k 4,
      stride 2, its first L*s samples) -> transformer -> SEANet decoder
      (transposed convs cut to L*s samples).

The weights are a nested dict named as the port's tree (`models/mimi.py`):
conv dicts `{w[, b]}`, transformer layers `{norm1_g, norm1_b, in_proj_w,
out_proj_w, scale1, norm2_g, norm2_b, lin1_w, lin2_w, scale2}`, and the
quantizer's `{semantic, acoustic, semantic_in, acoustic_in, semantic_out,
acoustic_out}`.

Departures from moshi's code:
  * 8 of the checkpoint's 32 codebooks (1 + 7), as Moshi deploys it.
  * Codebooks are given as tensors; moshi keeps `embedding_sum` /
    `cluster_usage` and divides them (the quotient is this codebook).
  * The quantizers' 1x1 projections are matrix products (moshi: Conv1d
    with kernel 1 and no bias: the same sums).
  * Attention is written as products and a softmax with an additive
    -inf mask (moshi calls `scaled_dot_product_attention` with a boolean
    mask: the same function up to rounding).
  * No streaming state: the whole sequence at once. moshi's streaming
    down-conv fills its history with the first input, which is this
    replicate padding.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def set_f32() -> None:
    """IEEE f32 products and convolutions: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- convolutions -------------------------------------------------------------

def causal_conv(x: torch.Tensor, p: Params, stride: int = 1,
                dilation: int = 1, groups: int = 1,
                mode: str = "constant") -> torch.Tensor:
    """moshi's causal StreamingConv1d over a whole sequence."""
    w = p["w"]
    k = w.shape[-1]
    pad = dilation * (k - 1) - (stride - 1)
    L = x.shape[-1]
    n_frames = (L - k + pad) / stride + 1
    extra = (math.ceil(n_frames) - 1) * stride + k - pad - L
    x = F.pad(x, (pad, extra), mode="constant" if mode == "constant"
              else "replicate")
    return F.conv1d(x, w, p.get("b"), stride=stride, dilation=dilation,
                    groups=groups)


def causal_conv_tr(x: torch.Tensor, p: Params, stride: int,
                   groups: int = 1) -> torch.Tensor:
    """moshi's causal StreamingConvTranspose1d: the full transposed conv
    with its last k - s samples trimmed (L*s samples)."""
    y = F.conv_transpose1d(x, p["w"], p.get("b"), stride=stride,
                           groups=groups)
    return y[..., :x.shape[-1] * stride]


def _resblock(x: torch.Tensor, p: Params, dilation: int) -> torch.Tensor:
    """Identity skip + [ELU, conv(k, dilation), ELU, conv(1)]."""
    y = causal_conv(F.elu(x), p["convs"][0], dilation=dilation)
    y = causal_conv(F.elu(y), p["convs"][1])
    return x + y


def seanet_encoder(p: Params, x: torch.Tensor, ratios: List[int],
                   dilation_base: int = 2) -> torch.Tensor:
    """wav [B, 1, T] -> [B, dimension, T / prod(ratios)]."""
    x = causal_conv(x, p["conv_pre"])
    for r, sp in zip(list(reversed(ratios)), p["stages"]):
        for j, bp in enumerate(sp["blocks"]):
            x = _resblock(x, bp, dilation_base ** j)
        x = causal_conv(F.elu(x), sp["down"], stride=r)
    return causal_conv(F.elu(x), p["conv_post"])


def seanet_decoder(p: Params, x: torch.Tensor, ratios: List[int],
                   dilation_base: int = 2) -> torch.Tensor:
    """[B, dimension, L] -> wav [B, 1, L * prod(ratios)]."""
    x = causal_conv(x, p["conv_pre"])
    for r, sp in zip(ratios, p["stages"]):
        x = causal_conv_tr(F.elu(x), sp["up"], r)
        for j, bp in enumerate(sp["blocks"]):
            x = _resblock(x, bp, dilation_base ** j)
    return causal_conv(F.elu(x), p["conv_post"])


# -- transformer --------------------------------------------------------------

def rope(x: torch.Tensor, max_period: float) -> torch.Tensor:
    """x [B, H, T, D] at positions 0..T-1, rotated in interleaved pairs
    (x[2i], x[2i+1]) by t * max_period ** (-2i / D)."""
    B, H, T, D = x.shape
    i = torch.arange(D // 2, device=x.device, dtype=torch.float32)
    freqs = torch.exp(i * (-math.log(max_period) * 2.0 / D))
    t = torch.arange(T, device=x.device, dtype=torch.float32)
    ang = t[:, None] * freqs[None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    xr, xi = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = xr * c - xi * s
    out[..., 1::2] = xr * s + xi * c
    return out


def transformer(p: Params, x: torch.Tensor, num_heads: int, context: int,
                max_period: float = 10000.0, eps: float = 1e-5
                ) -> torch.Tensor:
    """x [B, C, T] -> [B, C, T]: each position attends to the `context`
    latest positions, itself included."""
    B, C, T = x.shape
    D = C // num_heads
    t = torch.arange(T, device=x.device)
    delta = t[:, None] - t[None, :]
    mask = torch.zeros((T, T), device=x.device, dtype=x.dtype)
    mask[(delta < 0) | (delta >= context)] = float("-inf")
    h = x.transpose(1, 2)
    for lp in p["layers"]:
        y = F.layer_norm(h, (C,), lp["norm1_g"], lp["norm1_b"], eps)
        qkv = torch.matmul(y, lp["in_proj_w"].T)
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, T, num_heads, D)
                   .transpose(1, 2) for i in range(3))
        q, k = rope(q, max_period), rope(k, max_period)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D) + mask
        a = torch.matmul(torch.softmax(scores, dim=-1), v)
        a = a.transpose(1, 2).reshape(B, T, C)
        h = h + lp["scale1"] * torch.matmul(a, lp["out_proj_w"].T)
        y = F.layer_norm(h, (C,), lp["norm2_g"], lp["norm2_b"], eps)
        y = torch.matmul(F.gelu(torch.matmul(y, lp["lin1_w"].T)),
                         lp["lin2_w"].T)
        h = h + lp["scale2"] * y
    return h.transpose(1, 2)


# -- the codec ------------------------------------------------------------------

def _tkw(cfg: Dict[str, Any]) -> Dict[str, Any]:
    t = cfg["transformer"]
    return dict(num_heads=t["num_heads"], context=t["context"],
                max_period=t["max_period"], eps=t["norm_eps"])


def encode_latent(params: Params, cfg: Dict[str, Any],
                  wav: torch.Tensor) -> torch.Tensor:
    """wav [B, 1, T] -> latents [B, 512, T / 1920] at 12.5 Hz. `cfg` is
    the model's `model_kwargs`."""
    set_f32()
    p = params["encoder"]
    x = seanet_encoder(p["seanet"], wav, cfg["ratios"],
                       cfg["dilation_base"])
    x = transformer(p["transformer"], x, **_tkw(cfg))
    return causal_conv(x, p["down"], stride=cfg["resample_stride"],
                       mode="replicate")


def decode_latent(params: Params, cfg: Dict[str, Any],
                  z: torch.Tensor) -> torch.Tensor:
    """latents [B, 512, L] -> wav [B, 1, L * 1920]."""
    set_f32()
    p = params["decoder"]
    x = causal_conv_tr(z, p["up"], cfg["resample_stride"],
                       groups=z.shape[1])
    x = transformer(p["transformer"], x, **_tkw(cfg))
    return seanet_decoder(p["seanet"], x, cfg["ratios"],
                          cfg["dilation_base"])


def nearest(r: torch.Tensor, books: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual cascade of r [M, C] over books [n, K, C]: (indices
    [n, M], the sum of the chosen codewords [M, C])."""
    out, acc = [], torch.zeros_like(r)
    for e in books:
        d = ((r * r).sum(1, keepdim=True) - 2.0 * torch.matmul(r, e.T)
             + (e * e).sum(1)[None, :])
        idx = d.argmin(1)
        r, acc = r - e[idx], acc + e[idx]
        out.append(idx)
    return torch.stack(out), acc


def quantize(state: Params, z: torch.Tensor) -> torch.Tensor:
    """latents [B, 512, L] -> tokens [n_semantic + n_acoustic, B, L]."""
    set_f32()
    B, _, L = z.shape
    x = z.transpose(1, 2).reshape(B * L, -1)
    toks = [nearest(torch.matmul(x, state[f"{s}_in"].T), state[s])[0]
            for s in ("semantic", "acoustic")]
    return torch.cat(toks).reshape(-1, B, L)


def dequantize(state: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [n, B, L] -> latents [B, 512, L]: each quantizer's codewords
    summed, through its output projection, the two summed."""
    n, B, L = tokens.shape
    ns = state["semantic"].shape[0]
    out = 0.0
    for s, toks in (("semantic", tokens[:ns]), ("acoustic", tokens[ns:])):
        q = sum(state[s][i][toks[i].long()] for i in range(toks.shape[0]))
        if toks.shape[0]:
            out = out + torch.matmul(q, state[f"{s}_out"].T)
    return out.permute(0, 2, 1)


def encode(params: Params, state: Params, cfg: Dict[str, Any],
           wav: torch.Tensor) -> torch.Tensor:
    """wav [B, 1, T] -> tokens [n, B, T / 1920]."""
    return quantize(state, encode_latent(params, cfg, wav))


def decode(params: Params, state: Params, cfg: Dict[str, Any],
           tokens: torch.Tensor) -> torch.Tensor:
    """tokens [n, B, L] -> wav [B, 1, L * 1920]."""
    return decode_latent(params, cfg, dequantize(state, tokens))
