"""The benchmark's plain reference of Mimi: a copy of the port's
`hilcodec_tpu_torch/reference/mimi_ref.py` (the forward below, unchanged,
so that the yardstick does not move with the port), with what the cell
needs besides: the weights from the seed (`make_weights`), the work of a
frame step (`frame_step_flops`) and of one attention call
(`attention_call_work`), counted from the configuration's widths
whatever implements them.

The copied description follows.

Plain reference of Mimi's forward, whole sequence, in f32.

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


# -- the benchmark's additions: weights, checks and work counts --------------

def _uniform(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """torch's default draw for a conv or linear layer (kaiming uniform at
    a = sqrt(5)): U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    s = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape).uniform_(-s, s, generator=gen)


def _conv(gen, cout: int, cin: int, k: int, bias: bool = True) -> Params:
    p = {"w": _uniform(gen, (cout, cin, k), cin * k)}
    if bias:
        p["b"] = _uniform(gen, (cout,), cin * k)
    return p


def _convtr(gen, cin: int, cout: int, k: int, groups: int = 1,
            bias: bool = True) -> Params:
    p = {"w": _uniform(gen, (cin, cout // groups, k), cout // groups * k)}
    if bias:
        p["b"] = _uniform(gen, (cout,), cout // groups * k)
    return p


def _block(gen, dim: int, cfg) -> Params:
    hidden = dim // cfg["compress"]
    return {"convs": [_conv(gen, hidden, dim, cfg["residual_kernel_size"]),
                      _conv(gen, dim, hidden, 1)]}


def _transformer_params(gen, cfg) -> Params:
    t = cfg["transformer"]
    C, Fd = t["d_model"], t["dim_feedforward"]

    def gain():
        # LayerScale gains from U(0.5, 1.5), not 0.01: at 0.01 the check
        # could not see the branches they scale
        return 0.5 + torch.rand((C,), generator=gen)
    return {"layers": [{
        "norm1_g": torch.ones(C), "norm1_b": torch.zeros(C),
        "in_proj_w": _uniform(gen, (3 * C, C), C),
        "out_proj_w": _uniform(gen, (C, C), C), "scale1": gain(),
        "norm2_g": torch.ones(C), "norm2_b": torch.zeros(C),
        "lin1_w": _uniform(gen, (Fd, C), C),
        "lin2_w": _uniform(gen, (C, Fd), Fd), "scale2": gain()}
        for _ in range(t["num_layers"])]}


def init_params(cfg: Dict[str, Any], gen: torch.Generator) -> Params:
    """Every weight of the codec (`model_kwargs` `cfg`) drawn from `gen`
    on the CPU, in the port's tree."""
    nf, D, ratios = cfg["n_filters"], cfg["dimension"], cfg["ratios"]
    k, lk = cfg["kernel_size"], cfg["last_kernel_size"]
    n_res = cfg["n_residual_layers"]
    enc = {"conv_pre": _conv(gen, nf, cfg["channels"], k), "stages": []}
    mult = 1
    for r in reversed(ratios):
        dim = mult * nf
        enc["stages"].append({
            "blocks": [_block(gen, dim, cfg) for _ in range(n_res)],
            "down": _conv(gen, dim * 2, dim, 2 * r)})
        mult *= 2
    enc["conv_post"] = _conv(gen, D, mult * nf, lk)
    s = cfg["resample_stride"]
    encoder = {"seanet": enc, "transformer": _transformer_params(gen, cfg),
               "down": _conv(gen, D, D, 2 * s, bias=False)}
    dec = {"conv_pre": _conv(gen, mult * nf, D, k), "stages": []}
    for r in ratios:
        dim = mult * nf
        dec["stages"].append({
            "up": _convtr(gen, dim, dim // 2, 2 * r),
            "blocks": [_block(gen, dim // 2, cfg) for _ in range(n_res)]})
        mult //= 2
    dec["conv_post"] = _conv(gen, cfg["channels"], nf, lk)
    decoder = {"up": _convtr(gen, D, D, 2 * s, groups=D, bias=False),
               "transformer": _transformer_params(gen, cfg), "seanet": dec}
    return {"encoder": encoder, "decoder": decoder}


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def make_weights(config: Dict[str, Any], seed: int, device
                 ) -> Tuple[Params, Params]:
    """(params, quantizer state) on `device`, from `seed`: the weights by
    `init_params`, the projections by torch's default draws, and each
    codebook drawn from the reference's own projected latents of a seeded
    speech-band clip, stage after stage, as a k-means init picks its
    first means (rows drawn with replacement, each jittered by
    `jitter` x the rows' std), so that the argmin is contested."""
    from ..common import speech_band
    cfg, vq = config["model_kwargs"], config["model_kwargs"]["vq_kwargs"]
    ci = config["codebook_init"]
    gen = torch.Generator().manual_seed(seed)
    params = to_device(init_params(cfg, gen), device)
    Ci, Cd, K = vq["input_dim"], vq["dim"], vq["codebook_size"]
    ns = vq["n_semantic"]
    state = {f"{s}_{io}": _uniform(gen, shape, shape[1])
             for s in ("semantic", "acoustic")
             for io, shape in (("in", (Cd, Ci)), ("out", (Ci, Cd)))}
    state = to_device(state, device)
    hop = math.prod(cfg["ratios"]) * cfg["resample_stride"]
    samples = int(ci["seconds"] * 24000) // hop * hop
    dgen = torch.Generator(device=device).manual_seed(seed + 1)
    clip = speech_band(dgen, ci["rows"], samples, torch.device(device))
    with torch.no_grad():
        z = encode_latent(params, cfg, clip)
        x = z.transpose(1, 2).reshape(-1, Ci)
        for s, n in (("semantic", ns),
                     ("acoustic", vq["num_quantizers"] - ns)):
            r = torch.matmul(x, state[f"{s}_in"].T)
            books = []
            for _ in range(n):
                idx = torch.randint(0, r.shape[0], (K,), generator=gen)
                noise = torch.randn((K, Cd), generator=gen).to(r.device)
                e = r[idx.to(r.device)] + ci["jitter"] * r.std(0) * noise
                books.append(e)
                r = r - e[nearest(r, e[None])[0][0]]
            state[s] = torch.stack(books)
    return params, state


def token_gap(r: torch.Tensor, books: torch.Tensor,
              tokens: torch.Tensor) -> float:
    """The widest gap, over frames and stages, by which the program's
    codeword lies above the nearest one to the reference's residual, in
    float64, over ||r||^2 + the mean ||e||^2 of the stage's codebook;
    teacher-forced: the residual takes the program's codeword.
    r: the reference's projected latents [L, C]; tokens [n, L]."""
    r = r.double()
    worst = 0.0
    for s in range(tokens.shape[0]):
        e = books[s].double()
        e2 = (e * e).sum(1)
        r2 = (r * r).sum(1, keepdim=True)
        d = r2 - 2.0 * r @ e.T + e2[None, :]
        tok = tokens[s].long()
        gap = d.gather(1, tok[:, None])[:, 0] - d.min(1).values
        worst = max(worst, float((gap / (r2[:, 0] + e2.mean())).max()))
        r = r - e[tok]
    return worst


def check_stream(params: Params, state: Params, cfg: Dict[str, Any],
                 wav: torch.Tensor, tokens: torch.Tensor,
                 pcm16: torch.Tensor) -> Tuple[float, float]:
    """(token gap, PCM error in int16 steps) of one stream: its whole
    input wav [T], the program's tokens [n, L] and PCM [T']. The token gap
    is each quantizer's, teacher-forced on its own projection of the
    reference's latents; the PCM is held against the whole-sequence
    decode of the program's own tokens."""
    with torch.no_grad():
        z = encode_latent(params, cfg, wav.float()[None, None])[0].T
        L = tokens.shape[1]
        ns = state["semantic"].shape[0]
        gap = max(token_gap(torch.matmul(z[:L], state[f"{s}_in"].T),
                            state[s], t)
                  for s, t in (("semantic", tokens[:ns]),
                               ("acoustic", tokens[ns:])))
        y = decode(params, state, cfg, tokens[:, None])[0, 0]
        ref = torch.clamp(y.double() * 32768.0, -32768.0, 32767.0)
        err = float((pcm16.to(ref.device).double() - ref).abs().max())
    return gap, err


def transformer_step_flops(cfg: Dict[str, Any], streams: int) -> float:
    """Product FLOPs of one transformer's step over `resample_stride` new
    positions a stream, every layer: the projections and feed-forward,
    and attention over the full window of `context` slots plus the new
    positions."""
    t = cfg["transformer"]
    C, Fd, ctx = t["d_model"], t["dim_feedforward"], t["context"]
    n = cfg["resample_stride"]
    per_layer = (2 * n * C * 3 * C + 2 * n * C * C + 2 * 2 * n * C * Fd
                 + 2 * 2 * n * (ctx + n) * C)
    return float(streams * t["num_layers"] * per_layer)


def attention_call_work(cfg: Dict[str, Any], streams: int
                        ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's attention call at `streams` streams
    (`resample_stride` new positions a stream): scores and weighted sum
    over the ring of `context` slots plus the new positions; the ring's
    K and V read once, q, the new k / v rows and the output once (f32)."""
    t = cfg["transformer"]
    C, ctx = t["d_model"], t["context"]
    n = cfg["resample_stride"]
    flops = streams * 2 * 2 * n * (ctx + n) * C
    nbytes = streams * 4 * (2 * ctx * C + n * C + 2 * n * C + n * C)
    return float(flops), float(nbytes)


def _macs_flops(row) -> float:
    """A counter row's FLOPs, with a transposed convolution charged at its
    multiply-adds (2 * B * Cin * L_in * Cout / groups * k) and not at the
    frozen counter's zero-stuffed dense form (s times as many)."""
    if row.sig is None or not row.sig[7]:
        return row.flops
    (B, cin, L), (_, cout_g, k) = row.sig[0], row.sig[2]
    return 2.0 * B * cin * L * cout_g * k


def frame_step_flops(cfg: Dict[str, Any], streams: int) -> float:
    """Convolution and product FLOPs of one frame step at `streams`
    streams: the SEANet halves counted on meta tensors (the frozen
    counter's rules, but for the decoder's transposed convolutions, which
    count their multiply-adds), the transformers, resampling convs and
    quantizer from their widths."""
    from . import counter as Cn
    vq = cfg["vq_kwargs"]
    D, s = cfg["dimension"], cfg["resample_stride"]
    hop = math.prod(cfg["ratios"]) * s
    p = Cn.to_meta(init_params(cfg, torch.Generator().manual_seed(0)))
    meta = torch.device("meta")
    rows = Cn.analyze(seanet_encoder, p["encoder"]["seanet"],
                      torch.zeros((streams, 1, hop), device=meta),
                      cfg["ratios"], cfg["dilation_base"])
    rows += Cn.analyze(seanet_decoder, p["decoder"]["seanet"],
                       torch.zeros((streams, D, s), device=meta),
                       cfg["ratios"], cfg["dilation_base"])
    seanet = sum(_macs_flops(r) for r in rows if r.prim in (Cn.CONV, Cn.DOT))
    down = 2 * streams * D * D * 2 * s
    # depthwise, kernel 2 s, one input position a frame step
    up = 2 * streams * D * 2 * s
    Ci, Cd, K = vq["input_dim"], vq["dim"], vq["codebook_size"]
    rvq = (2 * 2 * 2 * streams * Ci * Cd
           + vq["num_quantizers"] * 2 * streams * K * Cd)
    return float(seanet + down + up + rvq
                 + 2 * transformer_step_flops(cfg, streams))
