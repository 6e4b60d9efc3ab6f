"""The plain f32 reference of the streaming cells: the codec's offline
encode, a nearest-code RVQ and the offline decode, and the work a frame
step needs.

The codec is fully causal, so the offline forward over a stream's whole
input equals what streaming it frame by frame computes, up to rounding.
The check is teacher-forced on the program's tokens: at each stage the
reference's residual is scored against every codeword, and the gap by
which the program's chosen codeword lies above the best one is the
number compared (0 where the program chose the best); the residual then
takes the program's codeword, so one close call does not carry into the
later stages. The program's PCM is held against the offline decode of
the program's own tokens, in int16 steps.

Weights come from the seed through the reference's own init (a frozen
copy of the port's), with the zero-init scales drawn nonzero
(`common.fill_zero_init`), and N(0, 1) codebooks drawn after them from
the same generator. The benchmark hands the same tensors to the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import counter as C
from .frozen.models.audiodec import AudioDec
from .frozen.models.codec import CodecModel, residual_vq
from .frozen.models.hilcodec import HILCodec, params_to


def set_f32() -> None:
    """IEEE f32 products and convolutions: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build(config: Dict[str, Any], device) -> CodecModel:
    """The reference codec of a configuration file."""
    mk = dict(config["model_kwargs"])
    if config["model"] == "hilcodec":
        codec = HILCodec.from_config(mk)
        vq_kwargs = dict(mk.get("vq_kwargs") or {})
    elif config["model"] == "audiodec":
        codec = AudioDec.from_config(mk)
        vq_kwargs = dict(mk.get("vq_kwargs") or {})
        vq_kwargs.setdefault("dim", codec.code_dim)
    else:
        raise ValueError(f"no reference for model {config['model']!r}")
    vq_kwargs["kmeans_init"] = False
    return CodecModel(codec, residual_vq(vq_kwargs), torch.device(device))


def make_weights(model: CodecModel, seed: int
                 ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """(unfolded params, codebooks [n_q, K, C]) on the CPU, from `seed`."""
    from ..common import fill_zero_init
    gen = torch.Generator().manual_seed(seed)
    params = fill_zero_init(model.codec.init(gen), gen)
    vq = model.vq
    books = torch.randn((vq.num_quantizers, vq.codebook_size, vq.dim),
                        generator=gen)
    return params, books


def folded_weights(model: CodecModel, seed: int, device
                   ) -> Tuple[Dict[str, Any], torch.Tensor]:
    params, books = make_weights(model, seed)
    return (params_to(model.fold_params(params), device), books.to(device))


def dequantize(tokens: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """tokens [n, L] -> the sum of the chosen codewords [L, C]."""
    out = torch.zeros((tokens.shape[1], books.shape[-1]),
                      dtype=books.dtype, device=books.device)
    for s in range(tokens.shape[0]):
        out = out + books[s][tokens[s].long()]
    return out


def token_gap(z: torch.Tensor, books: torch.Tensor,
              tokens: torch.Tensor) -> float:
    """The widest gap, over frames and stages, by which the program's
    codeword lies above the nearest one to the reference's residual, in
    float64, relative to ||r||^2 + the mean ||e||^2 of the stage's
    codebook (the size of the terms the distance cancels).

    z: the reference's latents [L, C]; tokens: the program's [n, L]."""
    r = z.double()
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


def pcm_error(model: CodecModel, params, books: torch.Tensor,
              tokens: torch.Tensor, pcm16: torch.Tensor) -> float:
    """The widest distance, in int16 steps, between the program's PCM
    [T] and the offline decode of its own tokens [n, L] from a zero
    start."""
    y = decode_tokens(model, params, books, tokens)
    ref = torch.clamp(y.double() * 32768.0, -32768.0, 32767.0)
    return float((pcm16.to(ref.device).double() - ref).abs().max())


def check_stream(model: CodecModel, params, books: torch.Tensor,
                 wav: torch.Tensor, tokens: torch.Tensor,
                 pcm16: torch.Tensor) -> Tuple[float, float]:
    """(token gap, PCM error) of one stream: its whole input wav [T],
    the program's tokens [n, L] and PCM [T'] (T' <= T; the decode checks
    the frames the program returned)."""
    z = model.encode_latent(params, wav.float()[None, None])[0].T
    L = tokens.shape[1]
    return (token_gap(z[:L], books.float(), tokens),
            pcm_error(model, params, books, tokens, pcm16))


def decode_tokens(model: CodecModel, params, books: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The offline decode of tokens [n, L] from a zero start: wav [T]."""
    q = dequantize(tokens, books.float())
    return model.decode_latent(params, q.T[None].float())[0, 0]


# -- the work of a frame step, counted on the reference ----------------

def frame_step_work(model: CodecModel, streams: int) -> Dict[str, float]:
    """FLOPs of one frame step at `streams` streams (the encoder step, the
    RVQ cascade, the decoder step), counted on meta tensors, and each
    half's least bytes: weights, input and caches read once, output and
    caches written once (f32)."""
    meta = torch.device("meta")
    codec, vq = model.codec, model.vq
    params = C.to_meta(model.fold_params(
        codec.init(torch.Generator().manual_seed(0))))
    books = torch.zeros((vq.num_quantizers, vq.codebook_size, vq.dim),
                        device=meta)
    ce, cd = codec.init_cache(streams, torch.float32, meta)
    hop = codec.hop_length
    wav = torch.zeros((streams, 1, hop), device=meta)
    enc_rows = C.analyze(codec.encoder.step, params["encoder"], ce, wav)
    z = torch.zeros((streams, vq.dim, 1), device=meta)
    q_rows = C.analyze(_cascade, z.transpose(1, 2).reshape(-1, vq.dim),
                       books)
    dec_rows = C.analyze(codec.decoder.step, params["decoder"], cd, z)

    def flops(rows):
        t = C.totals(rows)
        return t["conv"] + t["dot"]

    def nbytes(tree):
        return C.tree_bytes(tree)
    enc_b = (nbytes(params["encoder"]) + nbytes(wav) + 2 * nbytes(ce)
             + nbytes(z))
    dec_b = (nbytes(params["decoder"]) + nbytes(z) + 2 * nbytes(cd)
             + nbytes(wav))
    return {"enc_flops": flops(enc_rows), "rvq_flops": flops(q_rows),
            "dec_flops": flops(dec_rows), "enc_bytes": float(enc_b),
            "dec_bytes": float(dec_b)}


def _cascade(r: torch.Tensor, books: torch.Tensor) -> List[torch.Tensor]:
    """The nearest-code cascade: per stage the distances ||r||^2 -
    2 r.e + ||e||^2, the argmin, and the residual update."""
    out = []
    for s in range(books.shape[0]):
        e = books[s]
        d = ((r * r).sum(1, keepdim=True) - 2.0 * r @ e.T
             + (e * e).sum(1)[None, :])
        idx = d.argmin(1)
        r = r - e[idx]
        out.append(idx)
    return out
