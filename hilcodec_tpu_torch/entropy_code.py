"""Entropy-code a wav's RVQ tokens into a bitstream with the token LM and
the arithmetic coder, decode it back and check the roundtrip: the port's
counterpart of `scripts/entropy_code.py`.

  encode (default): wav -> codec encode -> LM-driven arithmetic coding ->
      a `.hilstream` container (utils/bitstream.py) -> an in-process
      decode checks the exact roundtrip; prints one JSON line.
  --decode STREAM:  the standalone decoder: reads the container header
      (token geometry and LM architecture), entropy-decodes the tokens,
      checks their CRC, runs the codec decoder and writes the wav.

Both directions step the same batched LM forward over timesteps on
identical inputs (the decoded prefix equals the true prefix; future
positions hold the missing index 0), so both quantize identical cdfs.
Segments are independent LM contexts and batch together (padded to a
power of two), so each direction costs S forwards; the symbols go
time-major, (t, segment, q). The encoder codes them with the native range
coder (`ops/native_coder.py`, built with g++ on first use; it raises if it
cannot be built); the decoder, which needs each step's symbols before the
next step's cdfs, with the Python one.

Usage:
  python -m hilcodec_tpu_torch.entropy_code -c CONFIG --ckpt CODEC_CKPT
      --lm LM_CKPT -i input.wav [-n N_Q] [--seg-tokens 150]
      [--dim 200 --heads 8 --layers 5] [--out stream.hilstream]
      [--device DEV]
  python -m hilcodec_tpu_torch.entropy_code -c ... --ckpt ... --lm ...
      --decode stream.hilstream [--out-wav decoded.wav]

Runs on the card unless --device names another device; a stream decodes
exactly on the kind of device that encoded it.
"""

import argparse
import json
import math
import sys

import numpy as np
import torch

from .ops.entropy_coding import (ArithmeticDecoder, encode_symbols,
                                 quantize_cdf)

STREAM_ABOVE_HOPS = 512


def batched_prob_fn(lm, lm_params):
    """The shared probability model both directions evaluate: one LM
    forward over [B, n_q, S] inputs, sliced at step t -> [B, card, n_q]
    float64 (numpy)."""
    device = lm_params["emb"].device

    @torch.no_grad()
    def lm_probs_at(inputs: np.ndarray, t: int) -> np.ndarray:
        probs, _, _ = lm.apply(lm_params, torch.from_numpy(inputs).to(device))
        return probs[..., t].cpu().numpy().astype(np.float64)

    return lm_probs_at


def _padded_batch(n_seg: int) -> int:
    return 1 << max(0, n_seg - 1).bit_length()


def entropy_encode_segments(lm_probs_at, segs: np.ndarray) -> bytes:
    """segs [n_seg, n_q, S] -> arithmetic-coded bytes, symbols time-major
    (t, segment, q), one batched LM forward a step. Teacher forcing knows
    every symbol's cdf before coding starts, so all of them go to the
    native coder in one call (bytes identical to the Python coder's; the
    cdfs take n_seg * n_q * S * (card + 1) * 8 bytes)."""
    n_seg, n_q, S = segs.shape
    inputs = np.zeros((_padded_batch(n_seg), n_q, S), np.int64)
    cdfs = []
    for t in range(S):
        probs = lm_probs_at(inputs, t)                   # [Bp, card, n_q]
        cdfs += [quantize_cdf(probs[s, :, q])
                 for s in range(n_seg) for q in range(n_q)]
        if t + 1 < S:
            inputs[:n_seg, :, t + 1] = segs[:, :, t] + 1
    return encode_symbols(segs.transpose(2, 0, 1), np.stack(cdfs),
                          native=True)


def entropy_decode_segments(lm_probs_at, data: bytes, n_seg: int, n_q: int,
                            S: int) -> np.ndarray:
    """bytes -> segs [n_seg, n_q, S]: the same forward and batching,
    stepped on the growing decoded prefix."""
    dec = ArithmeticDecoder(data)
    segs = np.zeros((n_seg, n_q, S), np.int64)
    inputs = np.zeros((_padded_batch(n_seg), n_q, S), np.int64)
    for t in range(S):
        probs = lm_probs_at(inputs, t)
        for s in range(n_seg):
            for q in range(n_q):
                segs[s, q, t] = dec.decode(quantize_cdf(probs[s, :, q]))
        if t + 1 < S:
            inputs[:n_seg, :, t + 1] = segs[:, :, t] + 1
    return segs


def load_lm(path, n_q: int, card: int, dim: int, heads: int, layers: int,
            seg_tokens: int, device):
    """(LMModel, params on `device`) of an LM checkpoint (`train_lm`'s,
    either package's); with path None, the seeded init."""
    from .models.encodec import LMModel
    from .utils.checkpoint import load_checkpoint
    lm = LMModel(n_q=n_q, card=card, dim=dim, num_heads=heads,
                 num_layers=layers, past_context=seg_tokens)
    params = lm.init(torch.Generator().manual_seed(0), device)
    if path is not None:
        params, _ = load_checkpoint(path, params)
    return lm, params


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m hilcodec_tpu_torch.entropy_code")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--lm", required=True, help="LM checkpoint (train_lm)")
    p.add_argument("-i", "--input", default=None, help="wav to encode")
    p.add_argument("--decode", default=None, metavar="STREAM",
                   help="decode this .hilstream instead of encoding")
    p.add_argument("-n", "--n-q", type=int, default=None)
    p.add_argument("--seg-tokens", type=int, default=150)
    p.add_argument("--dim", type=int, default=200)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--out", default=None, help="write the bitstream here")
    p.add_argument("--out-wav", default=None,
                   help="decode mode: write the reconstructed wav here")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without it)")
    ns = p.parse_args(argv)
    if (ns.input is None) == (ns.decode is None):
        p.error("exactly one of -i/--input (encode) or --decode required")

    from .train_lm import load_folded_codec
    from .utils.bitstream import (HEADER_BYTES, read_hilstream, token_crc32,
                                  write_hilstream)
    from .utils.wavio import read_wav, write_wav

    hps, model, params, vq_state = load_folded_codec(ns.config, ns.ckpt,
                                                     ns.device)
    dev = model.device
    card = int(vq_state["embed"].shape[1])
    hop = model.hop_length
    sr = hps.data.sampling_rate
    fps = sr / hop

    if ns.decode:
        meta, data = read_hilstream(ns.decode)
        n_q, S, n_seg = meta["n_q"], meta["seg_tokens"], meta["n_seg"]
        if (meta["card"], meta["hop"]) != (card, hop):
            sys.exit(f"error: the stream's card / hop {meta['card']} / "
                     f"{meta['hop']} are not the codec's {card} / {hop}")
        arch = meta["lm_dim"], meta["lm_heads"], meta["lm_layers"]
    else:
        n_q = ns.n_q or int(vq_state["embed"].shape[0])
        S = ns.seg_tokens
        arch = ns.dim, ns.heads, ns.layers
    lm, lm_params = load_lm(ns.lm, n_q, card, *arch, S, dev)
    lm_probs_at = batched_prob_fn(lm, lm_params)

    if ns.decode:
        segs = entropy_decode_segments(lm_probs_at, data, n_seg, n_q, S)
        got_crc = token_crc32(segs)
        if got_crc != meta["token_crc"]:
            sys.exit(f"TOKEN CRC MISMATCH: decoded {got_crc:#010x} != "
                     f"header {meta['token_crc']:#010x}: the decoder's LM "
                     "probabilities diverge from the encoder's (another "
                     "device kind?); the output would be garbage")
        # [n_seg, n_q, S] -> [n_q, 1, T] in segment-time order
        tokens = torch.from_numpy(np.concatenate(list(segs), axis=-1)
                                  [:, None, :]).to(dev)
        T = tokens.shape[-1]
        with torch.no_grad():
            if T > STREAM_ABOVE_HOPS:
                wav = model.decode_stream(params, vq_state, tokens,
                                          model.init_cache(1)[1])[0]
            else:
                wav = model.decode(params, vq_state, tokens)
        out_wav = ns.out_wav or (ns.decode + ".wav")
        write_wav(out_wav, wav[0, 0].cpu().numpy(), sr)
        print(json.dumps({
            "decoded_seconds": round(T * hop / sr, 2),
            "n_q": n_q, "tokens": int(n_seg * n_q * S),
            "stream_bytes": len(data),
            "kbps_entropy_coded": round(
                len(data) * 8 / (T * hop / sr) / 1000, 3),
            "output_wav": out_wav}))
        return

    wav, file_sr = read_wav(ns.input)
    if file_sr != sr:
        sys.exit(f"error: expected {sr} Hz input, got {file_sr}")
    n_seg = len(wav) // (S * hop)
    if n_seg == 0:
        sys.exit("error: input shorter than one LM segment")
    x = torch.from_numpy(np.ascontiguousarray(
        wav[: n_seg * S * hop], np.float32))[None, None].to(dev)
    with torch.no_grad():
        if x.shape[-1] // hop > STREAM_ABOVE_HOPS:
            tokens = model.encode_stream(params, vq_state, x,
                                         model.init_cache(1)[0], n=n_q)[0]
        else:
            tokens = model.encode(params, vq_state, x, n=n_q)
    tokens = tokens[:, 0].cpu().numpy().astype(np.int64)  # [n_q, T]
    segs = np.stack([tokens[:, s * S:(s + 1) * S] for s in range(n_seg)])

    data = entropy_encode_segments(lm_probs_at, segs)
    dec_segs = entropy_decode_segments(lm_probs_at, data, n_seg, n_q, S)

    exact = bool((dec_segs == segs).all())
    n_symbols = n_seg * n_q * S
    bits_per_token = len(data) * 8 / n_symbols
    raw_bits = math.log2(card)
    out = {
        "input_seconds": round(n_seg * S * hop / sr, 2),
        "n_q": n_q, "tokens": int(n_symbols),
        "roundtrip_exact": exact,
        "bits_per_token": round(bits_per_token, 4),
        "raw_bits_per_token": round(raw_bits, 1),
        "kbps_entropy_coded": round(bits_per_token * n_q * fps / 1000, 3),
        "kbps_fixed_rate": round(raw_bits * n_q * fps / 1000, 3),
        "saved_pct": round((1 - bits_per_token / raw_bits) * 100, 2),
        "stream_bytes": len(data),
    }
    if ns.out:
        out["file_bytes"] = write_hilstream(
            ns.out, data, n_q=n_q, card=card, seg_tokens=S, n_seg=n_seg,
            sampling_rate=sr, hop=hop, lm_dim=arch[0], lm_heads=arch[1],
            lm_layers=arch[2], token_crc=token_crc32(segs))
        assert out["file_bytes"] == len(data) + HEADER_BYTES
        out["stream_file"] = ns.out
    print(json.dumps(out))
    if not exact:
        sys.exit("ROUNDTRIP MISMATCH")


if __name__ == "__main__":
    main()
