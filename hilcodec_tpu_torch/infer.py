"""Streaming inference driver (the port's `infer.py`).

Streams a wav file through `encode_stream` / `decode_stream`,
frames_per_step frames a step, on the card: writes the tokens as int16
[n_q, B, T] (`{OUT}_quantized.npy`) and the reconstruction
(`{OUT}_output.wav`), and prints each side's real-time factor (wall clock
around work that ends in a device synchronize, after one warm-up pass).

Usage:
  python -m hilcodec_tpu_torch.infer -c CONFIG -i input.wav [-o OUT]
      [--ckpt PATH] [-n NUM_QUANTIZERS] [-f FRAMES_PER_STEP] [--latency]
      [--profile DIR] [--entropy-stream LM_CKPT|random]
      [--lm-arch D,H,L,S] [--device DEV]

Without --ckpt the weights are the port's seeded init with N(0, 1)
codebooks. --latency times each step of f frames (encode and decode, one
step a call) against its f*hop budget: p50 / p90 / p99. --profile writes a
torch.profiler chrome trace into DIR. The input is cut to a whole number
of steps.

--entropy-stream codes the tokens live, frame by frame, through the
token LM (an LM checkpoint of `train_lm`, or `random` for its seeded
init; architecture dim,heads,layers,seg_tokens from --lm-arch) and the
arithmetic coder (`serve/entropy_live.py`), decodes them back live, and
writes `{OUT}.hilstream`; it prints the roundtrip flag, the kbps against
the fixed rate, the coder's per-frame latency p50 / p99 against the frame
and the decoder's lag in frames. The LM runs on the codec's device.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from .utils.checkpoint import load_codec
from .utils.hparams import load_config
from .utils.wavio import read_wav, write_wav

MAX_LATENCY_STEPS = 200


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def latency_histogram(model, params, vq_state, wav, fps, n, sr) -> str:
    """Per-step wall latency of encode + decode, one step a call, each
    ending in a synchronize: p50 / p90 / p99 against the step's budget."""
    step = fps * model.hop_length
    n_steps = min(wav.shape[-1] // step, MAX_LATENCY_STEPS)
    ce, cd = model.init_cache(wav.shape[0])

    def one(i, ce, cd):
        tok, ce = model.encode_stream(params, vq_state,
                                      wav[:, :, i * step:(i + 1) * step], ce,
                                      n=n, frames_per_step=fps)
        _, cd = model.decode_stream(params, vq_state, tok, cd,
                                    frames_per_step=fps)
        return ce, cd

    one(0, *model.init_cache(wav.shape[0]))             # warm-up
    _sync(model.device)
    lats = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        ce, cd = one(i, ce, cd)
        _sync(model.device)
        lats.append((time.perf_counter() - t0) * 1e3)
    lats = np.sort(np.asarray(lats))
    budget = step / sr * 1e3
    p = lambda q: lats[min(int(q * len(lats)), len(lats) - 1)]
    return (f"per-step enc+dec latency over {n_steps} steps "
            f"(budget {budget:.2f} ms): "
            f"p50 {p(0.5):.2f}  p90 {p(0.9):.2f}  p99 {p(0.99):.2f} ms"
            f"  ({'REAL-TIME' if p(0.99) < budget else 'over budget'})")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m hilcodec_tpu_torch.infer")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="streamed")
    p.add_argument("--ckpt", default=None)
    p.add_argument("-n", "--num_quantizers", type=int, default=None)
    p.add_argument("-f", "--frames_per_step", type=int, default=1,
                   help="frames per streaming step (latency granularity)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler chrome trace into DIR")
    p.add_argument("--latency", action="store_true",
                   help="per-step latency histogram (one step a call)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without it)")
    p.add_argument("--entropy-stream", default=None, metavar="LM_CKPT",
                   help="live entropy-coded streaming: per-frame tokens "
                        "-> LM-driven arithmetic bitstream -> live decode "
                        "back, bit-exact; writes OUTPUT.hilstream "
                        "(`random`: the LM's seeded init)")
    p.add_argument("--lm-arch", default="200,8,5,150",
                   help="dim,heads,layers,seg_tokens of the LM checkpoint")
    ns = p.parse_args(argv)
    fps = ns.frames_per_step
    if fps < 1:
        sys.exit("error: -f must be positive")

    hps = load_config(ns.config)
    model, params, vq_state = load_codec(hps, ns.ckpt, ns.device)
    params = model.fold_params(params)
    sr, hop, dev = hps.data.sampling_rate, model.hop_length, model.device
    wav, in_sr = read_wav(ns.input)
    if in_sr != sr:
        sys.exit(f"error: expected {sr} Hz input, got {in_sr}")
    L = len(wav) // hop // fps * fps
    if L == 0:
        sys.exit(f"error: input shorter than one step ({fps * hop} "
                 f"samples)")
    x = torch.from_numpy(np.ascontiguousarray(wav[:L * hop]))[None, None]
    x = x.to(dev)
    n = ns.num_quantizers

    def encode():
        return model.encode_stream(params, vq_state, x,
                                   model.init_cache(1)[0], n=n,
                                   frames_per_step=fps)[0]

    def decode(tokens):
        return model.decode_stream(params, vq_state, tokens,
                                   model.init_cache(1)[1],
                                   frames_per_step=fps)[0]

    with torch.no_grad():
        decode(encode())                                # warm-up
        _sync(dev)
        if ns.latency:
            print(latency_histogram(model, params, vq_state, x, fps, n, sr))
        if ns.profile:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                decode(encode())
                _sync(dev)
            os.makedirs(ns.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(ns.profile,
                                                  "trace.json"))
            print(f"profiler trace written to {ns.profile}")
        t0 = time.perf_counter()
        tokens = encode()
        _sync(dev)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = decode(tokens)
        _sync(dev)
        t_dec = time.perf_counter() - t0

    seconds = L * hop / sr
    print(f"encoder RTF: {seconds / t_enc:8.2f}x realtime "
          f"({t_enc * 1000:.1f} ms for {seconds:.2f} s)")
    print(f"decoder RTF: {seconds / t_dec:8.2f}x realtime "
          f"({t_dec * 1000:.1f} ms)")
    tok = tokens.cpu().numpy()
    os.makedirs(os.path.dirname(ns.output) or ".", exist_ok=True)
    np.save(f"{ns.output}_quantized.npy", tok.astype(np.int16))
    write_wav(f"{ns.output}_output.wav", out[0, 0].cpu().numpy(), sr)
    print(f"wrote {ns.output}_quantized.npy {tuple(tok.shape)} and "
          f"{ns.output}_output.wav")
    if ns.entropy_stream:
        live_entropy_stream(ns, model, tok, sr, hop)


def live_entropy_stream(ns, model, tokens, sr, hop) -> None:
    """Per-frame tokens -> bitstream -> tokens, live, on the codec's
    device: the encoder pushes each frame and hands its settled bytes to
    the decoder, which pulls every frame it can decode safely. Writes
    {OUT}.hilstream (the live (t, q) symbol order) and prints the result;
    exits non-zero unless the roundtrip is exact."""
    from .entropy_code import load_lm
    from .serve.entropy_live import LiveTokenDecoder, LiveTokenEncoder
    from .utils.bitstream import token_crc32, write_hilstream

    dim, heads, layers, seg = (int(v) for v in ns.lm_arch.split(","))
    n_q = tokens.shape[0]
    card = int(model.vq.codebook_size)
    path = None if ns.entropy_stream == "random" else ns.entropy_stream
    lm, lm_params = load_lm(path, n_q, card, dim, heads, layers, seg,
                            model.device)
    frames = tokens[:, 0, :].T                      # [T, n_q]
    enc = LiveTokenEncoder(lm, lm_params, seg_tokens=seg)
    dec = LiveTokenDecoder(lm, lm_params, seg_tokens=seg)
    blob, got, lat_ms, lags = bytearray(), [], [], []
    for t in range(len(frames)):
        t0 = time.perf_counter()
        settled = enc.push(frames[t])
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if settled:
            blob.extend(settled)
            dec.feed(settled)
            got.extend(dec.pull())
        lags.append(t + 1 - len(got))               # frames behind
    tail = enc.finish()
    blob.extend(tail)
    dec.feed(tail, finished=True)
    got.extend(dec.pull_n(len(frames) - len(got)))

    exact = bool((np.stack(got) == frames).all())
    seconds = len(frames) * hop / sr
    kbps = len(blob) * 8 / seconds / 1000
    fixed = n_q * np.log2(card) * sr / hop / 1000
    lat = np.sort(np.asarray(lat_ms))
    p50 = lat[len(lat) // 2]
    p99 = lat[min(int(0.99 * len(lat)), len(lat) - 1)]
    out_path = f"{ns.output}.hilstream"
    write_hilstream(out_path, bytes(blob), n_q=n_q, card=card,
                    seg_tokens=seg, n_seg=max(1, len(frames) // seg),
                    sampling_rate=sr, hop=hop, lm_dim=dim, lm_heads=heads,
                    lm_layers=layers, token_crc=token_crc32(np.stack(got)))
    print(f"live entropy stream: roundtrip_exact={exact}  "
          f"{kbps:.3f} kbps ({len(blob)} bytes / {seconds:.2f} s)  "
          f"vs fixed-rate {fixed:.2f} kbps")
    print(f"  per-frame coder latency: p50 {p50:.2f} ms  p99 {p99:.2f} ms "
          f"(budget {hop / sr * 1e3:.2f} ms)")
    print(f"  decoder settled-bits lag: mean {np.mean(lags):.1f} frames "
          f"({np.mean(lags) * hop / sr * 1e3:.0f} ms), max {max(lags)}")
    print(f"  wrote {out_path}")
    if not exact:
        raise SystemExit("LIVE ROUNDTRIP MISMATCH")


if __name__ == "__main__":
    main()
