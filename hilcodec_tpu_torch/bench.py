"""Streaming encode+decode benchmark of the port (counterpart of bench.py).

Usage:
  python -m hilcodec_tpu_torch.bench [streams=128] [--seconds S=4]
      [--megakernel|--no-megakernel] [--fused] [--dispatch] [--device D]

The model is the flagship operating point of bench.py: HILCodec defaults
with both res_scale set, seeded init, N(0, 1) codebooks, 8 quantizers,
folded params. It times `encode_stream` then `decode_stream` (frame kernels
with --megakernel; the plain frame step by default, as in the JAX
package), or `encode_decode_stream` with --fused, over S seconds of audio
per stream: one warm-up call, then 3 timed calls, each ending in a device
synchronize. --dispatch times one frame per call instead: blocking p50/p99
and the pipelined per-frame cost. Runs on CUDA unless --device names
another device, and raises without CUDA.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} with
vs_baseline = value / 100 (the rebuild target of bench.py). The metric
names start with `torch_`, apart from bench.py's TPU record, and the unit
names the device.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import resolve_device, set_f32_parity_mode
from .models.codec import CodecModel
from .models.hilcodec import HILCodec
from .ops.rvq import ResidualVQ

SAMPLE_RATE = 24000
REPS = 3
DISPATCH_BLOCKING = 100
DISPATCH_PIPELINED = 200
# bench.py options the port does not have yet
_NOT_PORTED = ("--mesh", "--dtype", "--depthwise", "--unroll", "--chunks",
               "--frames")


@dataclasses.dataclass(frozen=True)
class Args:
    streams: int = 128
    seconds: float = 4.0
    megakernel: bool = False
    fused: bool = False
    dispatch: bool = False
    device: Optional[str] = None


def _value(argv: List[str], flag: str) -> str:
    i = argv.index(flag)
    if i + 1 >= len(argv):
        sys.exit(f"error: {flag} requires a value")
    val = argv[i + 1]
    del argv[i:i + 2]
    return val


def parse_args(argv: List[str]) -> Args:
    """[streams] [--seconds S] [--megakernel|--no-megakernel] [--fused]
    [--dispatch] [--device D]; fails fast on malformed or unported
    options."""
    argv = list(argv)
    for flag in _NOT_PORTED:
        if flag in argv:
            sys.exit(f"error: {flag} is not ported to hilcodec_tpu_torch yet "
                     f"(see ROADMAP.md)")
    if "--model" in argv:
        name = _value(argv, "--model")
        if name != "hilcodec":
            sys.exit(f"error: --model {name!r} is not ported to "
                     f"hilcodec_tpu_torch yet (see ROADMAP.md)")
    mega = "--megakernel" in argv and "--no-megakernel" not in argv
    fused, dispatch = "--fused" in argv, "--dispatch" in argv
    argv = [a for a in argv if a not in ("--megakernel", "--no-megakernel",
                                         "--fused", "--dispatch")]
    if fused and mega:
        sys.exit("error: --fused has no frame-kernel path "
                 "(encode_decode_stream runs the plain frame step)")
    device = _value(argv, "--device") if "--device" in argv else None
    seconds = 4.0
    if "--seconds" in argv:
        raw = _value(argv, "--seconds")
        try:
            seconds = float(raw)
        except ValueError:
            sys.exit(f"error: --seconds requires a number, got {raw!r}")
    unknown = [a for a in argv if a.startswith("-")]
    if unknown:
        sys.exit(f"error: unknown option {unknown[0]!r}")
    try:
        streams = int(argv[0]) if argv else 128
    except ValueError:
        sys.exit(f"error: streams must be an integer, got {argv[0]!r}")
    if streams < 1 or len(argv) > 1:
        sys.exit("error: one positive stream count expected")
    return Args(streams, seconds, mega, fused, dispatch, device)


def build_bench_model(device: torch.device) -> CodecModel:
    """The flagship streaming operating point of bench.py."""
    codec = HILCodec(res_scale_enc=0.5773502691896258,
                     res_scale_dec=0.5773502691896258)
    return CodecModel(codec, ResidualVQ(dim=128, codebook_size=1024,
                                        num_quantizers=8, kmeans_init=False),
                      device)


def bench_params(model: CodecModel):
    """Seeded folded params and N(0, 1) codebooks on the model's device."""
    gen = torch.Generator().manual_seed(0)
    params = model.fold_params(model.codec.init(gen))
    vq = model.vq
    books = torch.randn((vq.num_quantizers, vq.codebook_size, vq.dim),
                        generator=gen)
    return model.to_device(params, {"embed": books})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _noise(shape, device: torch.device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(2)
    return (torch.randn(shape, generator=gen) * 0.3).to(device)


@torch.no_grad()
def stream_bench(model: CodecModel, params, vq_state, args: Args) -> dict:
    """Aggregate real-time factor of streaming encode+decode."""
    device, hop = model.device, model.hop_length
    n_frames = int(args.seconds * SAMPLE_RATE) // hop
    if n_frames < 1:
        sys.exit(f"error: --seconds {args.seconds} is shorter than a frame")
    wav = _noise((args.streams, 1, n_frames * hop), device)

    def once(ce, cd):
        if args.fused:
            _, _, ce, cd = model.encode_decode_stream(params, vq_state, wav,
                                                      ce, cd)
            return ce, cd
        tok, ce = model.encode_stream(params, vq_state, wav, ce,
                                      megakernel=args.megakernel)
        _, cd = model.decode_stream(params, vq_state, tok, cd,
                                    megakernel=args.megakernel)
        return ce, cd

    ce, cd = once(*model.init_cache(args.streams))    # warm-up
    _sync(device)
    dt = 0.0
    for _ in range(REPS):
        t0 = time.perf_counter()
        ce, cd = once(ce, cd)
        _sync(device)
        dt += time.perf_counter() - t0
    rtf = args.streams * n_frames * hop / SAMPLE_RATE / (dt / REPS)
    metric = "torch_streaming_encdec_rtf"
    if args.megakernel:
        metric += "_megakernel"
    if args.fused:
        metric += "_fused"
    return {"metric": metric, "value": round(rtf, 2),
            "unit": f"x_realtime_24khz (streams={args.streams}, frame={hop} "
                    f"samples, device={_device_name(device)})",
            "vs_baseline": round(rtf / 100.0, 3)}


@torch.no_grad()
def dispatch_bench(model: CodecModel, params, vq_state, args: Args) -> dict:
    """Latency of one frame of encode+decode per call: blocking p50/p99 and
    the pipelined per-call cost (calls queued back to back, one sync)."""
    device, hop = model.device, model.hop_length
    wav = _noise((args.streams, 1, hop), device)

    def one(ce, cd):
        tok, ce = model.encode_stream(params, vq_state, wav, ce,
                                      megakernel=args.megakernel)
        out, cd = model.decode_stream(params, vq_state, tok, cd,
                                      megakernel=args.megakernel)
        return out, ce, cd

    out, ce, cd = one(*model.init_cache(args.streams))
    _sync(device)
    times = []
    for _ in range(DISPATCH_BLOCKING):
        t0 = time.perf_counter()
        out, ce, cd = one(ce, cd)
        _sync(device)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(DISPATCH_PIPELINED):
        out, ce, cd = one(ce, cd)
    _sync(device)
    amortized = (time.perf_counter() - t0) / DISPATCH_PIPELINED * 1e3
    ms = np.asarray(times) * 1e3
    p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
    frame_ms = hop / SAMPLE_RATE * 1e3
    metric = "torch_per_dispatch_frame_latency_ms"
    if args.megakernel:
        metric += "_megakernel"
    return {"metric": metric, "value": round(p50, 3),
            "unit": f"ms blocking p50 (streams={args.streams}, "
                    f"frame={frame_ms:.2f} ms; p99={p99:.3f}, "
                    f"pipelined_amortized={amortized:.3f}, "
                    f"device={_device_name(device)})",
            "vs_baseline": round(frame_ms / p50, 3)}


def run(argv: List[str]) -> dict:
    """Parse `argv`, build the model on its device and run the benchmark."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_f32_parity_mode()
    model = build_bench_model(device)
    params, vq_state = bench_params(model)
    bench = dispatch_bench if args.dispatch else stream_bench
    return bench(model, params, vq_state, args)


def main(argv: Optional[List[str]] = None) -> None:
    print(json.dumps(run(sys.argv[1:] if argv is None else argv)),
          flush=True)


if __name__ == "__main__":
    main()
