"""Streaming encode+decode benchmark of the port (counterpart of bench.py).

Usage:
  python -m hilcodec_tpu_torch.bench [streams=128] [--seconds S=4]
      [--frames F=1] [--megakernel|--no-megakernel] [--fused] [--dispatch]
      [--model hilcodec|encodec|avocodo|audiodec|mimi]
      [--dtype f32|bf16w|bf16]
      [--depthwise conv|shift] [--mesh] [--device D]

The model is the operating point of bench.py for its family: HILCodec
defaults with both res_scale set (the flagship), `--model encodec`,
EnCodec defaults (SEANet + 2-layer LSTM bottleneck), `--model
avocodo`, AvocodoModel defaults (streaming its full-rate head), or
`--model audiodec`, AudioDec defaults (hop 300) with a 64-dim VQ; seeded
init, N(0, 1) codebooks, 8 quantizers of 1024 codes, folded params.
`--model mimi` is Mimi at its published widths (hop 1920, 12.5 Hz
frames) with its split quantizer of 8 codebooks of 2048 x 256, seeded
(`models/mimi.py`; its transformers' ring caches are 16.4 MB a stream). It times `encode_stream` then
`decode_stream` (frame kernels
with --megakernel; the plain frame step by default, as in the JAX
package), or `encode_decode_stream` with --fused, over S seconds of audio
per stream: one warm-up call, then 3 timed calls, each ending in a device
synchronize. --frames F streams F frames a step (`frames_per_step`; the
audio is cut to a multiple of F frames), as bench.py's --frames does.
--dispatch times one frame per call instead: blocking p50/p99 and the
pipelined per-frame cost. --dtype is bench.py's precision mode:
`bf16w` casts the conv kernels (leaves of rank 3 or more) to bf16 and
keeps f32 activations and caches, `bf16` casts every param, the audio and
the caches (`models/codec.cast_streaming_params`); the latents reach the
RVQ kernel in f32 either way. --depthwise takes bench.py's names (`conv`,
`shift`), which choose how XLA lowers the depthwise convs; both are the
same function, one convolution here (`ops/conv.DEPTHWISE_LOWERINGS`), so
the run and its metric do not change. --mesh splits the streams evenly
over every visible card, each card with its own copy of the params and
its own caches, as bench.py's --mesh shards them over the JAX devices;
the shards are placed and launched as the serving engine's are (one
host thread launches every card's frames before it awaits any). The
metric is the same; the unit names the cards; on the CPU the mesh is the
one device. Runs on CUDA unless --device
names another device, and raises without CUDA.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} with
vs_baseline = value / 100 (the rebuild target of bench.py). The metric
names start with `torch_`, apart from bench.py's TPU record, take
bench.py's suffixes (`_{model}` for a family other than HILCodec, then
`_bf16w` / `_bf16`, then the port's `_megakernel`, `_fused` and `_fF`),
and the unit names the device. --fused and --megakernel do not combine,
and neither does --fused with --dispatch, which times encode_stream and
decode_stream, nor --mesh with --dispatch, which times one device.
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
from .models.audiodec import AudioDec
from .models.avocodo import AvocodoModel
from .models.codec import CodecModel
from .models.encodec import EncodecModel
from .models.codec import cast_streaming_params
from .models.hilcodec import HILCodec
from .models.mimi import MimiCodecModel, build_mimi
from .ops.conv import DEPTHWISE_LOWERINGS
from .ops.rvq import ResidualVQ
from .parallel.dist import mesh_devices, place_shards

SAMPLE_RATE = 24000
REPS = 3
DISPATCH_BLOCKING = 100
DISPATCH_PIPELINED = 200
# bench.py options the port refuses: both tune XLA's scan and mean nothing
# to an eager PyTorch loop
_REFUSED = {
    "--unroll": "unrolls the XLA scan of the JAX drivers; the port's "
                "frame loop is eager PyTorch and has no such knob",
    "--chunks": "splits the XLA scan's streams into groups; the port's "
                "frame loop is eager PyTorch and has no such knob"}
MODELS = ("hilcodec", "encodec", "avocodo", "audiodec", "mimi")
DTYPES = ("f32", "bf16w", "bf16")


@dataclasses.dataclass(frozen=True)
class Args:
    streams: int = 128
    seconds: float = 4.0
    megakernel: bool = False
    fused: bool = False
    dispatch: bool = False
    device: Optional[str] = None
    frames: int = 1
    model: str = "hilcodec"
    dtype: str = "f32"
    mesh: bool = False


def _value(argv: List[str], flag: str) -> str:
    i = argv.index(flag)
    if i + 1 >= len(argv):
        sys.exit(f"error: {flag} requires a value")
    val = argv[i + 1]
    del argv[i:i + 2]
    return val


def parse_args(argv: List[str]) -> Args:
    """[streams] [--seconds S] [--frames F] [--megakernel|--no-megakernel]
    [--fused] [--dispatch] [--model M] [--dtype D] [--depthwise L]
    [--mesh] [--device D]; fails fast on malformed or refused options."""
    argv = list(argv)
    for flag, why in _REFUSED.items():
        if flag in argv:
            sys.exit(f"error: {flag} {why}")
    dtype = _value(argv, "--dtype") if "--dtype" in argv else "f32"
    if dtype not in DTYPES:
        sys.exit(f"error: unknown --dtype {dtype!r} (f32 | bf16w | bf16)")
    depthwise = (_value(argv, "--depthwise") if "--depthwise" in argv
                 else "conv")
    if depthwise not in DEPTHWISE_LOWERINGS:
        sys.exit(f"error: unknown --depthwise {depthwise!r} (conv | shift)")
    model = "hilcodec"
    if "--model" in argv:
        model = _value(argv, "--model")
        if model not in MODELS:
            sys.exit(f"error: --model {model!r} is not ported to "
                     f"hilcodec_tpu_torch yet (see ROADMAP.md)")
    mega = "--megakernel" in argv and "--no-megakernel" not in argv
    if mega and model != "hilcodec":
        sys.exit(f"error: --megakernel: the frame kernels run HILCodec "
                 f"only, not --model {model}")
    fused, dispatch = "--fused" in argv, "--dispatch" in argv
    mesh = "--mesh" in argv
    argv = [a for a in argv if a not in ("--megakernel", "--no-megakernel",
                                         "--fused", "--dispatch", "--mesh")]
    if fused and mega:
        sys.exit("error: --fused has no frame-kernel path "
                 "(encode_decode_stream runs the plain frame step)")
    if fused and dispatch:
        sys.exit("error: --dispatch times encode_stream and decode_stream "
                 "a frame a call; it takes no --fused")
    if mesh and dispatch:
        sys.exit("error: --dispatch times one device; it takes no --mesh")
    device = _value(argv, "--device") if "--device" in argv else None
    seconds = 4.0
    if "--seconds" in argv:
        raw = _value(argv, "--seconds")
        try:
            seconds = float(raw)
        except ValueError:
            sys.exit(f"error: --seconds requires a number, got {raw!r}")
    frames = 1
    if "--frames" in argv:
        raw = _value(argv, "--frames")
        try:
            frames = int(raw)
        except ValueError:
            sys.exit(f"error: --frames requires an int, got {raw!r}")
        if frames < 1:
            sys.exit("error: --frames must be positive")
        if dispatch and frames != 1:
            sys.exit("error: --dispatch times one frame a call; it takes "
                     "no --frames")
    unknown = [a for a in argv if a.startswith("-")]
    if unknown:
        sys.exit(f"error: unknown option {unknown[0]!r}")
    try:
        streams = int(argv[0]) if argv else 128
    except ValueError:
        sys.exit(f"error: streams must be an integer, got {argv[0]!r}")
    if streams < 1 or len(argv) > 1:
        sys.exit("error: one positive stream count expected")
    return Args(streams, seconds, mega, fused, dispatch, device, frames,
                model, dtype, mesh)


def _bench_vq(dim: int = 128) -> ResidualVQ:
    return ResidualVQ(dim=dim, codebook_size=1024, num_quantizers=8,
                      kmeans_init=False)


def build_bench_model(device: torch.device) -> CodecModel:
    """The flagship streaming operating point of bench.py."""
    codec = HILCodec(res_scale_enc=0.5773502691896258,
                     res_scale_dec=0.5773502691896258)
    return CodecModel(codec, _bench_vq(), device)


def build_encodec_bench_model(device: torch.device) -> CodecModel:
    """bench.py's `--model encodec` point: EncodecModel defaults (SEANet
    + 2-layer LSTM bottleneck), 8 quantizers."""
    return CodecModel(EncodecModel(), _bench_vq(), device)


def build_avocodo_bench_model(device: torch.device) -> CodecModel:
    """bench.py's `--model avocodo` point: AvocodoModel defaults (the
    full-rate head streams), 8 quantizers."""
    return CodecModel(AvocodoModel(), _bench_vq(), device)


def build_audiodec_bench_model(device: torch.device) -> CodecModel:
    """bench.py's `--model audiodec` point: AudioDec defaults (strides
    3, 4, 5, 5: hop 300), 8 quantizers of dim 64."""
    return CodecModel(AudioDec(), _bench_vq(dim=64), device)


def build_mimi_bench_model(device: torch.device) -> CodecModel:
    """bench.py's `--model mimi` point: Mimi's published widths."""
    return build_mimi({}, device)


def bench_params(model: CodecModel, dtype: str = "f32"):
    """Seeded folded params, cast for the --dtype mode, and N(0, 1)
    codebooks (f32) on the model's device."""
    gen = torch.Generator().manual_seed(0)
    params = model.fold_params(model.codec.init(gen))
    if dtype != "f32":
        params = cast_streaming_params(params, torch.bfloat16,
                                       kernels_only=dtype == "bf16w")
    vq = model.vq
    if isinstance(model, MimiCodecModel):
        return model.to_device(params, vq.init_state(gen))
    books = torch.randn((vq.num_quantizers, vq.codebook_size, vq.dim),
                        generator=gen)
    return model.to_device(params, {"embed": books})


def act_dtype(args: Args) -> torch.dtype:
    """The audio's and the caches' dtype: bf16 under --dtype bf16."""
    return torch.bfloat16 if args.dtype == "bf16" else torch.float32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _noise(shape, device: torch.device,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    gen = torch.Generator().manual_seed(2)
    return (torch.randn(shape, generator=gen) * 0.3).to(device, dtype)


def encode_decode(model: CodecModel, params, vq_state, wav, ce, cd,
                  args: Args):
    """The timed work: wav -> (tokens, wav_out, cache_enc, cache_dec) through
    the drivers `args` selects, `args.frames` frames a step."""
    f = args.frames
    if args.fused:
        return model.encode_decode_stream(params, vq_state, wav, ce, cd,
                                          frames_per_step=f)
    tok, ce = model.encode_stream(params, vq_state, wav, ce,
                                  frames_per_step=f,
                                  megakernel=args.megakernel)
    out, cd = model.decode_stream(params, vq_state, tok, cd,
                                  frames_per_step=f,
                                  megakernel=args.megakernel)
    return tok, out, ce, cd


def _suffix(args: Args) -> str:
    """The metric's suffixes for the options of `args`."""
    out = f"_{args.model}" if args.model != "hilcodec" else ""
    if args.dtype != "f32":
        out += f"_{args.dtype}"
    if args.megakernel:
        out += "_megakernel"
    if args.fused:
        out += "_fused"
    if args.frames != 1:
        out += f"_f{args.frames}"
    return out


def bench_devices(model: CodecModel, args: Args) -> List[torch.device]:
    """The devices the streams are split over: every visible card with
    --mesh (`parallel/dist.mesh_devices`), else the model's device."""
    return mesh_devices(model.device) if args.mesh else [model.device]


@torch.no_grad()
def stream_bench(model: CodecModel, params, vq_state, args: Args) -> dict:
    """Aggregate real-time factor of streaming encode+decode."""
    device, hop = model.device, model.hop_length
    f = args.frames
    n_frames = int(args.seconds * SAMPLE_RATE) // hop // f * f
    if n_frames < 1:
        sys.exit(f"error: --seconds {args.seconds} is shorter than "
                 f"{f} frame(s)")
    dtype = act_dtype(args)
    wav = _noise((args.streams, 1, n_frames * hop), torch.device("cpu"),
                 dtype)
    try:
        placed = place_shards(model, params, vq_state,
                              bench_devices(model, args), args.streams)
    except ValueError as e:
        sys.exit(f"error: --mesh: {e}")
    shards = [(m, p, v, wav[rows.start:rows.stop].to(m.device),
               list(m.init_cache(len(rows), dtype)))
              for m, p, v, rows in placed]

    def one():
        # every shard's frames are launched from this thread before any
        # is awaited, as the engine's tick launches every shard's step
        for m, p, v, w, caches in shards:
            *_, caches[0], caches[1] = encode_decode(m, p, v, w, *caches,
                                                     args)
        for m, *_ in shards:
            _sync(m.device)

    one()                                             # warm-up
    dt = 0.0
    for _ in range(REPS):
        t0 = time.perf_counter()
        one()
        dt += time.perf_counter() - t0
    rtf = args.streams * n_frames * hop / SAMPLE_RATE / (dt / REPS)
    metric = "torch_streaming_encdec_rtf" + _suffix(args)
    block = f", block={f} frames" if f != 1 else ""
    cards = f", cards={len(shards)}" if args.mesh else ""
    return {"metric": metric, "value": round(rtf, 2),
            "unit": f"x_realtime_24khz (streams={args.streams}, frame={hop} "
                    f"samples{block}, device={_device_name(device)}"
                    f"{cards})",
            "vs_baseline": round(rtf / 100.0, 3)}


@torch.no_grad()
def dispatch_bench(model: CodecModel, params, vq_state, args: Args) -> dict:
    """Latency of one frame of encode+decode per call: blocking p50/p99 and
    the pipelined per-call cost (calls queued back to back, one sync)."""
    device, hop = model.device, model.hop_length
    dtype = act_dtype(args)
    wav = _noise((args.streams, 1, hop), device, dtype)

    def one(ce, cd):
        tok, ce = model.encode_stream(params, vq_state, wav, ce,
                                      megakernel=args.megakernel)
        out, cd = model.decode_stream(params, vq_state, tok, cd,
                                      megakernel=args.megakernel)
        return out, ce, cd

    out, ce, cd = one(*model.init_cache(args.streams, dtype))
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
    metric = "torch_per_dispatch_frame_latency_ms" + _suffix(args)
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
    build = {"hilcodec": build_bench_model,
             "encodec": build_encodec_bench_model,
             "avocodo": build_avocodo_bench_model,
             "audiodec": build_audiodec_bench_model,
             "mimi": build_mimi_bench_model}[args.model]
    model = build(device)
    params, vq_state = bench_params(model, args.dtype)
    bench = dispatch_bench if args.dispatch else stream_bench
    return bench(model, params, vq_state, args)


def main(argv: Optional[List[str]] = None) -> None:
    print(json.dumps(run(sys.argv[1:] if argv is None else argv)),
          flush=True)


if __name__ == "__main__":
    main()
