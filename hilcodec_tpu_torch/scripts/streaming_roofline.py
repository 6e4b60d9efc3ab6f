"""Roofline of the streaming frame program (counterpart of the JAX
package's `scripts/streaming_roofline.py`): analytic floors a frame step,
the measured time, and the card's cost a launch.

The program is the bench entry's: the flagship bench model
(`bench.build_bench_model`, seeded folded params, N(0, 1) codebooks), f32,
`bf16w` or `bf16` (`cast_streaming_params`), through the plain drivers
(`encode_stream` then `decode_stream`) or `--fused`
(`encode_decode_stream`), over `--seconds` of seeded audio per stream.

Floors a frame step at B streams:
  * compute floor (`mxu_*`, JAX's names) -- the analytic convolution and
    product FLOPs of one frame (`flops_analysis`, counted on meta tensors:
    the same on the CPU as on the card) over the dtype's peak on the card:
    67 TFLOP/s f32 on the CUDA cores (the parity mode turns TF32 off, and
    `bf16w` widens its weights to the f32 activations), 989 TFLOP/s bf16;
  * HBM floor -- the weights (read once a frame), the codebooks, 2x the
    cache state (read and write) and the frame's I/O, over 3.35 TB/s;
  * launches -- the device kernels of one frame (`n_kernels_per_frame`,
    torch.profiler over one frame; XLA's fusion count in the JAX script)
    times the cost a launch that `--probe` measures.

The JAX script's `xla_*` fields (XLA's own cost analysis of the compiled
program) have no counterpart: an eager PyTorch program has no compiled
whole to analyze. Its `n_custom_calls` (the Pallas RVQ call in the
compiled program) becomes `rvq_kernel_launches_per_frame`, the launches
of the RVQ kernel a frame as its wrapper counts them (one on the card).

Usage:
  python -m hilcodec_tpu_torch.scripts.streaming_roofline [streams=128]
      [--seconds S=2] [--dtype f32|bf16w|bf16] [--fused] [--analytic-only]
      [--probe] [--agree] [--shapes] [--device D]

  --analytic-only  the floors only, no timing
  --probe   the card's cost a launch: chains of 8, 32 and 128 trivial
            kernels launched eagerly, 300 times each, one synchronize at
            the end; the slope in us a launch (JAX: the per-fusion cost of
            barrier-separated ops in a scan)
  --agree   tokens and wav SNR against the f32 program (bf16w / bf16)
  --shapes  every unique convolution signature of one frame step timed
            alone on the card (cuDNN, the f32 parity mode): 16 instances
            in a CUDA graph, replayed, less the replay's fixed
            cost (one trivial kernel's graph); one JSON row a signature,
            and their sum weighted by instances a frame
Runs on the card unless --device cpu is given (then --probe and --shapes,
which time the card, and the kernel count are refused). Timings are CUDA
events around whole runs, each ending in a synchronize; a run chains the
caches from the previous one, as JAX's does.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device, set_f32_parity_mode
from ..bench import (SAMPLE_RATE, _noise, _sync, bench_params,
                     build_bench_model)
from ..ops import rvq_kernel
from . import flops_analysis as fa

REPS = 3
PROBE_CHAINS = (8, 32, 128)
PROBE_ITERS = 300
SHAPE_INSTANCES = 16
SHAPE_REPLAYS = 20


def build(streams: int, seconds: float, dtype_mode: str, fused: bool,
          device) -> SimpleNamespace:
    """The program: model, params, codebooks, audio, caches and
    `enc_dec(wav, ce, cd) -> (tokens, wav_out, ce, cd)` on `device`."""
    device = torch.device(device)
    model = build_bench_model(device)
    params, vq_state = bench_params(model, dtype_mode)
    act = torch.bfloat16 if dtype_mode == "bf16" else torch.float32
    hop = model.hop_length
    n_frames = int(seconds * SAMPLE_RATE) // hop
    wav = _noise((streams, 1, n_frames * hop), device, act)
    ce, cd = model.init_cache(streams, act)

    if fused:
        def enc_dec(wav, ce, cd, params=params, vq_state=vq_state,
                    model=model):
            return model.encode_decode_stream(params, vq_state, wav, ce, cd)
    else:
        def enc_dec(wav, ce, cd, params=params, vq_state=vq_state,
                    model=model):
            tokens, ce = model.encode_stream(params, vq_state, wav, ce)
            out, cd = model.decode_stream(params, vq_state, tokens, cd)
            return tokens, out, ce, cd

    return SimpleNamespace(model=model, params=params, vq_state=vq_state,
                           enc_dec=enc_dec, wav=wav, ce=ce, cd=cd,
                           n_frames=n_frames, hop=hop, act=act,
                           device=device, dtype=dtype_mode, fused=fused)


def frame_rows(prog: SimpleNamespace) -> List[fa.Row]:
    """The counter's rows of one frame step of `prog`, on meta tensors."""
    meta = build(prog.wav.shape[0], (prog.hop + 1) / SAMPLE_RATE,
                 prog.dtype, prog.fused, fa.META)
    with torch.no_grad():
        return fa.analyze(meta.enc_dec, meta.wav, meta.ce, meta.cd)


def analytic_floors(prog: SimpleNamespace) -> Dict[str, float]:
    """Analytic FLOPs a frame step (grouped-conv-correct) and the bytes an
    optimal schedule moves a frame, with their floors on the card."""
    t = fa.totals(frame_rows(prog))
    per_frame = t["conv"] + t["dot"]
    weight_b = fa.tree_bytes(prog.params)
    books_b = fa.tree_bytes(prog.vq_state["embed"])
    cache_b = fa.tree_bytes(prog.ce) + fa.tree_bytes(prog.cd)
    streams = prog.wav.shape[0]
    # the frame in, tokens in and out, the frame out (approximate, as JAX)
    io_b = (streams * prog.hop * prog.wav.element_size()
            + 2 * 8 * streams * 4 + prog.hop)
    hbm = weight_b + books_b + 2 * cache_b + io_b
    return {
        "mxu_flops_per_frame": per_frame,
        "elem_flops_per_frame": t["elem"],
        "mxu_floor_us": per_frame / fa.H100[fa.peak_key(prog.dtype)] * 1e6,
        "weight_bytes": weight_b,
        "codebook_bytes": books_b,
        "cache_bytes_state": cache_b,
        "hbm_bytes_per_frame": hbm,
        "hbm_floor_us": hbm / fa.H100["hbm"] * 1e6,
    }


def timed_s(fn, device: torch.device) -> float:
    """Seconds of one call of `fn`, which ends in a synchronize: CUDA
    events on the card, the host clock elsewhere."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


@torch.no_grad()
def measure(prog: SimpleNamespace):
    """(seconds a run, seconds a frame, RVQ kernel launches a frame): one
    warm-up run, then REPS timed runs, each over every frame with the
    caches chained from the run before."""
    state = {"out": prog.enc_dec(prog.wav, prog.ce, prog.cd)}
    _sync(prog.device)
    before = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]

    def run():
        o = state["out"]
        state["out"] = prog.enc_dec(prog.wav, o[2], o[3])
        _sync(prog.device)

    dt = sum(timed_s(run, prog.device) for _ in range(REPS)) / REPS
    launches = ((rvq_kernel.LAUNCHES[rvq_kernel.KERNEL] - before)
                / (REPS * prog.n_frames))
    return dt, dt / prog.n_frames, launches


@torch.no_grad()
def kernels_per_frame(prog: SimpleNamespace) -> float:
    """Device kernels (memory copies and sets included) of one frame step,
    from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wav = prog.wav[:, :, :prog.hop]
    ce, cd = prog.model.init_cache(wav.shape[0], prog.act)
    prog.enc_dec(wav, ce, cd)
    _sync(prog.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog.enc_dec(wav, ce, cd)
        _sync(prog.device)
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def _need_card(device: torch.device, flag: str) -> None:
    if device.type != "cuda":
        raise SystemExit(f"{flag} times the card; it has no meaning on "
                         f"{device}")


def probe_launch_overhead(device: torch.device) -> Dict[str, float]:
    """The card's cost a launch: chains of k trivial kernels (an in-place
    scale of a 128 x 128 f32 tile) launched eagerly PROBE_ITERS times, one
    synchronize at the end; the slope of the time against k."""
    _need_card(device, "--probe")
    x = torch.ones((128, 128), device=device)
    res = {}
    for k in PROBE_CHAINS:
        def chain(k=k):
            for _ in range(PROBE_ITERS):
                for _i in range(k):
                    x.mul_(1.0001)
            torch.cuda.synchronize(device)
        chain()
        res[k] = timed_s(chain, device) / PROBE_ITERS
    lo, hi = PROBE_CHAINS[0], PROBE_CHAINS[-1]
    slope_us = (res[hi] - res[lo]) / (hi - lo) * 1e6
    return {f"chain_{k}_launches_us_per_iter": round(res[k] * 1e6, 2)
            for k in PROBE_CHAINS} | {"per_launch_us": round(slope_us, 3)}


def graph_us(fn, device: torch.device) -> float:
    """Device us of one replay of a CUDA graph of `fn`, the median of
    SHAPE_REPLAYS replays between CUDA events."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(SHAPE_REPLAYS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return float(np.median(times))


def probe_conv_shapes(prog: SimpleNamespace) -> dict:
    """Every unique convolution signature of one frame step timed alone:
    SHAPE_INSTANCES instances in one CUDA graph, less the fixed
    cost of a replay (a graph of one trivial kernel), over the instances.
    The sum weighted by instances a frame is the floor cuDNN admits for
    these shapes."""
    _need_card(prog.device, "--shapes")
    dev = prog.device
    peak = fa.H100[fa.peak_key(prog.dtype)]
    sigs = fa.conv_signatures(frame_rows(prog))
    tiny = torch.ones((128, 128), device=dev)
    intercept_us = graph_us(lambda: tiny.mul_(1.0001), dev)
    gen = torch.Generator().manual_seed(3)
    per_shape, total_us, total_flops = [], 0.0, 0.0
    for sig, (count, flops) in sorted(sigs.items(), key=lambda kv: -kv[1][0]):
        (xs, xdt, ws, wdt, stride, pad, dil, transposed, out_pad,
         groups) = sig
        x = (torch.randn(xs, generator=gen) * 0.1).to(dev, xdt)
        w = (torch.randn(ws, generator=gen) * 0.1).to(dev, wdt)

        def instances(x=x, w=w, sig=sig):
            for _ in range(SHAPE_INSTANCES):
                torch.convolution(x, w, None, stride, pad, dil, transposed,
                                  out_pad, groups)

        conv_us = max(graph_us(instances, dev) - intercept_us,
                      0.0) / SHAPE_INSTANCES
        per_shape.append({
            "lhs": list(xs), "rhs": list(ws), "g": groups,
            "transposed": transposed, "count": count,
            "us": round(conv_us, 2),
            "tflops": round(flops / max(conv_us, 1e-3) / 1e6, 1),
            "eff_vs_peak": round(flops / max(conv_us, 1e-3) * 1e6 / peak,
                                 3)})
        total_us += conv_us * count
        total_flops += flops * count
    return {
        "shape_floor_intercept_us": round(intercept_us, 2),
        "shape_floor_conv_us_per_frame": round(total_us, 1),
        "shape_floor_conv_flops_per_frame": total_flops,
        "shape_floor_avg_eff_vs_peak": round(
            total_flops / max(total_us, 1e-3) * 1e6 / peak, 3),
        "conv_signatures": per_shape,
    }


def agreement(prog: SimpleNamespace) -> Dict[str, float]:
    """Tokens and wav SNR of the program against the f32 program on the
    same seeded audio, each run once from zero caches."""
    ref_prog = build(prog.wav.shape[0], prog.n_frames * prog.hop
                     / SAMPLE_RATE, "f32", prog.fused, prog.device)
    with torch.no_grad():
        ref = ref_prog.enc_dec(ref_prog.wav, ref_prog.ce, ref_prog.cd)
        ours = prog.enc_dec(prog.wav, *prog.model.init_cache(
            prog.wav.shape[0], prog.act))
    tok_ref = ref[0].cpu().numpy()
    wav_ref = ref[1].float().cpu().numpy()
    tok, wv = ours[0].cpu().numpy(), ours[1].float().cpu().numpy()
    err = wv - wav_ref
    snr = 10 * np.log10((wav_ref ** 2).mean()
                        / max((err ** 2).mean(), 1e-20))
    return {"token_agreement": round(float((tok == tok_ref).mean()), 6),
            "wav_snr_db_vs_f32": round(float(snr), 1)}


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m hilcodec_tpu_torch.scripts.streaming_roofline")
    p.add_argument("streams", type=int, nargs="?", default=128)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16w", "bf16"])
    for flag in ("--fused", "--analytic-only", "--probe", "--agree",
                 "--shapes"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without it)")
    return p.parse_args(argv)


def run(argv: Optional[List[str]] = None) -> List[dict]:
    """The report (and, with --shapes, one row a signature), printed as
    JSON lines and returned."""
    ns = parse_args(argv)
    device = resolve_device(ns.device)
    if device.type == "cuda":
        set_f32_parity_mode()
    prog = build(ns.streams, ns.seconds, ns.dtype, ns.fused, device)
    if prog.n_frames < 1:
        raise SystemExit(f"--seconds {ns.seconds} is shorter than a frame")
    report = {"streams": ns.streams, "dtype": ns.dtype, "fused": ns.fused,
              "n_frames": prog.n_frames,
              "frame_budget_us": prog.hop / SAMPLE_RATE * 1e6}
    fl = analytic_floors(prog)
    report |= {k: (round(v, 2) if isinstance(v, float) else v)
               for k, v in fl.items()}
    if not ns.analytic_only:
        dt, per_frame, launches = measure(prog)
        peaks = fa.card_peaks(device)
        report |= {
            "measured_total_s": round(dt, 4),
            "measured_us_per_frame": round(per_frame * 1e6, 2),
            "rtf": round(ns.streams * prog.n_frames * prog.hop
                         / SAMPLE_RATE / dt, 1),
            "achieved_tflops": round(
                fl["mxu_flops_per_frame"] / per_frame / 1e12, 2),
            "achieved_hbm_gbps_floor_bytes": round(
                fl["hbm_bytes_per_frame"] / per_frame / 1e9, 1),
            "rvq_kernel_launches_per_frame": launches,
        }
        if peaks:
            report["mfu_vs_peak"] = round(
                fl["mxu_flops_per_frame"] / per_frame
                / peaks[fa.peak_key(ns.dtype)], 4)
        if device.type == "cuda":
            report["n_kernels_per_frame"] = kernels_per_frame(prog)
        if ns.agree and ns.dtype != "f32":
            report |= agreement(prog)
    if ns.probe:
        report |= probe_launch_overhead(device)
    rows = [report]
    if ns.shapes:
        sh = probe_conv_shapes(prog)
        rows += sh.pop("conv_signatures")
        report |= sh
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
