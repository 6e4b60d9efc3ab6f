#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`hilcodec_tpu_torch`) on one card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA card and `nvcc` (CUDA_HOME or /usr/local/cuda), and exits non-zero
without a result line when CUDA is unavailable or a phase fails. Phases:

  1. device: card name and power limit, TF32 off, build every kernel of
     the path from the checkout's sources (one nvcc per source, started
     together);
  2. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes the serving path gives it and more, then timed with
     CUDA events beside its plain version and its bound;
  3. serving: the flagship speech model (configs/hilcodec_speech.yaml,
     seeded random weights, N(0,1) codebooks, folded) behind a 16-slot
     roundtrip SlotEngine and the TCP CodecServer on 127.0.0.1; several
     concurrent clients each stream 1 s of seeded audio; every reply is
     checked, and each client against a solo encode_decode_stream on the
     card with the plain quantizer; the kernels' launch counts of this run
     must cover every tick;
  4. timings: engine tick p50/p99 and aggregate real-time factor at 16 and
     128 slots (engine ticks without TCP), then device kernel time and
     kernel count per tick under torch.profiler.

The line before the last is {"kernels": [...]}, one entry per kernel of
the path; the last line is {"ok": true, "device": {...}}.
"""

import asyncio
import json
import os
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "hilcodec_speech.yaml")
SEED = 0
N_CLIENTS = 8
CLIENT_FRAMES = 75            # 1 s at 24 kHz / hop 320
SERVE_SLOTS = 16
TIMED_TICKS = 100
# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# PCM: engine int16 output vs the solo float stream rounded on the host.
# The two runs batch 16 rows vs 1, so cuDNN may pick other algorithms and
# sum in another order (~1e-6 relative through ~100 layers); rounding to
# int16 can then differ by one step. Allow 2 steps (6.1e-5).
PCM_TOL_LSB = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls: int = 10, repeats: int = 50) -> float:
    """Steady-state milliseconds per call of `fn` on the card: CUDA events
    around `calls` back-to-back calls, the median over `repeats` such runs
    (a single call between two events would add the host's launch time)."""
    import torch
    for _ in range(5):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


# --------------------------------------------------------------- phase 1

def phase_device():
    import torch
    from hilcodec_tpu_torch import set_f32_parity_mode
    from hilcodec_tpu_torch.ops import cuda_build

    name = torch.cuda.get_device_name(0)
    line = card_line()
    log(f"[device] {name}; nvidia-smi name,power.limit: {line}")
    set_f32_parity_mode()
    log("[device] TF32 off for cuDNN convolutions and cuBLAS matmuls "
        "(f32 parity mode)")
    sources = ["rvq"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(cuda_build.build, sources))
    for src, (path, secs, report) in zip(sources, built):
        log(f"[device] built csrc/{src}.cu with {cuda_build.nvcc()} "
            f"{' '.join(cuda_build.NVCC_FLAGS)} in {secs:.2f} s -> "
            f"{os.path.relpath(path, ROOT)}")
        for ln in report.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"[device]   ptxas: {ln.strip()}")
    log(f"[device] kernel build wall {time.perf_counter() - t0:.2f} s")
    return name, line


# --------------------------------------------------------------- phase 2

def rvq_bound_ms(M: int, n: int, K: int, C: int):
    """Least time for the cascade: dot-product FLOPs over the f32 peak vs
    bytes (x, the n codebooks and their norms read once, idx written
    once) over the HBM rate. Returns (ms, "operations"|"bytes")."""
    flops = 2.0 * M * K * C * n
    nbytes = 4.0 * (M * C + n * K * C + n * K + n * M)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(dev):
    import torch
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel

    gen = torch.Generator().manual_seed(SEED + 1)
    books8 = torch.randn((8, 1024, 128), generator=gen).to(dev)
    books32 = torch.randn((32, 1024, 128), generator=gen).to(dev)
    cases = [(books8, M, n) for M in (1, 7, 16, 128, 1000) for n in (8, 3)]
    cases += [(books32, M, 32) for M in (7, 128)]
    max_err = 0.0
    failed = []
    for books, M, n in cases:
        # unit-norm-scaled latents like the encoder's l2norm output
        x = torch.randn((1, M, 128), generator=gen).to(dev)
        x = x / x.norm(dim=-1, keepdim=True) * 128 ** 0.5
        got = rvq_kernel.quantize_cuda(x, books, n)
        torch.cuda.synchronize()
        ref = rvq.quantize(x, books, n)
        rep = rvq.token_parity_report(got, ref, x, books)
        err = float((rvq.dequantize(got, books)
                     - rvq.dequantize(ref, books)).abs().max())
        max_err = max(max_err, err)
        log(f"[kernel] rvq_cascade M={M} n={n} n_q={books.shape[0]} "
            f"K=1024 C=128: mismatches {rep['mismatches']} "
            f"(ties {rep['ties']}, not ties {rep['not_ties']}), "
            f"dequantized max abs err {err:.3g} "
            f"-> {'ok' if rep['ok'] else 'FAIL'}")
        if not rep["ok"] or tuple(got.shape) != (n, 1, M):
            failed.append((M, n, books.shape[0]))
    if failed:
        raise AssertionError(f"rvq_cascade disagrees with its plain "
                             f"version at {failed}")

    timings = {}
    for M in (SERVE_SLOTS, 128):
        x = torch.randn((1, M, 128), generator=gen).to(dev)
        ms = cuda_ms(lambda: rvq_kernel.quantize_cuda(x, books8, 8))
        plain_ms = cuda_ms(lambda: rvq.quantize(x, books8, 8))
        bound_ms, bound_by = rvq_bound_ms(M, 8, 1024, 128)
        timings[M] = (ms, plain_ms, bound_ms, bound_by)
        log(f"[kernel] rvq_cascade M={M} n=8 K=1024 C=128: kernel "
            f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}); no single PyTorch call "
            f"computes the cascade, so there is no library yardstick")
    return max_err, timings


# --------------------------------------------------------------- phase 3

def build_flagship(device):
    """Flagship model, seeded folded params (zero-init scales set nonzero)
    and N(0, 1) codebooks."""
    import torch
    from hilcodec_tpu_torch.models.registry import build_codec_model
    from hilcodec_tpu_torch.utils import params as P
    from hilcodec_tpu_torch.utils.hparams import load_config

    hps = load_config(CONFIG)
    model = build_codec_model(hps.model, hps.model_kwargs.to_dict(),
                              device=device)
    gen = torch.Generator().manual_seed(SEED)
    params = model.codec.init(gen)
    flat = P.flatten(params)
    for k, v in flat.items():
        if k.endswith("scale_param"):
            flat[k] = torch.rand(v.shape, generator=gen) + 0.5
    params = model.fold_params(P.unflatten(flat))
    books = torch.randn((model.vq.num_quantizers, model.vq.codebook_size,
                         model.vq.dim), generator=gen)
    params, vq_state = model.to_device(params, {"embed": books})
    return model, params, vq_state, hps.data.sampling_rate


def client_audio(i: int, hop: int) -> np.ndarray:
    """Seeded speech-band test signal: two tones plus noise."""
    rng = np.random.default_rng(SEED + 100 + i)
    t = np.arange(CLIENT_FRAMES * hop) / 24000.0
    f0, f1 = rng.uniform(100, 300), rng.uniform(500, 2000)
    wav = (0.2 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * f1 * t)
           + 0.05 * rng.standard_normal(t.shape))
    return np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)


async def run_client(port: int, pcm16: np.ndarray, hop: int, n_q: int):
    lenf = struct.Struct("<I")
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b'{"mode": "roundtrip"}\n')
        hdr = json.loads(await asyncio.wait_for(reader.readline(), 60))
        if not hdr.get("ok"):
            raise AssertionError(f"server refused: {hdr}")
        toks, pcms = [], []
        for f in range(len(pcm16) // hop):
            frame = pcm16[f * hop:(f + 1) * hop]
            writer.write(lenf.pack(frame.nbytes) + frame.tobytes())
            await writer.drain()
            (ln,) = lenf.unpack(await asyncio.wait_for(
                reader.readexactly(4), 60))
            arr = np.frombuffer(await asyncio.wait_for(
                reader.readexactly(ln), 60), np.int16)
            if arr.size != n_q + hop:
                raise AssertionError(f"reply of {arr.size} values")
            toks.append(arr[:n_q].copy())
            pcms.append(arr[n_q:].copy())
        return np.stack(toks, axis=1), np.concatenate(pcms)
    finally:
        writer.close()


def phase_serve(model, params, vq_state, sr):
    import torch
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel
    from hilcodec_tpu_torch.serve import CodecServer, SlotEngine

    hop, n_q = model.hop_length, model.vq.num_quantizers
    engine = SlotEngine(model, params, vq_state, slots=SERVE_SLOTS,
                        mode="roundtrip", fold=False, device=model.device)
    log(f"[serve] {SERVE_SLOTS}-slot roundtrip engine warmup "
        f"{engine.warmup():.2f} s")
    audio = [client_audio(i, hop) for i in range(N_CLIENTS)]

    async def go():
        srv = CodecServer(engine, sr=sr, port=0)
        await srv.start()
        try:
            return await asyncio.gather(*(run_client(srv.port, a, hop, n_q)
                                          for a in audio))
        finally:
            await srv.stop()

    ticks0 = engine.stats["ticks"]
    rvq_kernel.reset_launches()
    t0 = time.perf_counter()
    replies = asyncio.run(go())
    wall = time.perf_counter() - t0
    launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
    ticks = engine.stats["ticks"] - ticks0
    log(f"[serve] {N_CLIENTS} TCP clients x {CLIENT_FRAMES} frames answered "
        f"in {wall:.2f} s over {ticks} ticks; rvq_cascade launches {launches}")
    if launches < ticks or ticks == 0:
        raise AssertionError(f"rvq_cascade launched {launches} times in "
                             f"{ticks} ticks")

    books = vq_state["embed"]
    enc, dec = model.codec.encoder, model.codec.decoder
    worst_lsb, n_ties = 0, 0
    for i, ((tok, pcm), a) in enumerate(zip(replies, audio)):
        if tok.shape != (n_q, CLIENT_FRAMES) or pcm.shape != a.shape:
            raise AssertionError(f"client {i}: shapes {tok.shape} "
                                 f"{pcm.shape}")
        if tok.min() < 0 or tok.max() >= model.vq.codebook_size:
            raise AssertionError(f"client {i}: token out of range")
        # solo reference on the card, frame by frame as encode_decode_stream
        # runs it but with the plain quantizer: same int16 input
        with torch.no_grad():
            wav = torch.from_numpy(a.astype(np.float32) / 32768.0).to(
                model.device)[None, None]
            ce, cd = model.init_cache(1)
            zs, ref_toks, ref_outs = [], [], []
            for f in range(CLIENT_FRAMES):
                z, ce = enc.step(params["encoder"], ce,
                                 wav[:, :, f * hop:(f + 1) * hop])
                idx = rvq.quantize(z.transpose(1, 2), books)
                y, cd = dec.step(params["decoder"], cd,
                                 rvq.dequantize(idx, books).transpose(1, 2))
                zs.append(z)
                ref_toks.append(idx)
                ref_outs.append(y)
            ref_tok = torch.cat(ref_toks, -1)
            ref_wav = torch.cat(ref_outs, -1)
        rep = rvq.token_parity_report(torch.from_numpy(tok.astype(np.int64)),
                                      ref_tok[:, 0], torch.cat(zs, -1)[0].T,
                                      books)
        if not rep["ok"]:
            raise AssertionError(f"client {i}: tokens differ from the solo "
                                 f"stream beyond fp ties: {rep}")
        n_ties += rep["ties"]
        ref16 = torch.clamp(torch.round(ref_wav[0, 0] * 32768.0), -32768,
                            32767).cpu().numpy().astype(np.int64)
        # PCM is compared up to the first frame whose tokens differ (a tie
        # changes the decoder's input from there on)
        diff = (tok != ref_tok[:, 0].cpu().numpy()).any(0)
        upto = (int(np.argmax(diff)) if diff.any() else CLIENT_FRAMES) * hop
        lsb = int(np.abs(pcm[:upto].astype(np.int64) - ref16[:upto]).max())
        worst_lsb = max(worst_lsb, lsb)
        if lsb > PCM_TOL_LSB or not np.isfinite(ref_wav.cpu().numpy()).all():
            raise AssertionError(f"client {i}: PCM off by {lsb} steps")
    log(f"[serve] all {N_CLIENTS} clients match the solo plain-quantizer "
        f"stream: tokens (fp ties {n_ties}), PCM max |diff| {worst_lsb} "
        f"int16 steps (tolerance {PCM_TOL_LSB})")
    return launches


# --------------------------------------------------------------- phase 4

def phase_timings(model, params, vq_state, card):
    from hilcodec_tpu_torch.serve import SlotEngine

    hop = model.hop_length
    frame_s = hop / 24000.0
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for slots in (16, 128):
        engine = SlotEngine(model, params, vq_state, slots=slots,
                            mode="roundtrip", fold=False,
                            device=model.device)
        engine.warmup()
        for _ in range(slots):
            engine.attach()
        times = []
        for t in range(TIMED_TICKS + 5):
            for s in range(slots):
                engine.submit(s, (rng.standard_normal(hop) * 3000).astype(
                    np.int16))
            t0 = time.perf_counter()
            engine.tick()
            if t >= 5:
                times.append(time.perf_counter() - t0)
        p50, p99 = np.percentile(times, 50), np.percentile(times, 99)
        rtf = slots * frame_s / float(np.mean(times))
        out[slots] = (p50, p99, rtf)
        log(f"[timing] {slots} slots: engine tick p50 {p50 * 1e3:.2f} ms, "
            f"p99 {p99 * 1e3:.2f} ms, aggregate real-time factor "
            f"{rtf:.1f}x over {TIMED_TICKS} ticks ({card})")
        profile_ticks(engine, slots, p50, rng)
    return out


def profile_ticks(engine, slots, p50_s, rng, ticks=10):
    """Device kernel time and kernel count per tick under torch.profiler,
    and the device's busy share of the unprofiled p50 tick."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    hop = engine.hop
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            for s in range(slots):
                engine.submit(s, (rng.standard_normal(hop) * 3000).astype(
                    np.int16))
            engine.tick()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in dev) / ticks / 1e3
    n_kernels = sum(e.count for e in dev) / ticks
    log(f"[profile] {slots} slots: {dev_ms:.2f} ms of device kernels and "
        f"{n_kernels:.0f} kernels per tick; device busy "
        f"{dev_ms / (p50_s * 1e3) * 100:.0f}% of the p50 tick")
    for e in sorted(dev, key=lambda e: -e.device_time_total)[:6]:
        log(f"[profile]   {e.device_time_total / ticks / 1e3:.3f} ms "
            f"x{e.count / ticks:.0f}/tick  {e.key[:80]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import hilcodec_tpu_torch  # noqa: F401  (fails outside a checkout)
    from hilcodec_tpu_torch.ops import rvq_kernel

    name, line = phase_device()
    max_err, timings = phase_kernels(torch.device("cuda"))
    model, params, vq_state, sr = build_flagship("cuda")
    launches = phase_serve(model, params, vq_state, sr)
    phase_timings(model, params, vq_state, line)

    # the serving path launches the kernel at M = SERVE_SLOTS rows
    ms, plain_ms, bound_ms, bound_by = timings[SERVE_SLOTS]
    print(line)
    print(json.dumps({"kernels": [{
        "name": rvq_kernel.KERNEL, "route": "cuda",
        "source": rvq_kernel.SOURCE,
        "replaces": "hilcodec_tpu/ops/pallas_rvq.py:148",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
