#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`hilcodec_tpu_torch`) on one card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA card and `nvcc` (CUDA_HOME or /usr/local/cuda), and exits non-zero
without a result line when CUDA is unavailable or a phase fails. Phases:

  1. device: card name and power limit, TF32 off, build every kernel of
     the path from the checkout's sources (csrc/rvq.cu and
     csrc/segment.cu, one nvcc per source, started together); ptxas's
     register and spill report, failing on any spill in either;
  2. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes the serving path gives it and more, then timed with
     CUDA events beside its plain version and its bound: the RVQ cascade
     (its plans, clusters of 16 CTAs at few rows and of 8 at many; M up
     to 1000; ragged K and K below the cluster size at C = 64; duplicate
     codewords in two CTAs' slices, first index kept; two more launches
     bitwise equal; timed at n = 1, 2, 4, 8 for the per-stage cost and at
     n_q = 32, K2's shape),
     and the decoder and encoder frame
     kernels on the flagship at 1, 3, 7, 16, 64 and 128 streams over 3
     frames, output and every cache, each launched twice more on the same
     inputs to check that it gives the same bits, and on two small models
     of 6 and 10 channels (the kernels' scalar paths); at 16 and 128
     streams a breakdown by phase kind, with the GEMM phases' TFLOP/s beside
     torch.matmul (cuBLAS) on the same shapes;
  3. serving: the flagship speech model (configs/hilcodec_speech.yaml,
     seeded random weights, N(0,1) codebooks, folded) behind a 16-slot
     roundtrip SlotEngine and the TCP CodecServer on 127.0.0.1; several
     concurrent clients each stream 1 s of seeded audio; every reply is
     checked, and each client against a solo encode_decode_stream on the
     card with the plain quantizer; the kernels' launch counts of this run
     must cover every tick;
  4. timings: engine tick p50/p99 and aggregate real-time factor at 16 and
     128 slots (engine ticks without TCP), then device kernel time and
     kernel count per tick under torch.profiler;
  5. frame-kernel path: encode_stream / decode_stream(megakernel=True) on
     the flagship at 128 streams x 75 frames of seeded audio, held against
     megakernel=False (tokens exact or f32 ties, PCM within PCM_TOL_LSB on
     the same tokens); the launch counts of this run of the frame kernels
     and the RVQ cascade must be one per frame;
  6. bench: `python -m hilcodec_tpu_torch.bench S --seconds 1` run
     in-process at S = 16, 64 and 128 streams, plain and --megakernel in
     turns (plain, kernel, kernel, plain), each JSON line logged;
  7. training: (a) the flagship GAN trainer (build_trainer on
     configs/hilcodec_speech.yaml, seeded weights, codebooks k-means-
     initialized on a seeded batch) at batch 24 x 24000 samples of seeded
     speech-like audio: 3 warm-up and 10 timed steps, step ms p50 / p90
     (CUDA events), audio seconds trained per wall second, peak memory,
     a torch.profiler window (device busy, top kernels), the step's FLOPs
     and f32 bound; every loss finite, the params moved, the RVQ kernel
     launched once a step; (b) one step on the card against the same step
     on the CPU (batch 2 x 24000 samples, same state, batch and draws) at
     the bars of tests/test_train_parity.py, AdamP held on the same
     gradients and the whole step's deltas reported; (c) the training
     forward's RVQ-kernel tokens against the plain cascade at M = 1800
     rows, n = 2, 4, 8, and the kernel's time there; (d) `python -m
     hilcodec_tpu_torch.train` on a seeded corpus for one epoch (writes
     00001.ckpt.npz), then resumed for a second.

The line before the last is {"kernels": [...]}, one entry per kernel of
the path; the last line is {"ok": true, "device": {...}}.
"""

import asyncio
import dataclasses
import json
import os
import re
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
PATH_STREAMS = 128            # the frame-kernel path and the bench
# 3 and 64 cross the lowering's tile and split choices and leave ragged
# tiles
FRAME_BATCHES = (1, 3, 7, 16, 64, 128)
BENCH_STREAMS = (16, 64, 128)
# small models whose channel counts are not multiples of 4
ODD_CHANNELS = (6, 10)
# frame kernels vs their plain version: the largest |difference| of a
# tensor (output or cache) over its largest |value| (at least 1). The
# kernel sums up to 1536 products per 1x1 conv in another order than
# cuBLAS and ATen, through ~30 chained layers; 5e-5 is ~400 f32 ulps of
# the tensor's scale.
FRAME_TOL = 5e-5
# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, TF32
# on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# TF32 products per f32-accurate product in the frame kernels' GEMMs
# (3xTF32)
TF32_PRODUCTS = 3
# PCM: engine int16 output vs the solo float stream rounded on the host,
# and the frame-kernel path vs the plain one. On the CPU the port is
# bitwise batch-invariant (tests/test_torch_serve.py holds 0 steps), but on
# the card cuDNN and cuBLAS may pick their algorithms by batch (16 rows vs
# 1) and the frame kernels sum in another order (~1e-6 relative through
# ~100 layers); rounding to int16 can then differ by one step. Allow 2
# steps (6.1e-5).
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


def graph_ms(fn, calls: int = 20, repeats: int = 20) -> float:
    """Device milliseconds per call of `fn` with the host's launch cost out
    of the way: `calls` calls captured in one CUDA graph, replayed between
    CUDA events, the median over `repeats` replays. For a kernel shorter
    than its wrapper's host time, which cuda_ms would measure instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def host_ms(fn, calls: int = 200) -> float:
    """Host milliseconds per call of `fn` (enqueue only), after a warm-up;
    the device is synchronised before and after, not in between."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


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
    sources = ["rvq", "segment"]
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
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", report)
        if not spills or any(int(a) or int(b) for a, b in spills):
            raise AssertionError(f"csrc/{src}.cu: ptxas reports spills "
                                 f"(or no report): {spills}")
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
    """The RVQ cascade against its plain version at every case below, each
    case launched twice more on the same inputs (the same bits), with the
    plan its wrapper chose (clusters of 16 CTAs up to 56 rows on an H100,
    of 8 beyond: both arise); then timed: n = 1, 2, 4, 8 at 16 and 128
    rows (the per-stage slope and the fixed cost), and beside its plain
    version and its bound at n = 8 and at K2's n_q = 32."""
    import torch
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel

    def plan_line(M, K, C, n):
        plan, held = rvq_kernel.device_plan(dev, M, K, C, n)
        return (f"cluster G={plan.cluster}, rows TM={plan.rows}, chunk "
                f"{plan.codes} codewords, ring R={plan.ring}, slice "
                f"{plan.slice} codewords x {plan.chunks} chunk(s), "
                f"{plan.tiles} cluster(s) = {plan.tiles * plan.cluster} "
                f"CTAs, {plan.smem} B shared memory a CTA; max active "
                f"clusters " + ", ".join(
                    f"{h} of G={g} x TM={r}" for (g, r), h in held.items()))

    gen = torch.Generator().manual_seed(SEED + 1)
    books8 = torch.randn((8, 1024, 128), generator=gen).to(dev)
    books32 = torch.randn((32, 1024, 128), generator=gen).to(dev)
    # ragged K, and K < G (CTAs with empty slices), at C = 64
    books_k1000 = torch.randn((3, 1000, 64), generator=gen).to(dev)
    books_k16 = torch.randn((3, 16, 64), generator=gen).to(dev)
    # codewords 100 and 900 of stage 0 equal, in different CTAs' slices
    dup = torch.randn((2, 1024, 128), generator=gen)
    dup[0, 900] = dup[0, 100]
    dup = dup.to(dev)
    cases = [(books8, M, n) for M in (1, 7, 16, 128, 1000) for n in (8, 3)]
    cases += [(books32, M, 32) for M in (7, 128)]
    cases += [(b, M, 3) for b in (books_k1000, books_k16)
              for M in (7, 128, 1000)]
    cases += [(dup, M, 2) for M in (16, 64)]

    for M, n in ((SERVE_SLOTS, 8), (128, 8), (1000, 8), (128, 32)):
        log(f"[kernel] rvq_cascade plan M={M} n={n} K=1024 C=128: "
            + plan_line(M, 1024, 128, n))

    max_err = 0.0
    failed = []
    for books, M, n in cases:
        n_q, K, C = books.shape
        # unit-norm-scaled latents like the encoder's l2norm output
        x = torch.randn((1, M, C), generator=gen)
        x = x / x.norm(dim=-1, keepdim=True) * C ** 0.5
        if books is dup:
            x[0, ::4] = dup[0, 100].cpu() + 0.01 * torch.randn(
                (M // 4, C), generator=gen)
        x = x.to(dev)
        ref = rvq.quantize(x, books, n)
        got = rvq_kernel.quantize_cuda(x, books, n)
        again = [rvq_kernel.quantize_cuda(x, books, n) for _ in range(2)]
        torch.cuda.synchronize()
        plan, _ = rvq_kernel.device_plan(dev, M, K, C, n)
        same = all(torch.equal(got, a) for a in again)
        rep = rvq.token_parity_report(got, ref, x, books)
        err = float((rvq.dequantize(got, books)
                     - rvq.dequantize(ref, books)).abs().max())
        max_err = max(max_err, err)
        ok = rep["ok"] and same and tuple(got.shape) == (n, 1, M)
        what = ""
        if books is dup:
            first = bool((got[0, 0, ::4] == 100).all())
            ok = ok and first and rep["mismatches"] == 0
            what = (f"; duplicate codewords 100 = 900 in two slices: "
                    f"first index {'kept' if first else 'LOST'}")
        log(f"[kernel] rvq_cascade G={plan.cluster} TM={plan.rows} M={M} "
            f"n={n} n_q={n_q} K={K} C={C}: mismatches {rep['mismatches']} "
            f"(ties {rep['ties']}, not ties {rep['not_ties']}), dequantized "
            f"max abs err {err:.3g}; two more launches "
            f"{'bitwise equal' if same else 'DIFFER'}{what} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((M, n, n_q, K, C))
    if failed:
        raise AssertionError(f"rvq_cascade disagrees with its plain "
                             f"version, or with itself, at {failed}")

    # device time through a CUDA graph: the wrapper's host time per call
    # (host_ms) is longer than the kernel, so back-to-back launches would
    # time the host
    for M in (SERVE_SLOTS, 128):
        x = torch.randn((1, M, 128), generator=gen).to(dev)
        per_n = {n: graph_ms(lambda: rvq_kernel.quantize_cuda(
            x, books8, n)) for n in (1, 2, 4, 8)}
        slope = (per_n[8] - per_n[1]) / 7
        G = rvq_kernel.device_plan(dev, M, 1024, 128, 8)[0].cluster
        log(f"[kernel] rvq_cascade G={G} M={M} K=1024 C=128 by stages: "
            + ", ".join(f"n={n} {ms * 1e3:.2f} us"
                        for n, ms in per_n.items())
            + f"; {slope * 1e3:.2f} us a stage, "
            f"{(per_n[1] - slope) * 1e3:.2f} us fixed")

    timings = {}
    for books, n in ((books8, 8), (books32, 32)):
        for M in (SERVE_SLOTS, 128):
            x = torch.randn((1, M, 128), generator=gen).to(dev)
            ms = graph_ms(lambda: rvq_kernel.quantize_cuda(x, books, n))
            eager_ms = cuda_ms(lambda: rvq_kernel.quantize_cuda(x, books, n))
            enqueue_ms = host_ms(lambda: rvq_kernel.quantize_cuda(x, books, n))
            plain_ms = cuda_ms(lambda: rvq.quantize(x, books, n))
            bound_ms, bound_by = rvq_bound_ms(M, n, 1024, 128)
            G = rvq_kernel.device_plan(dev, M, 1024, 128, n)[0].cluster
            timings[(M, n)] = (ms, plain_ms, bound_ms, bound_by)
            log(f"[kernel] rvq_cascade M={M} n={n} K=1024 C=128: kernel "
                f"{ms * 1e3:.2f} us (G={G}; CUDA graph); through the "
                f"wrapper back to back {eager_ms * 1e3:.2f} us, its host "
                f"time {enqueue_ms * 1e3:.2f} us a call; plain "
                f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
                f"({bound_by}); no single PyTorch call computes the "
                f"cascade, so there is no library yardstick")
    return max_err, timings


def frame_bound_ms(mk, w, x, aux, caches):
    """Least time for one frame step of `mk` on these inputs, on two
    engines: the larger of its operations over the peak and its bytes
    (input, aux, weights and caches read once; output and caches written
    once) over the HBM rate. "f32": every f32 operation on the CUDA cores;
    "tc": the 1x1-conv products at TF32_PRODUCTS TF32 products each on the
    tensor cores (the engine the kernel uses for them), the rest on the
    CUDA cores. Returns ({"f32"|"tc": (ms, "operations"|"bytes")}, flops,
    GEMM flops)."""
    from hilcodec_tpu_torch.ops import decoder_kernel as DK
    B = x.shape[0]
    t, c = (x.shape[1], 1) if x.ndim == 2 else (x.shape[1], x.shape[2])
    flops = gemm = 0
    for op, (ti, ci, to, co) in zip(mk.ops, DK.op_shapes(mk.ops, t, c)):
        a = op.attrs
        if op.kind == "pw":
            gemm += 2 * to * ci * co
        elif op.kind == "mix":
            gemm += 2 * to * a["f"] * co
            flops += to * co
        elif op.kind in ("dw", "post", "dense1ch"):
            flops += 2 * to * (ci if op.kind == "post" else co) * a["k"]
        elif op.kind == "dws":
            flops += 2 * to * co * a["k"]
        elif op.kind == "convt":
            flops += 4 * to * co
        elif op.kind == "l2norm":
            flops += 3 * ti * ci
        elif op.kind != "res_begin" or a["pre_scale"] is not None:
            flops += ti * ci                 # act, scale, residual add
    flops, gemm = flops * B, gemm * B
    t_out, c_out = DK.op_shapes(mk.ops, t, c)[-1][2:]
    floats = (x.numel() + sum(a.numel() for a in aux)
              + sum(v.numel() for lay in w.per_op if lay
                    for v in lay.values())
              + 2 * sum(cc.numel() for cc in caches) + B * t_out * c_out)
    t_bytes = 4.0 * floats / PEAK_HBM_BYTES
    bounds = {}
    for engine, t_ops in (
            ("f32", (gemm + flops) / PEAK_F32_FLOPS),
            ("tc", gemm * TF32_PRODUCTS / PEAK_TF32_FLOPS
             + flops / PEAK_F32_FLOPS)):
        bounds[engine] = (max(t_ops, t_bytes) * 1e3,
                          "operations" if t_ops >= t_bytes else "bytes")
    return bounds, gemm + flops, gemm


def frame_cases(model, params, B, gen):
    """Per frame kernel: (name, its step object, params, inputs(cache,
    frame) -> (kernel inputs x, aux, the layer caches, the next wav ring),
    first cache, frame maker)."""
    import torch
    from hilcodec_tpu_torch.models.codec import (_decoder_megakernel,
                                                 _encoder_megakernel)
    from hilcodec_tpu_torch.ops import rvq
    dev = model.device
    dm = _decoder_megakernel(model.codec.decoder)
    em = _encoder_megakernel(model.codec.encoder)
    vq = model.vq
    books = torch.randn((vq.num_quantizers, vq.codebook_size, vq.dim),
                        generator=gen).to(dev)

    def dec_frame():
        tok = torch.randint(0, vq.codebook_size, (vq.num_quantizers, B, 1),
                            generator=gen).to(dev)
        return rvq.dequantize(tok, books)          # time-major [B, 1, 128]

    def enc_frame():
        return (torch.randn((B, 1, model.hop_length), generator=gen)
                * 0.3).to(dev)

    def dec_inputs(cache, q):
        return q, [], cache, None

    def enc_inputs(cache, x):
        ring, window, aux = em.frame_inputs(cache[0], x)
        return window, aux, cache[1:], ring

    return [("decoder_frame", dm, params["decoder"], dec_inputs,
             dm.init_cache(B, device=dev), dec_frame),
            ("encoder_frame", em, params["encoder"], enc_inputs,
             em.init_cache(B, device=dev), enc_frame)]


def phase_frame_kernels(model, params, batches=FRAME_BATCHES, tag=""):
    """The decoder and encoder frame kernels against their plain version,
    3 frames with the caches threaded through, twice more on the last
    frame's inputs (the same bits); on the flagship (no `tag`) timed at
    SERVE_SLOTS and PATH_STREAMS streams."""
    import torch
    from hilcodec_tpu_torch.ops import decoder_kernel as DK

    gen = torch.Generator().manual_seed(SEED + 3)
    worst = {}
    timings = {}
    for B in batches:
        for name, mk, p, inputs, cache, frame in frame_cases(
                model, params, B, gen):
            w = mk.weights(p)
            rel = 0.0
            abs_err = 0.0
            for f in range(3):
                x, aux, layer_caches, ring = inputs(cache, frame())
                y, got = mk.run(p, x, aux, layer_caches)
                torch.cuda.synchronize()
                y_ref, ref = DK.run_plain(mk.ops, w.per_op, x, aux,
                                          layer_caches)
                for a, b in zip([y] + got, [y_ref] + ref):
                    if a.shape != b.shape or not torch.isfinite(a).all():
                        raise AssertionError(f"{name} B={B}: bad output")
                    err = float((a - b).abs().max())
                    scale = max(1.0, float(b.abs().max()))
                    abs_err, rel = max(abs_err, err), max(rel, err / scale)
                cache = ref if ring is None else [ring] + ref
            again = [mk.run(p, x, aux, layer_caches) for _ in range(2)]
            same = all(torch.equal(a, b) for a, b in zip(
                [again[0][0]] + again[0][1], [again[1][0]] + again[1][1]))
            plan = mk.plan(w, B, x.shape[1], 1 if x.ndim == 2 else x.shape[2],
                           x.device)
            table = plan.phases.cpu().numpy().view(DK.PHASE_DTYPE)
            gemm = table[np.isin(table["kind"], (DK.PW, DK.MIX))]
            tiles = sorted({(int(a), int(b), int(c)) for a, b, c in zip(
                gemm["bm"], gemm["bn"], gemm["splits"])})
            ok = rel <= FRAME_TOL and same
            log(f"[kernel] {name}{tag} B={B} x3 frames: output and "
                f"{len(layer_caches)} caches max abs err {abs_err:.3g}, "
                f"max err / scale {rel:.3g} (tolerance {FRAME_TOL}); two "
                f"more launches on the same inputs "
                f"{'bitwise equal' if same else 'DIFFER'}; GEMM tiles "
                f"(bm x bn / splits) "
                f"{tiles}"
                f" -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}{tag} disagrees with its plain "
                                     f"version, or with itself, at B={B}")
            worst[name] = max(worst.get(name, 0.0), abs_err)
            if not tag and B in (SERVE_SLOTS, PATH_STREAMS):
                step_ms = cuda_ms(lambda: mk.run(p, x, aux, layer_caches),
                                  repeats=20)
                plain_ms = cuda_ms(lambda: DK.run_plain(
                    mk.ops, w.per_op, x, aux, layer_caches), repeats=20)
                bounds, flops, gemm_flops = frame_bound_ms(
                    mk, w, x, aux, layer_caches)
                ms = phase_breakdown(name, mk, p, x, aux, layer_caches,
                                     gemm_flops)
                bound_ms, bound_by = bounds["tc"]
                timings[(name, B)] = (ms, plain_ms, bounds)
                log(f"[kernel] {name} B={B}: kernel {ms:.4f} ms (launches "
                    f"back to back; {step_ms:.4f} ms through the step's "
                    f"wrapper, which also packs the caches), "
                    f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}; GEMMs on the tensor cores at "
                    f"{TF32_PRODUCTS} TF32 products each) or "
                    f"{bounds['f32'][0]:.4f} ms ({bounds['f32'][1]}; all on "
                    f"the f32 CUDA cores); {flops / B / 1e6:.1f} MFLOP a "
                    f"stream; no single PyTorch call computes a frame step")
    return worst, timings


PHASE_NAMES = ("ewise", "pw", "dw", "convt", "post", "dense1ch", "dws",
               "mix", "l2norm")


def phase_breakdown(name, mk, p, x, aux, caches, gemm_flops):
    """Where a frame kernel's time goes, by phase kind: the kernel is timed
    on every prefix of its phase table (the first k phases), and each
    phase is charged the difference between consecutive prefixes (its work
    and the grid barrier before it). The GEMM phases are set beside
    torch.matmul (cuBLAS, f32) on the same shapes and the depthwise family
    beside its bytes. Returns the whole table's time (ms per launch)."""
    import torch
    from hilcodec_tpu_torch.ops import decoder_kernel as DK
    B = x.shape[0]
    w = mk.weights(p)
    t, c = (x.shape[1], 1) if x.ndim == 2 else (x.shape[1], x.shape[2])
    plan = mk.plan(w, B, t, c, x.device)
    table = plan.phases.cpu().numpy().view(DK.PHASE_DTYPE)
    t_out, c_out = DK.op_shapes(mk.ops, t, c)[-1][2:]
    y = torch.empty((B, t_out, c_out), device=x.device)
    cache_in = mk.pack(caches, B)
    cache_out = torch.empty_like(cache_in)
    x, aux = x.contiguous(), [a.contiguous() for a in aux]

    def launch(k):
        sub = dataclasses.replace(plan, n_phases=k)
        return lambda: DK.launch(mk.kernel, {mk.kernel: 0}, sub, w.flat, x,
                                 y, aux, cache_in, cache_out, B)

    prev, by_kind = 0.0, {}
    for k in range(1, plan.n_phases + 1):
        ms = cuda_ms(launch(k), calls=5, repeats=5)
        kind = PHASE_NAMES[int(table["kind"][k - 1])]
        n, tot = by_kind.get(kind, (0, 0.0))
        by_kind[kind] = (n + 1, tot + ms - prev)
        prev = ms
    total = cuda_ms(launch(plan.n_phases), repeats=20)
    log(f"[breakdown] {name} B={B}, {plan.n_phases} phases, "
        f"{total:.4f} ms: " + ", ".join(
            f"{kind} x{n} {tot:.4f} ms"
            for kind, (n, tot) in sorted(by_kind.items(),
                                         key=lambda kv: -kv[1][1])))
    # the GEMM phases against cuBLAS on the same (M, K, N), f32
    shapes = {}
    for ph in table[np.isin(table["kind"], (DK.PW, DK.MIX))]:
        mkn = (B * int(ph["t_in"]), int(ph["c_in"]), int(ph["c_out"]))
        shapes[mkn] = shapes.get(mkn, 0) + 1
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    cublas = 0.0
    for (M, K, N), n in shapes.items():
        a = torch.randn((M, K), generator=gen, device=x.device)
        b = torch.randn((K, N), generator=gen, device=x.device)
        cublas += n * cuda_ms(lambda: torch.matmul(a, b), calls=10,
                              repeats=5)
    gemm_ms = sum(by_kind.get(k, (0, 0.0))[1] for k in ("pw", "mix"))
    # the depthwise family's bytes: input, old cache, weights read once;
    # output and new cache written once
    dw_bytes = 0
    for ph in table[np.isin(table["kind"], (DK.DW, DK.CONVT, DK.POST,
                                             DK.DWS))]:
        ci, co, clen = int(ph["c_in"]), int(ph["c_out"]), int(ph["cache_len"])
        taps = int(ph["k"]) + (int(ph["bias"]) >= 0)
        dw_bytes += 4 * (B * (int(ph["t_in"]) * ci + 2 * clen * ci
                              + int(ph["t_out"]) * co
                              + (int(ph["res"]) >= 0) * int(ph["t_out"]) * co)
                         + taps * ci)
    dw_ms = sum(by_kind.get(k, (0, 0.0))[1]
                for k in ("dw", "convt", "post", "dws"))
    log(f"[breakdown] {name} B={B}: GEMM phases {gemm_ms:.4f} ms, "
        f"{gemm_flops / 1e9:.3f} GFLOP at "
        f"{gemm_flops / max(gemm_ms, 1e-9) / 1e9:.1f} TFLOP/s; "
        f"torch.matmul (cuBLAS, f32) on the same {sum(shapes.values())} "
        f"shapes {cublas:.4f} ms, {gemm_flops / cublas / 1e9:.1f} TFLOP/s; "
        f"depthwise family {dw_ms:.4f} ms for {dw_bytes / 1e6:.2f} MB, "
        f"{dw_bytes / max(dw_ms, 1e-9) / 1e6:.0f} GB/s")
    return total


# --------------------------------------------------------------- phase 3

def build_small(channels):
    """A two-stage HILCodec of `channels` channels (vq dim 14) on the card
    with seeded folded params (zero-init scales set nonzero): with channel
    counts that are not multiples of 4, the frame kernels take their scalar
    copy, epilogue and depthwise paths."""
    import torch
    from hilcodec_tpu_torch.models.codec import CodecModel
    from hilcodec_tpu_torch.models.hilcodec import HILCodec
    from hilcodec_tpu_torch.ops.rvq import ResidualVQ
    from hilcodec_tpu_torch.utils import params as P

    model = CodecModel(
        HILCodec(channels_enc=channels, channels_dec=channels,
                 n_residual_enc=2, n_residual_dec=2, strides=(4, 2),
                 n_fft_base=16, vq_dim=14, res_scale_enc=0.577,
                 res_scale_dec=0.577),
        ResidualVQ(dim=14, codebook_size=32, num_quantizers=3,
                   kmeans_init=False), torch.device("cuda"))
    gen = torch.Generator().manual_seed(SEED + channels)
    params, vq_state = model.init(gen)
    flat = P.flatten(params)
    for k, v in flat.items():
        if k.endswith("scale_param"):
            flat[k] = torch.rand(v.shape, generator=gen) + 0.5
    params, _ = model.to_device(model.fold_params(P.unflatten(flat)),
                                vq_state)
    return model, params


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


# --------------------------------------------------------------- phase 5

def phase_frame_path(model, params, vq_state):
    """encode_stream / decode_stream with the frame kernels at 128 streams
    against the plain frame step; returns each kernel's launches on this
    path (the frame kernels and the RVQ cascade, one per frame each)."""
    import torch
    from hilcodec_tpu_torch.ops import decoder_kernel as DK
    from hilcodec_tpu_torch.ops import encoder_kernel as EK
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel

    hop, books = model.hop_length, vq_state["embed"]
    wav = torch.from_numpy(np.stack([
        client_audio(i, hop).astype(np.float32) / 32768.0
        for i in range(PATH_STREAMS)])[:, None]).to(model.device)
    ce, cd = model.init_cache(PATH_STREAMS)
    with torch.no_grad():
        DK.reset_launches()
        EK.reset_launches()
        rvq_kernel.reset_launches()
        t0 = time.perf_counter()
        tok, ce_k = model.encode_stream(params, vq_state, wav, ce,
                                        megakernel=True)
        out, cd_k = model.decode_stream(params, vq_state, tok, cd,
                                        megakernel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {DK.KERNEL: DK.LAUNCHES[DK.KERNEL],
                    EK.KERNEL: EK.LAUNCHES[EK.KERNEL],
                    rvq_kernel.KERNEL: rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]}
        # the plain frame step on the same audio, latents kept for the tie
        # analysis, then the plain decoder on the kernel path's tokens
        cache, zs, ref = ce, [], []
        for f in range(CLIENT_FRAMES):
            z, cache = model.codec.encoder.step(
                params["encoder"], cache, wav[:, :, f * hop:(f + 1) * hop])
            zs.append(z)
            ref.append(rvq_kernel.quantize(z.transpose(1, 2), books))
        ref_tok = torch.cat(ref, -1)
        ref_out, cd_p = model.decode_stream(params, vq_state, tok, cd)
    log(f"[path] frame-kernel path: {PATH_STREAMS} streams x {CLIENT_FRAMES} "
        f"frames encoded and decoded in {wall:.2f} s; launches {launches}")
    for k, v in launches.items():
        if v != CLIENT_FRAMES:
            raise AssertionError(f"{k} launched {v} times for "
                                 f"{CLIENT_FRAMES} frames")
    rep = rvq.token_parity_report(tok, ref_tok,
                                  torch.cat(zs, -1).transpose(1, 2), books)
    if not rep["ok"]:
        raise AssertionError(f"frame-kernel tokens differ beyond f32 ties: "
                             f"{rep}")
    q = [torch.clamp(torch.round(o * 32768.0), -32768, 32767).long()
         for o in (out, ref_out)]
    lsb = int((q[0] - q[1]).abs().max())
    if (out.shape != wav.shape or not torch.isfinite(out).all()
            or lsb > PCM_TOL_LSB):
        raise AssertionError(f"frame-kernel PCM off by {lsb} steps")
    for a, b in zip(ce_k + cd_k, cache + cd_p):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError("frame-kernel caches changed shape")
    log(f"[path] tokens vs the plain frame step: mismatches "
        f"{rep['mismatches']} (ties {rep['ties']}, not ties "
        f"{rep['not_ties']}); PCM on the same tokens max |diff| {lsb} int16 "
        f"steps (tolerance {PCM_TOL_LSB})")
    return launches


# --------------------------------------------------------------- phase 6

def phase_bench():
    """The bench entry at 16, 64 and 128 streams and 1 s of audio, plain and
    with the frame kernels in turns, in this process."""
    from hilcodec_tpu_torch import bench
    for streams in BENCH_STREAMS:
        base = [str(streams), "--seconds", "1"]
        for extra in ([], ["--megakernel"], ["--megakernel"], []):
            log(f"[bench] python -m hilcodec_tpu_torch.bench "
                f"{' '.join(base + extra)}: "
                f"{json.dumps(bench.run(base + extra))}")


# --------------------------------------------------------------- phase 7

TRAIN_BATCH = 24              # the flagship config's batch
TRAIN_SEGMENT = 24000         # its segment (1 s at 24 kHz)
TRAIN_WARMUP = 3
TRAIN_TIMED = 10
TRAIN_PROFILED = 3
PARITY_BATCH = 2
# card against the port's CPU step (the bars of tests/test_train_parity.py)
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-3
VQ_RTOL = 1e-4
# a leaf's gradient error is taken against max(its norm, GRAD_FLOOR_REL x
# the norm of all of that side's gradients): a leaf whose gradient is a
# near-cancelling sum (a scalar residual scale) is held to that floor
GRAD_FLOOR_REL = 1e-3
# AdamP's first step moves each element by about lr * sign(gradient): an
# element whose two gradients differ by more than its own size (a sign
# tie) moves the other way, and the projection of a scale-invariant
# weight spreads that over its channel. So the optimizer is held on the
# same gradients, and the whole step's deltas and ties are reported
GATE_MARGIN = 1e-3
CLI_STEPS = 3
CLI_BATCH = 4


def speech_batch(rng, batch, length, sr=24000):
    """Seeded speech-like audio [B, 1, T]: a harmonic voice whose f0
    follows a random contour, under a syllable-rate envelope, plus noise."""
    t = np.arange(length) / sr
    f0 = (rng.uniform(90, 260, (batch, 1))
          * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.5, 3, (batch, 1))
                               * t + rng.uniform(0, 6.3, (batch, 1)))))
    phase = 2 * np.pi * np.cumsum(f0 / sr, axis=1)
    wav = np.zeros((batch, length))
    for h in range(1, 16):
        wav += (h * f0 < sr / 2) * np.sin(h * phase) / h
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 6, (batch, 1)) * t)
    wav = wav * env + 0.02 * rng.standard_normal((batch, length))
    wav *= rng.uniform(0.2, 0.6, (batch, 1)) / np.abs(wav).max(1,
                                                               keepdims=True)
    return wav[:, None, :].astype(np.float32)


def train_setup(device, batch, seed):
    """The flagship trainer on `device` and a seeded state whose codebooks
    are k-means-initialized on a seeded batch (not one later stepped on)."""
    import torch
    from hilcodec_tpu_torch.train.loop import build_trainer
    from hilcodec_tpu_torch.train.step import to_device
    from hilcodec_tpu_torch.utils.hparams import load_config

    hps = load_config(CONFIG)
    trainer = build_trainer(hps, device)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    wav = speech_batch(np.random.default_rng(seed), batch, TRAIN_SEGMENT)
    vq = trainer.model.vq
    with torch.no_grad():
        z = trainer.model.codec.encoder.apply(state.params_g["encoder"],
                                              to_device(wav, trainer.device))
    init_idx = vq.kmeans_init_indices(torch.Generator().manual_seed(seed + 7),
                                      z.shape[0] * z.shape[-1])
    state = state._replace(vq_state=vq.kmeans_init_state(
        state.vq_state, z, init_idx))
    return hps, trainer, state


def train_bound(trainer, state, wav_t, draws):
    """The step's FLOPs as torch.utils.flop_counter counts them from the
    conv and matmul shapes (forward and backward; FFTs and elementwise
    work not counted), and its f32 bound at PEAK_F32_FLOPS in ms."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        trainer.train_step(state, wav_t, draws)
    flops = fc.get_total_flops()
    by_op = {}
    for op, n in fc.get_flop_counts().get("Global", {}).items():
        name = str(op).split(".")[1] if "." in str(op) else str(op)
        by_op[name] = by_op.get(name, 0) + n
    return flops, flops / PEAK_F32_FLOPS * 1e3, by_op


def phase_train_full(card):
    """(a) The flagship trainer at batch 24 x 24000 on the card: k-means
    init, warm-up steps, timed steps (CUDA events per step), throughput,
    peak memory, a torch.profiler window and the FLOP bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hilcodec_tpu_torch.ops import rvq_kernel
    from hilcodec_tpu_torch.train.loop import step_generator
    from hilcodec_tpu_torch.train.step import metrics_to_host, to_device
    from hilcodec_tpu_torch.utils.params import flatten

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, trainer, state = train_setup("cuda", TRAIN_BATCH, SEED + 20)
    torch.cuda.synchronize()
    log(f"[train] flagship trainer (configs/hilcodec_speech.yaml) on the "
        f"card, batch {TRAIN_BATCH} x {TRAIN_SEGMENT} samples; built and "
        f"k-means-initialized in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 21)
    batches = [to_device(speech_batch(rng, TRAIN_BATCH, TRAIN_SEGMENT),
                         trainer.device)
               for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    first_g = {k: v.clone() for k, v in flatten(state.params_g).items()}
    first_d = {k: v.clone() for k, v in flatten(state.params_d).items()}
    it = 0

    def step(wav_t):
        nonlocal state, it
        draws = trainer.sample_draws(step_generator(SEED, it), wav_t.shape)
        state, m = trainer.train_step(state, wav_t, draws)
        it += 1
        return m, draws

    t0 = time.perf_counter()
    for b in batches[:TRAIN_WARMUP]:
        step(b)
    torch.cuda.synchronize()
    log(f"[train] {TRAIN_WARMUP} warm-up steps in "
        f"{time.perf_counter() - t0:.2f} s")

    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_TIMED + 1)]
    metrics, depths = [], []
    rvq_kernel.reset_launches()
    t0 = time.perf_counter()
    events[0].record()
    for i, b in enumerate(batches[TRAIN_WARMUP:]):
        m, draws = step(b)
        metrics.append(m)
        depths.append(draws.n)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_TIMED)]
    p50, p90 = np.percentile(step_ms, 50), np.percentile(step_ms, 90)
    audio_s = TRAIN_TIMED * TRAIN_BATCH * TRAIN_SEGMENT / 24000.0
    peak = torch.cuda.max_memory_allocated()
    host = [metrics_to_host(m) for m in metrics]
    log(f"[train] {TRAIN_TIMED} timed steps: step ms p50 {p50:.1f}, p90 "
        f"{p90:.1f} (CUDA events; all "
        f"{', '.join(f'{x:.1f}' for x in step_ms)}); wall {wall:.3f} s, "
        f"{audio_s / wall:.1f} audio s trained per wall s; peak memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
        f"dropout depths {depths}; rvq_cascade launches {launches} ({card})")
    for k in ("loss/freq", "loss/mfbd_g", "loss/mfbd_fm", "loss/mstftd_g",
              "loss/mstftd_fm", "loss/vq", "loss/d"):
        log(f"[train]   {k}: " + ", ".join(f"{h[k]:.4g}" for h in host))
    bad = [(i, k) for i, h in enumerate(host) for k, v in h.items()
           if k != "num_replaces" and not np.all(np.isfinite(v))]
    if bad or any(h["finite"] != 1.0 for h in host):
        raise AssertionError(f"non-finite training metrics: {bad}")
    if launches != TRAIN_TIMED:
        raise AssertionError(f"rvq_cascade launched {launches} times in "
                             f"{TRAIN_TIMED} steps")
    last_g, last_d = flatten(state.params_g), flatten(state.params_d)
    still_g = [k for k, v in first_g.items() if torch.equal(v, last_g[k])]
    still_d = [k for k, v in first_d.items() if torch.equal(v, last_d[k])]
    log(f"[train] params moved: {len(first_g) - len(still_g)} / "
        f"{len(first_g)} generator leaves, {len(first_d) - len(still_d)} / "
        f"{len(first_d)} discriminator leaves (unmoved: "
        f"{(still_g + still_d)[:12]})")
    if len(still_g) > len(first_g) // 2 or len(still_d) > len(first_d) // 2:
        raise AssertionError("the parameters did not move")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[:TRAIN_PROFILED]:
            step(b)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in dev) / TRAIN_PROFILED / 1e3
    n_kernels = sum(e.count for e in dev) / TRAIN_PROFILED
    log(f"[train] torch.profiler over {TRAIN_PROFILED} steps: {dev_ms:.1f} "
        f"ms of device kernels and {n_kernels:.0f} kernels a step; device "
        f"busy {dev_ms / p50 * 100:.0f}% of the p50 step")
    for e in sorted(dev, key=lambda e: -e.device_time_total)[:10]:
        log(f"[train]   {e.device_time_total / TRAIN_PROFILED / 1e3:.2f} ms "
            f"x{e.count / TRAIN_PROFILED:.0f}/step  {e.key[:90]}")

    wav_t = batches[0]
    draws = trainer.sample_draws(step_generator(SEED, 0), wav_t.shape)
    flops, bound_ms, by_op = train_bound(trainer, state, wav_t, draws)
    log(f"[train] step FLOPs (conv + matmul shapes, forward and backward, "
        f"dropout depth {draws.n}): {flops / 1e12:.2f} TFLOP ("
        + ", ".join(f"{k} {v / 1e12:.2f}" for k, v in sorted(
            by_op.items(), key=lambda kv: -kv[1]))
        + f"); f32 bound {bound_ms:.1f} ms at "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, "
        f"{bound_ms / p50 * 100:.1f}% of the p50 step")
    return trainer, state, dict(p50=p50, p90=p90, launches=launches,
                                bound_ms=bound_ms)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _rel_l2(a, b, floor=1e-30):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / max(float(b.norm()), floor))


def phase_train_parity():
    """(b) One step of the port on the card against the same step of the
    port on the CPU: full width, batch 2, the same state (codebooks
    k-means-initialized on the CPU on another batch), batch and draws."""
    import torch
    from hilcodec_tpu_torch.train.loop import build_trainer, step_generator
    from hilcodec_tpu_torch.train.step import to_device
    from hilcodec_tpu_torch.utils.params import flatten, tree_map, unflatten

    t0 = time.perf_counter()
    hps, cpu_tr, cpu_state = train_setup("cpu", PARITY_BATCH, SEED + 30)
    # zero-init scales set to seeded nonzero values, as the CPU tests do,
    # so every residual and spec branch carries gradient
    gen = torch.Generator().manual_seed(SEED + 32)
    flat = flatten(cpu_state.params_g)
    for k, v in flat.items():
        if k.endswith("scale_param"):
            flat[k] = torch.rand(v.shape, generator=gen) + 0.5
    cpu_state = cpu_state._replace(params_g=unflatten(flat))
    wav = speech_batch(np.random.default_rng(SEED + 31), PARITY_BATCH,
                       TRAIN_SEGMENT)
    card_tr = build_trainer(hps, "cuda")
    card_state = tree_map(lambda x: x.to("cuda"), cpu_state)
    draws = cpu_tr.sample_draws(step_generator(SEED, 0), wav.shape)
    card_draws = dataclasses.replace(draws,
                                     expire_idx=draws.expire_idx.cuda())
    aux_c = cpu_tr.compute_grads(cpu_state, torch.from_numpy(wav), draws)
    new_c, _ = cpu_tr.apply_grads(cpu_state, aux_c)
    wav_g = to_device(wav, card_tr.device)
    aux_g = card_tr.compute_grads(card_state, wav_g, card_draws)
    new_g, _ = card_tr.apply_grads(card_state, aux_g)
    again = card_tr.compute_grads(card_state, wav_g, card_draws)
    torch.cuda.synchronize()
    log(f"[train-parity] one step at batch {PARITY_BATCH} x "
        f"{TRAIN_SEGMENT} samples, dropout depth "
        f"{draws.n}, on the card and on the CPU (in "
        f"{time.perf_counter() - t0:.1f} s with set-up)")

    worst = {}
    for k, v in aux_c["losses"].items():
        worst[f"loss/{k}"] = _rel(aux_g["losses"][k], v)
    for k in ("loss_vq", "d_loss"):
        worst[k] = _rel(aux_g[k], aux_c[k])
    for k in ("ema_norms", "ema_fix"):
        worst[f"balancer/{k}"] = float(
            ((aux_g["new_bal"][k].cpu() - aux_c["new_bal"][k]).abs()
             / aux_c["new_bal"][k].abs()).max())
    for k in ("embed", "ema_embed", "ema_num"):
        worst[f"vq/{k}"] = _rel_l2(aux_g["new_vq_state"][k],
                                   aux_c["new_vq_state"][k])
    log("[train-parity] losses, balancer EMA (max relative error) and VQ "
        "state (relative L2); bars 1e-4: " + ", ".join(
            f"{k} {v:.2g}" for k, v in worst.items()))
    replaces = (aux_g["num_replaces"].cpu().tolist(),
                aux_c["num_replaces"].tolist())
    log(f"[train-parity] codes replaced by stage, card / CPU: {replaces}")
    for k, rel in worst.items():
        bar = VQ_RTOL if k.startswith("vq/") else LOSS_RTOL
        if not rel <= bar:
            raise AssertionError(f"card vs CPU: {k} off by {rel:.3g} "
                                 f"(bar {bar})")
    if replaces[0] != replaces[1]:
        raise AssertionError(f"card vs CPU replace counts {replaces}")

    flips = []
    for side in ("g", "d"):
        opt = getattr(cpu_tr, f"optim_{side}")
        g_c, g_g = aux_c[f"{side}_grads"], aux_g[f"{side}_grads"]
        fc = flatten(g_c)
        fg = {k: v.cpu() for k, v in flatten(g_g).items()}
        floor = GRAD_FLOOR_REL * float(torch.sqrt(sum(
            torch.sum(v.double() ** 2) for v in fc.values())))
        errs = sorted(((_rel_l2(fg[k], fc[k], floor), k) for k in fc),
                      reverse=True)
        params = getattr(cpu_state, f"params_{side}")
        gate_c = opt.gate_report(g_c, params)
        gate_g = opt.gate_report(unflatten(fg), params)
        skip = set()
        for path, (ch, ch_t, ly, ly_t) in gate_c.items():
            h = gate_g[path]
            if (ch < ch_t, ly < ly_t) == (h[0] < h[1], h[2] < h[3]):
                continue
            near = all(abs(x - t) <= GATE_MARGIN * t
                       for x, t in ((ch, ch_t), (h[0], h[1])))
            near = near or all(abs(x - t) <= GATE_MARGIN * t
                               for x, t in ((ly, ly_t), (h[2], h[3])))
            if not near:
                raise AssertionError(f"AdamP gate differs at {path} away "
                                     f"from its threshold")
            flips.append(path)
            skip.add(path.replace("/", "."))
        # the card's AdamP on the CPU's gradients against the CPU's update
        opt_g = getattr(card_tr, f"optim_{side}")
        upd_c, _ = opt.update(g_c, getattr(cpu_state, f"opt_{side}"),
                              params, torch.full((), 1e-4))
        upd_g, _ = opt_g.update(
            tree_map(lambda x: x.cuda(), g_c),
            tree_map(lambda x: x.cuda(), getattr(cpu_state, f"opt_{side}")),
            tree_map(lambda x: x.cuda(), params),
            torch.full((), 1e-4, device="cuda"))
        fu_c, fu_g = flatten(upd_c), flatten(upd_g)
        uerrs = sorted(((_rel_l2(fu_g[k], fu_c[k]), k) for k in fu_c
                        if k not in skip), reverse=True)
        # the whole step: deltas where both gradients give one sign
        p0 = flatten(params)
        p_c = flatten(getattr(new_c, f"params_{side}"))
        p_g = flatten(getattr(new_g, f"params_{side}"))
        derrs, ties, worst_tie = [], 0, (0.0, "")
        for k in p0:
            if k in skip:
                continue
            keep = (fg[k] - fc[k]).abs() < fc[k].abs()
            ties += int((~keep).sum())
            worst_tie = max(worst_tie, (1.0 - float(keep.float().mean()), k))
            derrs.append((_rel_l2((p_g[k].cpu() - p0[k])[keep],
                                  (p_c[k] - p0[k])[keep]), k))
        derrs.sort(reverse=True)
        log(f"[train-parity] {side.upper()}: {len(fc)} leaves, worst grad "
            f"rel L2 {errs[0][0]:.2g} ({errs[0][1]}; floor "
            f"{GRAD_FLOOR_REL} of the global norm), worst AdamP update from "
            f"the same gradients rel L2 {uerrs[0][0]:.2g} ({uerrs[0][1]}); "
            f"bars {GRAD_RTOL}. The whole step's AdamP deltas: worst rel L2 "
            f"{derrs[0][0]:.2g} ({derrs[0][1]}) over the elements whose "
            f"gradient sign both sides give; sign ties {ties} elements, at "
            f"most {worst_tie[0]:.2%} of a leaf ({worst_tie[1]}); reported")
        if errs[0][0] > GRAD_RTOL or uerrs[0][0] > GRAD_RTOL:
            raise AssertionError(f"card vs CPU {side}: grads {errs[:3]}, "
                                 f"AdamP updates {uerrs[:3]}")
    log(f"[train-parity] AdamP gate flips within {GATE_MARGIN} of the "
        f"threshold (reported, not failures): {flips or 'none'}")
    rerun = max(_rel_l2(a, b) for a, b in zip(
        flatten(again["g_grads"]).values(),
        flatten(aux_g["g_grads"]).values()))
    log(f"[train-parity] the same step twice on the card: G grads differ "
        f"by rel L2 up to {rerun:.2g} (cuDNN's backward-weight kernels "
        f"need not be bitwise repeatable; reported, not asserted)")


def phase_train_tokens(trainer, state):
    """(c) The training forward's stage indices (the RVQ kernel) against
    the plain cascade at M = 1800 rows, n = 2, 4, 8."""
    import torch
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel

    wav = speech_batch(np.random.default_rng(SEED + 40), TRAIN_BATCH,
                       TRAIN_SEGMENT)
    books = state.vq_state["embed"]
    with torch.no_grad():
        z = trainer.model.codec.encoder.apply(
            state.params_g["encoder"], torch.from_numpy(wav).cuda())
        x = z.transpose(1, 2).contiguous()
        M = x.shape[0] * x.shape[1]
        for n in (2, 4, 8):
            got = rvq_kernel.quantize_cuda(x, books, n)
            ref = rvq.quantize(x, books, n)
            rep = rvq.token_parity_report(got, ref, x, books)
            plan, _ = rvq_kernel.device_plan(x.device, M, books.shape[1],
                                             books.shape[2], n)
            ms = graph_ms(lambda: rvq_kernel.quantize_cuda(x, books, n))
            bound_ms, bound_by = rvq_bound_ms(M, n, books.shape[1],
                                              books.shape[2])
            log(f"[train-tokens] M={M} n={n} (trained codebooks): "
                f"mismatches {rep['mismatches']} (ties {rep['ties']}, not "
                f"ties {rep['not_ties']}); plan G={plan.cluster} "
                f"TM={plan.rows}, {plan.tiles} clusters; kernel "
                f"{ms * 1e3:.2f} us (CUDA graph), bound {bound_ms * 1e3:.2f}"
                f" us ({bound_by})")
            if not rep["ok"]:
                raise AssertionError(f"training tokens differ beyond ties "
                                     f"at n={n}: {rep}")


def phase_train_cli(tmp):
    """(d) `python -m hilcodec_tpu_torch.train` on a seeded corpus written
    with the port's write_wav: one epoch writes 00001.ckpt.npz, a second
    run resumes from it and writes 00002.ckpt.npz."""
    import yaml
    from hilcodec_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(SEED + 50)
    os.makedirs(os.path.join(tmp, "train"))
    for i in range(6):
        write_wav(os.path.join(tmp, "train", f"{i}.wav"),
                  speech_batch(rng, 1, 36000)[0, 0], 24000)
    for i in range(2):
        write_wav(os.path.join(tmp, f"v{i}.wav"),
                  speech_batch(rng, 1, 24000)[0, 0], 24000)
    with open(os.path.join(tmp, "valid.txt"), "w") as f:
        f.write("v0.wav\nv1.wav\n")
    with open(os.path.join(ROOT, "configs",
                           "hilcodec_speech_synth.yaml")) as f:
        cfg = yaml.safe_load(f)
    data = cfg["data"]
    data["classes"]["clean"]["directories_to_include"] = [
        os.path.join(tmp, "train")]
    data["length"] = CLI_STEPS * CLI_BATCH
    data["wav_dir"] = tmp
    data["filelists"] = {"valid": os.path.join(tmp, "valid.txt")}
    cfg["train"].update(batch_size=CLI_BATCH, max_epochs=1, save_interval=1,
                        num_workers=0)
    cfg["valid"] = {"batch_size": 2}
    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    base = os.path.join(tmp, "logs")
    env = dict(os.environ, PYTHONPATH=ROOT)
    for i, extra in enumerate((["-c", path], ["-p", "train.max_epochs=2"])):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "hilcodec_tpu_torch.train", "-n", "smoke",
             "-b", base] + extra, cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        for ln in (out.stdout + out.stderr).strip().splitlines()[-6:]:
            log(f"[train-cli]   {ln[:160]}")
        ckpt = os.path.join(base, "smoke", f"{i + 1:05d}.ckpt.npz")
        if out.returncode != 0 or not os.path.exists(ckpt):
            raise AssertionError(f"train CLI run {i + 1} failed "
                                 f"(rc {out.returncode}) or wrote no {ckpt}")
        if i == 1 and "resumed from" not in out.stdout:
            raise AssertionError("the second CLI run did not resume")
        log(f"[train-cli] run {i + 1} ({' '.join(extra)}): rc 0 in "
            f"{time.perf_counter() - t0:.1f} s, wrote "
            f"{os.path.relpath(ckpt, tmp)}")


def phase_train(card):
    """The train phase, (a) to (d); returns (a)'s step times and K1's
    launches on the timed steps."""
    import tempfile
    trainer, state, res = phase_train_full(card)
    phase_train_tokens(trainer, state)
    del trainer, state
    phase_train_parity()
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_cli(tmp)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import hilcodec_tpu_torch  # noqa: F401  (fails outside a checkout)
    from hilcodec_tpu_torch.ops import rvq_kernel

    from hilcodec_tpu_torch.ops import decoder_kernel, encoder_kernel

    name, line = phase_device()
    max_err, timings = phase_kernels(torch.device("cuda", 0))
    model, params, vq_state, sr = build_flagship("cuda")
    frame_err, frame_timings = phase_frame_kernels(model, params)
    for ch in ODD_CHANNELS:
        phase_frame_kernels(*build_small(ch), batches=(3,),
                            tag=f" (channels {ch})")
    launches = phase_serve(model, params, vq_state, sr)
    phase_timings(model, params, vq_state, line)
    frame_launches = phase_frame_path(model, params, vq_state)
    phase_bench()
    del model, params, vq_state
    train = phase_train(line)

    # the serving path launches the RVQ kernel at M = SERVE_SLOTS rows and
    # 8 stages (its time here: device time through a CUDA graph); the
    # frame-kernel path runs the frame kernels, and the RVQ kernel at 128
    # rows, at 128 streams
    ms, plain_ms, bound_ms, bound_by = timings[(SERVE_SLOTS, 8)]
    kernels = [{
        "name": rvq_kernel.KERNEL, "route": "cuda",
        "source": rvq_kernel.SOURCE,
        "replaces": "hilcodec_tpu/ops/pallas_rvq.py:148",
        "launches": launches,
        "launches_frame_path": frame_launches[rvq_kernel.KERNEL],
        "launches_train_path": train["launches"],
        "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]
    for mod, replaces in ((decoder_kernel,
                           "hilcodec_tpu/ops/pallas_decoder.py:490"),
                          (encoder_kernel,
                           "hilcodec_tpu/ops/pallas_encoder.py:234")):
        # the bound of the engine the kernel runs its GEMMs on (tensor
        # cores), and beside it the bound with every operation on the f32
        # CUDA cores, the one PR 2's kernel was held to
        ms, plain_ms, bounds = frame_timings[(mod.KERNEL, PATH_STREAMS)]
        kernels.append({
            "name": mod.KERNEL, "route": "cuda", "source": mod.SOURCE,
            "replaces": replaces, "launches": frame_launches[mod.KERNEL],
            "max_abs_err": frame_err[mod.KERNEL], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bounds["tc"][0],
            "bound_by": bounds["tc"][1], "bound_f32_ms": bounds["f32"][0],
            "bound_f32_by": bounds["f32"][1], "library_ms": None})
    print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
