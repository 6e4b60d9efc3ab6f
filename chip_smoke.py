#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`hilcodec_tpu_torch`) on one card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA card and `nvcc` (CUDA_HOME or /usr/local/cuda), and exits non-zero
without a result line when CUDA is unavailable or a phase fails. Phases:

  1. device: card name and power limit, TF32 off, build every kernel of
     the path from the checkout's sources (csrc/rvq.cu and
     csrc/segment.cu, one nvcc per source, started together, and the host
     range coder csrc/rangecoder.cpp with g++ beside them); ptxas's
     register and spill report, failing on any spill in either;
  2. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes the serving path gives it and more, then timed with
     CUDA events beside its plain version and its bound: the RVQ cascade
     (its plans, clusters of 16 CTAs at few rows and of 8 at many; M up
     to 1000; ragged K and K below the cluster size at C = 64; duplicate
     codewords in two CTAs' slices, first index kept; two more launches
     bitwise equal; timed at n = 1, 2, 4, 8 for the per-stage cost and at
     n_q = 32, K2's shape, at M = 16, 128 and 1800; Avocodo's 12-stage
     stack at every depth 1-12 and M = 16, 128, 900 and 1800, timed at
     n = 12 at each),
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
  6. bench: `python -m hilcodec_tpu_torch.bench 64 --seconds 1` run
     in-process, plain and --megakernel, one turn each, each JSON line
     logged (16 and 128 streams run in phase 15's turns);
  7. training: (a) the flagship GAN trainer (build_trainer on
     configs/hilcodec_speech.yaml, seeded weights, codebooks k-means-
     initialized on a seeded batch) at batch 24 x 24000 samples of seeded
     speech-like audio: 1 warm-up and 5 timed steps, step ms p50 / p90
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
     00001.ckpt.npz), then resumed for a second with the histograms, the
     infer epoch and SI-SDR at interval 1;
  8. tools, on 7(d)'s 00002.ckpt.npz in the same directory: `python -m
     hilcodec_tpu_torch.export --ckpt`; `serve --ckpt` in a subprocess and
     an engine on the exported deploy npz, one 75-frame TCP client each,
     identical tokens; `infer --ckpt --latency` at -f 1 and -f 4 on 3 s of
     seeded speech (int16 [8, 1, T]; -f 4 tokens exact or ties against
     -f 1, PCM within PCM_TOL_LSB; RTFs and per-step p50 / p90 / p99);
     `eval` in model mode (--stream, 4 seeded wavs, sisdr, stoi, mcd and
     the numpy PESQ) and in degraded mode on the infer output; the RVQ
     kernel's launches over these; the frame kernels at 4 frames a launch
     (encode_stream / decode_stream(megakernel=True, frames_per_step=4))
     at 16 and 128 streams against the plain drivers, one launch per 4
     frames, each timed at t = 4; 7(d)'s summaries (its event files, or
     its one-line notice of what it cannot write); `clean_checkpoint
     --dry-run` lists only 00001.ckpt.npz;
  9. EnCodec (configs/encodec_24khz.yaml at full width, seeded weights,
     N(0, 1) codebooks, folded; the RVQ kernel at n_q = 32, K2's shape):
     the LSTM through cuDNN against a float64 CPU run in the f32 parity
     mode (and, reported, with TF32 allowed); a 16-slot roundtrip engine
     behind TCP with 8 clients x 75 frames, each against its solo stream
     with the plain quantizer, one RVQ launch a tick; `python -m
     hilcodec_tpu_torch.serve -c configs/encodec_24khz.yaml` in a
     subprocess against an engine on the same seeded weights (one client,
     the same tokens); ticks at 16 and 128
     slots with the profiler; the bench with --model encodec (8
     quantizers, K1's shape) at 16 and 128 streams; the trainer at batch
     24 x 24000 (1 warm-up and 5 timed steps, as 7(a)); the RVQ kernel's
     training tokens at M = 1800, n = 32; one step on the card against
     the CPU step at batch 2 (as 7(b));
 10. Avocodo (configs/avocodo_music.yaml at full width: encoder 64 /
     decoder 96, RVQ 12 x 1024 x 128, CoMBD + SBD; seeded weights, N(0, 1)
     codebooks, folded): a 16-slot engine behind TCP (8 clients x 75
     frames against their solo streams, one RVQ launch a tick); its serve
     CLI against an engine on the same weights; ticks at 16 and 128 slots
     with the profiler; the bench with --model avocodo at 16 and 128
     streams; the Avocodo trainer at batch 12 x 24000 (as 7(a)); the RVQ
     kernel's training tokens at M = 900 for n = 2, 4, 8, 12; one step on
     the card against the CPU step at batch 2 (as 7(b));
     configs/avocodo_synth_hiltrainer.yaml for 3 steps at batch 24; the
     train CLI for one epoch of configs/avocodo_synth.yaml (beside the
     parity step and the ablation), then export, infer -f 1 and eval in
     model mode on its checkpoint;
 11. the quantizer routing on configs/hilcodec_shapegain_synth.yaml
     (32 / 48 channels): shape-gain training at batch 24 (1 warm-up, 5
     timed steps; the shape / gain state moved, codes replaced, no RVQ
     launch); `vq: ''` for 2 steps; one shape-gain step on the card
     against the CPU step at batch 2, with its argmax flips;
 12. AudioDec at its defaults (encoder 32 -> 512 channels, decoder 512
     channels with grouped k = 11 blocks, hop 300 = a 12.5 ms frame, RVQ
     8 x 1024 x 64; seeded weights, N(0, 1) codebooks, folded; a
     temporary yaml, as no config selects it): the RVQ kernel at C = 64
     against the plain cascade at M = 1, 16, 128 and timed; a 16-slot
     engine behind TCP (8 clients x 75 frames against their solo
     streams); its serve CLI; ticks at 16 and 128 slots with the
     profiler; the bench with --model audiodec at 16 and 128 streams;
     export and infer -f 1 --latency on 3 s of seeded speech;
 13. entropy-coded token streams: the range coder's native and Python
     paths bit-identical on seeded cdfs; the flagship's seeded codec state
     (k-means codebooks) as a checkpoint; `python -m
     hilcodec_tpu_torch.train_lm` for 60 steps at the default LM (dim 200,
     8 heads, 5 layers, segments of 150 frames) on its tokens of a seeded
     speech corpus, the held-out loss falling; `entropy_code` encode ->
     .hilstream -> decode, tokens exact; `infer --entropy-stream` live on
     3 s of seeded speech (roundtrip exact, kbps, coder latency p50 / p99
     against the 13.33 ms frame, the decoder's lag); the live stepper's
     probabilities against the batched LM's; and, reported only, the
     card's live stream decoded on the CPU;
 14. the rest of the single-card training options on the flagship
     trainer (temporary yamls derived from configs/hilcodec_speech.yaml):
     (a) MPD (periods 2-11) and MSD (three scales, spectral / weight /
     weight norm) with MelGradLoss, each family's losses weighted 1.1:
     one step on the card against the CPU at batch 2 with
     configs/avocodo_music.yaml's SBD added, its gradients applied by
     AdamP, SGDP and RAdam on both devices (7(b)'s bars, the spectral-norm
     u buffers to 1e-4), then the step timed at batch 24 as 7(a); (b)
     compute_dtype bfloat16, remat all, and both, each timed at batch 24
     as 7(a) beside 7(a)'s f32 numbers (the RVQ kernel twice a step under
     remat), masters / optimizer / VQ state f32 and finite, the bf16
     path's tokens against the plain cascade at M = 1800, bf16 losses
     within 0.1 of f32's and remat's gradients within 2e-3 of none's from
     one state and batch;
 15. the serving path's precision and model options: the decoder and
     encoder frame kernels at --dtype bf16w (bf16 weights, widened when
     packed) and bf16 (bf16 input, aux inputs and caches, rounded where
     stored) against their plain version of the same dtype at 1, 16 and
     128 streams (within one bf16 spacing), timed at 16 and 128 with a
     bound from the stored bytes and bf16 weights, and encode_stream /
     decode_stream(megakernel=True) at 16 streams x 75 frames against the
     plain frame step of the same dtype (one launch a frame each; latents,
     tokens, PCM); `export --program`'s
     torch.export programs at 16 streams, saved, loaded and stepped 75
     frames (tokens equal to the eager step's, the RVQ kernel launched by
     the program once a frame); the bench at --dtype f32 / bf16w / bf16
     (flagship plain and --megakernel; AudioDec plain) at 16 and 128
     streams, 0.5 s; engine ticks at 16 and 128 slots at bfloat16 beside
     float32 (flagship, AudioDec), profiled at 128; the flagship with
     weight standardization, the learnable
     STFT and channelwise skips at full width (temporary yaml): 16 slots x
     75 ticks, tokens exact or ties against the CPU, two finite train
     steps, and the frame kernels on the weight-standardized flagship;
     EnCodec with pad_mode edge and wrap, offline, against the CPU;
 16. data parallelism, slot sharding and the host I/O: (c) a seeded corpus
     of 24 WAVs, dumped for DatasetPreprocessed with extract_pitch; the
     native read_batch of 24 x 24000-sample segments against the stdlib
     reader (equal arrays, ms p50 over 20 batches), the loader's batches
     a second with DirectoriesDataset and DatasetPreprocessed, pitch ms
     per audio second, files read by each reader (host numbers); (a) the
     flagship trainer at batch 24 in an NCCL group of one rank: one step
     from phase 7's initial state, batch and draws, bitwise equal to the
     step without a group under deterministic cuDNN, then 5 timed steps
     of each in turns, beside phase 7's p50 (K1 once a step); `python -m
     torch.distributed.run --nproc_per_node 1 -m hilcodec_tpu_torch.train`
     on the DatasetPreprocessed corpus for an epoch, then its checkpoint
     resumed for a second by a TrainLoop in this process's group; (b)
     SlotEngine(devices=['cuda:0', 'cuda:0']), two shards on the one card,
     against devices=None at 16 and 128 slots x 75 ticks, for the flagship
     and for EnCodec (its LSTM state split on axis 1): tokens equal or f32
     ties, PCM within PCM_TOL_LSB; the flagship's tick p50 / p99 in turns;
     `serve --mesh` with 8 TCP clients against an engine on the same cards
     in this process; the bench at 128 streams, plain and --megakernel,
     unsharded and --mesh over the same two shards (the launches of every
     kernel).

The line before the last is {"kernels": [...]}, one entry per kernel of
the path; the last line is {"ok": true, "device": {...}}.
"""

import asyncio
import contextlib
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
ENCODEC_CONFIG = os.path.join(ROOT, "configs", "encodec_24khz.yaml")
ENCODEC_BENCH_STREAMS = (16, 128)
AVOCODO_CONFIG = os.path.join(ROOT, "configs", "avocodo_music.yaml")
AVOCODO_HILTRAINER = os.path.join(ROOT, "configs",
                                  "avocodo_synth_hiltrainer.yaml")
SHAPEGAIN_CONFIG = os.path.join(ROOT, "configs",
                                "hilcodec_shapegain_synth.yaml")
# the RVQ kernel on Avocodo's 12-stage stack: serving at 16 and 128 slots,
# training at its batch (12 x 75 = 900 rows) and the `trainer: hilcodec`
# ablation's (24 x 75 = 1800)
RVQ12_ROWS = (16, 128, 900, 1800)
# the EnCodec LSTM (width 512, 2 layers) on cuDNN against a float64 CPU
# run of the same cell over 75 steps: f32 reads ~3e-7 on an H100, TF32
# (10 mantissa bits) ~7e-5, which phase_lstm requires to fail this bar
LSTM_TOL = 2e-5
SEED = 0
N_CLIENTS = 8
CLIENT_FRAMES = 75            # 1 s at 24 kHz / hop 320
SERVE_SLOTS = 16
TIMED_TICKS = 100
PATH_STREAMS = 128            # the frame-kernel path and the bench
# 3 and 64 cross the lowering's tile and split choices and leave ragged
# tiles
FRAME_BATCHES = (1, 3, 7, 16, 64, 128)
# phase 6's stream counts: 16 and 128 run in phase 15's turns, at every
# --dtype, plain and with the frame kernels
BENCH_STREAMS = (64,)
# small models whose channel counts are not multiples of 4
ODD_CHANNELS = (6, 10)
# frame kernels vs their plain version: the largest |difference| of a
# tensor (output or cache) over its largest |value| (at least 1). The
# kernel sums up to 1536 products per 1x1 conv in another order than
# cuBLAS and ATen, through ~30 chained layers; 5e-5 is ~400 f32 ulps of
# the tensor's scale.
FRAME_TOL = 5e-5
# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, TF32
# and bf16 on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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
    with ThreadPoolExecutor(len(sources) + 1) as ex:
        # the range coder (host C++, g++) alongside the kernels
        coder = ex.submit(cuda_build.build_host, "rangecoder")
        built = list(ex.map(cuda_build.build, sources))
        coder_path, coder_secs, _ = coder.result()
    log(f"[device] built csrc/rangecoder.cpp with {cuda_build.gxx()} in "
        f"{coder_secs:.2f} s -> {os.path.relpath(coder_path, ROOT)}")
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
    books12 = torch.randn((12, 1024, 128), generator=gen).to(dev)
    # ragged K, and K < G (CTAs with empty slices), at C = 64
    books_k1000 = torch.randn((3, 1000, 64), generator=gen).to(dev)
    books_k16 = torch.randn((3, 16, 64), generator=gen).to(dev)
    # codewords 100 and 900 of stage 0 equal, in different CTAs' slices
    dup = torch.randn((2, 1024, 128), generator=gen)
    dup[0, 900] = dup[0, 100]
    dup = dup.to(dev)
    cases = [(books8, M, n) for M in (1, 7, 16, 128, 1000) for n in (8, 3)]
    # the flagship's tokenizer in phase 13: entropy_code's 4 s input (2
    # segments of 150 frames) and train_lm's batches of 32 segments
    cases += [(books8, M, 8) for M in (300, 4800)]
    # K2's shape on the EnCodec paths: serving at 16 and 128 slots,
    # training at 24 x 75 = 1800 rows
    cases += [(books32, M, 32) for M in (7, SERVE_SLOTS, 128, 1800)]
    # ... and the training path's dropout depths below 32 (rings 1-4)
    cases += [(books32, M, n) for M in (SERVE_SLOTS, 1800)
              for n in (1, 2, 3, 13)]
    # Avocodo's 12-stage stack at every depth 1-12 (its dropout draws 2,
    # 4, 8, 12; serving and the bench run 12 and 8) and its rows
    cases += [(books12, M, n) for M in RVQ12_ROWS for n in range(1, 13)]
    cases += [(b, M, 3) for b in (books_k1000, books_k16)
              for M in (7, 128, 1000)]
    cases += [(dup, M, 2) for M in (16, 64)]

    for M, n in ((SERVE_SLOTS, 8), (128, 8), (1000, 8), (SERVE_SLOTS, 32),
                 (128, 32), (1800, 32)) + tuple((M, 12) for M in RVQ12_ROWS):
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
    for books, n, rows in ((books8, 8, (SERVE_SLOTS, 128)),
                           (books32, 32, (SERVE_SLOTS, 128, 1800)),
                           (books12, 12, RVQ12_ROWS)):
        for M in rows:
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


def frame_bound_ms(mk, w, x, aux, caches, bf16_weights=False):
    """Least time for one frame step of `mk` on these inputs, on two
    engines: the larger of its operations over the peak and its bytes
    (input, aux, weights and caches read once, each at its element size,
    the weights at 2 bytes each when their tree stores them in bf16
    (`bf16_weights`), else 4; output and caches written once) over the
    HBM rate. "f32": every f32 operation on the CUDA cores; "tc": the
    1x1-conv products on the tensor cores (the engine the kernel uses for
    them) at the least cost of an f32-accurate product, the rest on the
    CUDA cores: TF32_PRODUCTS TF32 products each for f32 weights; for
    bf16 weights, whose small part is 0, the cheaper of 2 TF32 products
    and 3 bf16 products (the f32 activation split into three bf16
    pieces). Returns ({"f32"|"tc": (ms, "operations"|"bytes")}, flops,
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
    nbytes = (x.numel() * x.element_size()
              + sum(a.numel() * a.element_size() for a in aux)
              + (2 if bf16_weights else 4)
              * sum(v.numel() for lay in w.per_op if lay
                    for v in lay.values())
              + 2 * sum(cc.numel() * cc.element_size() for cc in caches)
              + B * t_out * c_out * x.element_size())
    t_bytes = nbytes / PEAK_HBM_BYTES
    gemm_s = (min(2 / PEAK_TF32_FLOPS, 3 / PEAK_BF16_FLOPS) if bf16_weights
              else TF32_PRODUCTS / PEAK_TF32_FLOPS)
    bounds = {}
    for engine, t_ops in (
            ("f32", (gemm + flops) / PEAK_F32_FLOPS),
            ("tc", gemm * gemm_s + flops / PEAK_F32_FLOPS)):
        bounds[engine] = (max(t_ops, t_bytes) * 1e3,
                          "operations" if t_ops >= t_bytes else "bytes")
    return bounds, gemm + flops, gemm


def frame_cases(model, params, B, gen, dtype=None):
    """Per frame kernel: (name, its step object, params, inputs(cache,
    frame) -> (kernel inputs x, aux, the layer caches, the next wav ring),
    first cache, frame maker); frames and caches in `dtype` (f32 when
    None)."""
    import torch
    dtype = dtype or torch.float32
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
        # time-major [B, 1, 128]
        return rvq.dequantize(tok, books).to(dtype)

    def enc_frame():
        return (torch.randn((B, 1, model.hop_length), generator=gen)
                * 0.3).to(dev, dtype)

    def dec_inputs(cache, q):
        return q, [], cache, None

    def enc_inputs(cache, x):
        ring, window, aux = em.frame_inputs(cache[0], x)
        return window, aux, cache[1:], ring

    return [("decoder_frame", dm, params["decoder"], dec_inputs,
             dm.init_cache(B, dtype, dev), dec_frame),
            ("encoder_frame", em, params["encoder"], enc_inputs,
             em.init_cache(B, dtype, dev), enc_frame)]


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


def build_flagship(device, config=CONFIG):
    """The model of `config` (the flagship's by default), seeded folded
    params (zero-init scales set nonzero) and N(0, 1) codebooks."""
    import torch
    from hilcodec_tpu_torch.models.registry import build_codec_model
    from hilcodec_tpu_torch.utils import params as P
    from hilcodec_tpu_torch.utils.hparams import load_config

    hps = load_config(config)
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


def phase_serve(model, params, vq_state, sr, tag="serve"):
    import torch
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel
    from hilcodec_tpu_torch.serve import CodecServer, SlotEngine

    hop, n_q = model.hop_length, model.vq.num_quantizers
    engine = SlotEngine(model, params, vq_state, slots=SERVE_SLOTS,
                        mode="roundtrip", fold=False, devices=[model.device])
    log(f"[{tag}] {SERVE_SLOTS}-slot roundtrip engine warmup "
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
    log(f"[{tag}] {N_CLIENTS} TCP clients x {CLIENT_FRAMES} frames "
        f"answered in {wall:.2f} s over {ticks} ticks; rvq_cascade launches "
        f"{launches} (n = {n_q}, M = {SERVE_SLOTS})")
    if launches != ticks or ticks == 0:
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
    log(f"[{tag}] all {N_CLIENTS} clients match the solo plain-quantizer "
        f"stream: tokens (fp ties {n_ties}), PCM max |diff| {worst_lsb} "
        f"int16 steps (tolerance {PCM_TOL_LSB})")
    return launches


# --------------------------------------------------------------- phase 4

def phase_timings(model, params, vq_state, card, tag="timing"):
    from hilcodec_tpu_torch.serve import SlotEngine

    hop = model.hop_length
    frame_s = hop / 24000.0
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for slots in (16, 128):
        engine = SlotEngine(model, params, vq_state, slots=slots,
                            mode="roundtrip", fold=False,
                            devices=[model.device])
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
        log(f"[{tag}] {slots} slots: engine tick p50 {p50 * 1e3:.2f} ms, "
            f"p99 {p99 * 1e3:.2f} ms, aggregate real-time factor "
            f"{rtf:.1f}x over {TIMED_TICKS} ticks, against the "
            f"{frame_s * 1e3:.2f} ms frame ({card})")
        profile_ticks(engine, slots, p50, rng, tag=tag)
    return out


def profile_ticks(engine, slots, p50_s, rng, ticks=10, tag="timing"):
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
    log(f"[{tag}-profile] {slots} slots: {dev_ms:.2f} ms of device kernels "
        f"and {n_kernels:.0f} kernels per tick; device busy "
        f"{dev_ms / (p50_s * 1e3) * 100:.0f}% of the p50 tick")
    for e in sorted(dev, key=lambda e: -e.device_time_total)[:6]:
        log(f"[{tag}-profile]   {e.device_time_total / ticks / 1e3:.3f} ms "
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
    """The bench entry at 64 streams (phase 15 runs 16 and 128) and 1 s of
    audio, plain and with the frame kernels, one turn each, in this
    process."""
    from hilcodec_tpu_torch import bench
    for streams in BENCH_STREAMS:
        base = [str(streams), "--seconds", "1"]
        for extra in ([], ["--megakernel"]):
            log(f"[bench] python -m hilcodec_tpu_torch.bench "
                f"{' '.join(base + extra)}: "
                f"{json.dumps(bench.run(base + extra))}")


# --------------------------------------------------------------- phase 7

TRAIN_BATCH = 24              # the flagship config's batch
TRAIN_SEGMENT = 24000         # its segment (1 s at 24 kHz)
# warm-up steps of each training mode: 1 (3 before phase 16 was added), a
# cut of depth for the run's time; the timed steps' p50 absorbs a slow
# first one
TRAIN_WARMUP = 1
# timed steps of each training mode: 5 (10 before the serving options'
# phase 15), a cut of depth for the run's time
TRAIN_TIMED = 5
# steps in the profiled window: 1 (it was 2, and 3 before that), a cut
# of depth for the run's time: reading the trace of one step of
# 40,000-56,000 kernels takes ~25 s
TRAIN_PROFILED = 1
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
# spectral-norm u buffers after one power iteration, card against CPU
U_RTOL = 1e-4
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


def train_setup(device, batch, seed, config=CONFIG):
    """The trainer of `config` (the flagship's by default) on `device` and
    a seeded state whose codebooks (where the quantizer takes k-means) are
    k-means-initialized on a seeded batch (not one later stepped on)."""
    import torch
    from hilcodec_tpu_torch.train.loop import build_trainer
    from hilcodec_tpu_torch.train.step import to_device
    from hilcodec_tpu_torch.utils.hparams import load_config

    hps = load_config(config)
    trainer = build_trainer(hps, device)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    vq = trainer.model.vq
    if not vq.kmeans_init:          # shape-gain and `vq: ''` have none
        return hps, trainer, state
    wav = speech_batch(np.random.default_rng(seed), batch, TRAIN_SEGMENT)
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
    work not counted), in all and by op."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        trainer.train_step(state, wav_t, draws)
    flops = fc.get_total_flops()
    by_op = {}
    for op, n in fc.get_flop_counts().get("Global", {}).items():
        name = str(op).split(".")[1] if "." in str(op) else str(op)
        by_op[name] = by_op.get(name, 0) + n
    return flops, by_op


def phase_train_full(card, config=CONFIG, tag="train", batch=TRAIN_BATCH,
                     timed=TRAIN_TIMED, rvq_steps=True, rvq_per_step=1,
                     flops_of=None):
    """(a) The trainer of `config` (the flagship's by default) at `batch`
    (24) x 24000 on the card: k-means init, warm-up steps, `timed` timed
    steps (CUDA events per step), throughput, peak memory, a
    torch.profiler window and the FLOP bound. With rvq_steps the RVQ
    kernel must launch `rvq_per_step` times a step (2 when the generator
    forward is rematerialized), else never (shape-gain, no VQ).
    `flops_of` (tag, result) reuses another run's FLOP count where the
    step has the same shapes (bf16 against f32), instead of counting."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hilcodec_tpu_torch.ops import rvq_kernel
    from hilcodec_tpu_torch.train.loop import step_generator
    from hilcodec_tpu_torch.train.step import metrics_to_host, to_device
    from hilcodec_tpu_torch.utils.params import flatten

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, trainer, state = train_setup("cuda", batch, SEED + 20, config)
    torch.cuda.synchronize()
    log(f"[{tag}] {type(trainer).__name__} of "
        f"{os.path.relpath(config, ROOT)} on the card, batch {batch} x "
        f"{TRAIN_SEGMENT} samples; built and initialized in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 21)
    batches = [to_device(speech_batch(rng, batch, TRAIN_SEGMENT),
                         trainer.device)
               for _ in range(TRAIN_WARMUP + timed)]
    first_vq = {k: v.clone() for k, v in state.vq_state.items()}
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
    log(f"[{tag}] {TRAIN_WARMUP} warm-up steps in "
        f"{time.perf_counter() - t0:.2f} s")

    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(timed + 1)]
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
               for i in range(timed)]
    p50, p90 = np.percentile(step_ms, 50), np.percentile(step_ms, 90)
    audio_s = timed * batch * TRAIN_SEGMENT / 24000.0
    peak = torch.cuda.max_memory_allocated()
    host = [metrics_to_host(m) for m in metrics]
    log(f"[{tag}] {timed} timed steps: step ms p50 {p50:.1f}, p90 "
        f"{p90:.1f} (CUDA events; all "
        f"{', '.join(f'{x:.1f}' for x in step_ms)}); wall {wall:.3f} s, "
        f"{audio_s / wall:.1f} audio s trained per wall s; peak memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
        f"dropout depths {depths}; rvq_cascade launches {launches} ({card})")
    for k in sorted(k for k in host[0] if k.startswith("loss/")):
        log(f"[{tag}]   {k}: " + ", ".join(f"{h[k]:.4g}" for h in host))
    bad = [(i, k) for i, h in enumerate(host) for k, v in h.items()
           if k != "num_replaces" and not np.all(np.isfinite(v))]
    if bad or any(h["finite"] != 1.0 for h in host):
        raise AssertionError(f"non-finite training metrics: {bad}")
    if launches != (timed * rvq_per_step if rvq_steps else 0):
        raise AssertionError(f"rvq_cascade launched {launches} times in "
                             f"{timed} steps")
    replaces = sum(np.asarray(h["num_replaces"]) for h in host)
    moved = [k for k, v in first_vq.items()
             if v.dtype != torch.bool and not torch.equal(
                 v, state.vq_state[k])]
    log(f"[{tag}] quantizer state leaves that moved: {moved}; codes "
        f"replaced by stage over the timed steps: "
        f"{np.asarray(replaces).tolist()}")
    last_g, last_d = flatten(state.params_g), flatten(state.params_d)
    still_g = [k for k, v in first_g.items() if torch.equal(v, last_g[k])]
    still_d = [k for k, v in first_d.items() if torch.equal(v, last_d[k])]
    log(f"[{tag}] params moved: {len(first_g) - len(still_g)} / "
        f"{len(first_g)} generator leaves, {len(first_d) - len(still_d)} / "
        f"{len(first_d)} discriminator leaves (unmoved: "
        f"{(still_g + still_d)[:12]})")
    if len(still_g) > len(first_g) // 2 or len(still_d) > len(first_d) // 2:
        raise AssertionError("the parameters did not move")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the device's activity only: the same kernels and device time as
    # with the host's events too, whose trace is slower to read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches[:TRAIN_PROFILED]:
            step(b)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in dev) / TRAIN_PROFILED / 1e3
    n_kernels = sum(e.count for e in dev) / TRAIN_PROFILED
    log(f"[{tag}] torch.profiler (device activity) over {TRAIN_PROFILED} "
        f"step(s) (a window cut from 2 to 1 step for the run's time): "
        f"{dev_ms:.1f} "
        f"ms of device kernels and {n_kernels:.0f} kernels a step; device "
        f"busy {dev_ms / p50 * 100:.0f}% of the p50 step (the window and "
        f"its trace took {time.perf_counter() - t0:.1f} s)")
    top = sorted(dev, key=lambda e: -e.device_time_total)[:10]
    for e in top:
        log(f"[{tag}]   {e.device_time_total / TRAIN_PROFILED / 1e3:.2f} ms "
            f"x{e.count / TRAIN_PROFILED:.0f}/step  {e.key[:90]}")

    wav_t = batches[0]
    draws = trainer.sample_draws(step_generator(SEED, 0), wav_t.shape)
    if flops_of is None:
        flops, by_op = train_bound(trainer, state, wav_t, draws)
        counted = f"dropout depth {draws.n}"
    else:
        flops, by_op = flops_of[1]["flops"], flops_of[1]["by_op"]
        counted = f"the same shapes as [{flops_of[0]}], its count"
    # the bound at the peak of the step's convolution dtype
    bf16 = getattr(trainer, "compute_dtype", torch.float32) == torch.bfloat16
    peak_flops, dtype = ((PEAK_BF16_FLOPS, "bf16") if bf16
                         else (PEAK_F32_FLOPS, "f32"))
    bound_ms = flops / peak_flops * 1e3
    log(f"[{tag}] step FLOPs (conv + matmul shapes, forward and backward, "
        f"{counted}): {flops / 1e12:.2f} TFLOP ("
        + ", ".join(f"{k} {v / 1e12:.2f}" for k, v in sorted(
            by_op.items(), key=lambda kv: -kv[1]))
        + f"); {dtype} bound {bound_ms:.1f} ms at "
        f"{peak_flops / 1e12:.0f} TFLOP/s, "
        f"{bound_ms / p50 * 100:.1f}% of the p50 step")
    return trainer, state, dict(p50=p50, p90=p90, launches=launches,
                                bound_ms=bound_ms, peak=peak,
                                audio_s=audio_s / wall,
                                busy=dev_ms / p50, kernels=n_kernels,
                                flops=flops, by_op=by_op,
                                top=[(e.key[:60], e.device_time_total
                                      / TRAIN_PROFILED / 1e3)
                                     for e in top[:3]],
                                vq_moved=moved,
                                replaces=np.asarray(replaces))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _rel_l2(a, b, floor=1e-30):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / max(float(b.norm()), floor))


def _gate_of(opt):
    """An object whose gate_report gives the optimizer's projection gate
    (AdamP's own, SGDP's through an AdamP of its delta), or None."""
    from hilcodec_tpu_torch.train.optim import AdamP, SGDP
    if isinstance(opt, AdamP):
        return opt
    if isinstance(opt, SGDP):
        return AdamP(delta=opt.delta, eps=opt.eps)
    return None


def _radam_rectified_errs(opt_c, opt_g, grads, params, side, tag):
    """RAdam's update on both devices from a state at step 5 (the next
    update is step 6: with beta2 0.9 rho_t first passes 5 there, so the
    rectified adaptive branch runs), its moments seeded from the
    gradients: [(rel L2, 'rectified <leaf>')], logged."""
    import torch
    from hilcodec_tpu_torch.train.optim import RAdamState
    from hilcodec_tpu_torch.utils.params import flatten, tree_map

    rng = np.random.default_rng(SEED + 80)
    m = tree_map(lambda g: g * float(rng.uniform(0.5, 1.5)), grads)
    v = tree_map(lambda g: g * g * float(rng.uniform(0.5, 2.0)) + 1e-12,
                 grads)
    st = RAdamState(torch.tensor(5, dtype=torch.int32), m, v)
    b2 = opt_c.betas[1]
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    rho = rho_inf - 2.0 * 6 * b2 ** 6 / (1.0 - b2 ** 6)
    if not rho > 5.0:
        raise AssertionError(f"RAdam step 6 is not rectified (rho {rho})")
    upd_c, _ = opt_c.update(grads, st, params, torch.full((), 1e-4))
    upd_g, _ = opt_g.update(*(tree_map(lambda x: x.cuda(), t)
                              for t in (grads, st, params)),
                            torch.full((), 1e-4, device="cuda"))
    fu_c, fu_g = flatten(upd_c), flatten(upd_g)
    errs = sorted(((_rel_l2(fu_g[k], fu_c[k]), f"rectified {k}")
                   for k in fu_c), reverse=True)
    log(f"[{tag}] RAdam {side.upper()} update at step 6 (rho_t {rho:.3g} > 5, the "
        f"rectified branch) from the CPU's gradients and seeded moments: "
        f"worst rel L2 card vs CPU {errs[0][0]:.2g} ({errs[0][1]})")
    return errs


def _parity_updates(cpu_tr, card_tr, cpu_state, aux_c, aux_g, new_c, new_g,
                    tag, opt_name):
    """Per side: the gradients' worst per-leaf error, the optimizer's
    projection gate on both gradients, its update on the CPU's gradients
    on both devices, the whole step's deltas (reported) and the
    spectral-norm u buffers after the step. RAdam's update is also held
    on its rectified branch, which a fresh state does not reach."""
    import torch
    from hilcodec_tpu_torch.train.optim import RAdam
    from hilcodec_tpu_torch.utils.params import flatten, tree_map, unflatten

    flips = []
    for side in ("g", "d"):
        opt = getattr(cpu_tr, f"optim_{side}")
        gate = _gate_of(opt)
        g_c, g_g = aux_c[f"{side}_grads"], aux_g[f"{side}_grads"]
        fc = flatten(g_c)
        fg = {k: v.cpu() for k, v in flatten(g_g).items()}
        floor = GRAD_FLOOR_REL * float(torch.sqrt(sum(
            torch.sum(v.double() ** 2) for v in fc.values())))
        errs = sorted(((_rel_l2(fg[k], fc[k], floor), k) for k in fc),
                      reverse=True)
        params = getattr(cpu_state, f"params_{side}")
        gate_c = gate.gate_report(g_c, params) if gate else {}
        gate_g = gate.gate_report(unflatten(fg), params) if gate else {}
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
                raise AssertionError(f"{opt_name} gate differs at {path} "
                                     f"away from its threshold")
            flips.append(path)
            skip.add(path.replace("/", "."))
        # the card's optimizer on the CPU's gradients against the CPU's
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
        if isinstance(opt, RAdam):
            uerrs = sorted(uerrs + _radam_rectified_errs(
                opt, opt_g, g_c, params, side, tag), reverse=True)
        # the whole step: deltas where both gradients give one sign
        p0 = flatten(params)
        p_c = flatten(getattr(new_c, f"params_{side}"))
        p_g = flatten(getattr(new_g, f"params_{side}"))
        derrs, ties, worst_tie = [], 0, (0.0, "")
        for k in p0:
            if k in skip or k.endswith(".u"):
                continue
            keep = (fg[k] - fc[k]).abs() < fc[k].abs()
            ties += int((~keep).sum())
            worst_tie = max(worst_tie, (1.0 - float(keep.float().mean()), k))
            derrs.append((_rel_l2((p_g[k].cpu() - p0[k])[keep],
                                  (p_c[k] - p0[k])[keep]), k))
        derrs.sort(reverse=True)
        u_errs = sorted(((_rel_l2(p_g[k], p_c[k]), k) for k in p0
                         if k.endswith(".u")), reverse=True)
        log(f"[{tag}] {opt_name}, {side.upper()}: {len(fc)} leaves, worst "
            f"grad rel L2 {errs[0][0]:.2g} ({errs[0][1]}; floor "
            f"{GRAD_FLOOR_REL} of the global norm), worst update from the "
            f"same gradients rel L2 {uerrs[0][0]:.2g} ({uerrs[0][1]}); bars "
            f"{GRAD_RTOL}. The whole step's deltas: worst rel L2 "
            f"{derrs[0][0]:.2g} ({derrs[0][1]}) over the elements whose "
            f"gradient sign both sides give; sign ties {ties} elements, at "
            f"most {worst_tie[0]:.2%} of a leaf ({worst_tie[1]}); reported"
            + (f". Spectral-norm u after the step: {len(u_errs)} buffers, "
               f"worst rel L2 {u_errs[0][0]:.2g} ({u_errs[0][1]}); bar "
               f"{U_RTOL}" if u_errs else ""))
        if errs[0][0] > GRAD_RTOL or uerrs[0][0] > GRAD_RTOL:
            raise AssertionError(f"card vs CPU {side}: grads {errs[:3]}, "
                                 f"{opt_name} updates {uerrs[:3]}")
        if u_errs and u_errs[0][0] > U_RTOL:
            raise AssertionError(f"card vs CPU u buffers {u_errs[:3]}")
    log(f"[{tag}] {opt_name} gate flips within {GATE_MARGIN} of the "
        f"threshold (reported, not failures): {flips or 'none'}")


def phase_train_parity(config=CONFIG, tag="train-parity", optimizers=None):
    """(b) One step of the port on the card against the same step of the
    port on the CPU: full width, batch 2, the same state (codebooks
    k-means-initialized on the CPU on another batch), batch and draws.
    With `optimizers` [(name, kwargs)], the gradients of that one step are
    applied by each optimizer in turn on both devices, each update held
    as the config's own."""
    import torch
    from hilcodec_tpu_torch.ops.shape_gain import ShapeGainVQBridge
    from hilcodec_tpu_torch.train.loop import build_trainer, step_generator
    from hilcodec_tpu_torch.train.optim import make_optimizer
    from hilcodec_tpu_torch.train.step import to_device
    from hilcodec_tpu_torch.utils.params import flatten, tree_map, unflatten

    t0 = time.perf_counter()
    hps, cpu_tr, cpu_state = train_setup("cpu", PARITY_BATCH, SEED + 30,
                                         config)
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
    card_draws = draws.to("cuda")
    aux_c = cpu_tr.compute_grads(cpu_state, torch.from_numpy(wav), draws)
    wav_g = to_device(wav, card_tr.device)
    aux_g = card_tr.compute_grads(card_state, wav_g, card_draws)
    again = card_tr.compute_grads(card_state, wav_g, card_draws)
    torch.cuda.synchronize()
    log(f"[{tag}] {type(cpu_tr).__name__}: one step at batch "
        f"{PARITY_BATCH} x {TRAIN_SEGMENT} samples, dropout depth "
        f"{draws.n}, on the card and on the CPU (in "
        f"{time.perf_counter() - t0:.1f} s with set-up)")
    if isinstance(cpu_tr.model.vq, ShapeGainVQBridge):
        shape_gain_flips(cpu_tr, cpu_state, card_state, wav, tag)

    worst = {}
    for k, v in aux_c["losses"].items():
        worst[f"loss/{k}"] = _rel(aux_g["losses"][k], v)
    for k in ("loss_vq", "d_loss"):
        worst[k] = _rel(aux_g[k], aux_c[k]) if float(aux_c[k]) else abs(
            float(aux_g[k]))
    for k in ("ema_norms", "ema_fix") if "new_bal" in aux_c else ():
        worst[f"balancer/{k}"] = float(
            ((aux_g["new_bal"][k].cpu() - aux_c["new_bal"][k]).abs()
             / aux_c["new_bal"][k].abs()).max())
    for k, v in aux_c["new_vq_state"].items():
        if v.dtype != torch.bool:
            worst[f"vq/{k}"] = _rel_l2(aux_g["new_vq_state"][k], v)
    log(f"[{tag}] losses, balancer EMA (max relative error) and "
        "quantizer state (relative L2); bars 1e-4: " + ", ".join(
            f"{k} {v:.2g}" for k, v in worst.items()))
    replaces = (aux_g["num_replaces"].cpu().tolist(),
                aux_c["num_replaces"].tolist())
    log(f"[{tag}] codes replaced by stage, card / CPU: {replaces}")
    for k, rel in worst.items():
        bar = VQ_RTOL if k.startswith("vq/") else LOSS_RTOL
        if not rel <= bar:
            raise AssertionError(f"card vs CPU: {k} off by {rel:.3g} "
                                 f"(bar {bar})")
    if replaces[0] != replaces[1]:
        raise AssertionError(f"card vs CPU replace counts {replaces}")

    for name, kw in optimizers or [("its optimizer", None)]:
        tr_c, tr_g, st_c = cpu_tr, card_tr, cpu_state
        if kw is not None:
            opt, lr = make_optimizer(name, dict(kw))
            tr_c, tr_g = (dataclasses.replace(t, optim_g=opt, optim_d=opt,
                                              lr_g=lr, lr_d=lr)
                          for t in (cpu_tr, card_tr))
            st_c = cpu_state._replace(opt_g=opt.init(cpu_state.params_g),
                                      opt_d=opt.init(cpu_state.params_d))
        st_g = tree_map(lambda x: x.to("cuda"), st_c)
        _parity_updates(tr_c, tr_g, st_c, aux_c, aux_g,
                        tr_c.apply_grads(st_c, aux_c)[0],
                        tr_g.apply_grads(st_g, aux_g)[0], tag, name)
    rerun = max(_rel_l2(a, b) for a, b in zip(
        flatten(again["g_grads"]).values(),
        flatten(aux_g["g_grads"]).values()))
    log(f"[{tag}] the same step twice on the card: G grads differ "
        f"by rel L2 up to {rerun:.2g} (cuDNN's backward-weight kernels "
        f"need not be bitwise repeatable; reported, not asserted)")


def shape_gain_flips(cpu_tr, cpu_state, card_state, wav, tag):
    """Shape and gain argmax flips between the card and the CPU: each
    stage's codebook quantizes the CPU's residual on both devices (the
    card's encoder latents would differ by rounding); reported, not
    failed."""
    import torch
    rvq = cpu_tr.model.vq.rvq
    enc = cpu_tr.model.codec.encoder
    with torch.no_grad():
        z = enc.apply(cpu_state.params_g["encoder"], torch.from_numpy(wav))
        residual = z.transpose(1, 2).reshape(-1, rvq.dim)
        flips = []
        for i in range(rvq.num_quantizers):
            st_c = {k: v[i] for k, v in cpu_state.vq_state.items()}
            st_g = {k: v[i] for k, v in card_state.vq_state.items()}
            q, si, gi, _ = rvq.codebook.quantize(residual, st_c)
            _, si_g, gi_g, _ = rvq.codebook.quantize(residual.cuda(), st_g)
            flips.append((int((si != si_g.cpu()).sum()),
                          int((gi != gi_g.cpu()).sum())))
            residual = residual - q
    log(f"[{tag}] shape / gain argmax flips card vs CPU on the CPU's "
        f"residuals, by stage ({residual.shape[0]} rows): {flips}")


def phase_train_tokens(trainer, state, depths=(2, 4, 8),
                       tag="train-tokens", batch=TRAIN_BATCH, timed=None):
    """(c) The training forward's stage indices (the RVQ kernel) against
    the plain cascade at M = batch x 75 rows (1800 at the flagship's
    batch), at each dropout depth given; the kernel timed at the depths
    `timed` (all when None)."""
    import torch
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel

    wav = speech_batch(np.random.default_rng(SEED + 40), batch,
                       TRAIN_SEGMENT)
    books = state.vq_state["embed"]
    with torch.no_grad():
        z = trainer.model.codec.encoder.apply(
            state.params_g["encoder"], torch.from_numpy(wav).cuda())
        x = z.transpose(1, 2).contiguous()
        M = x.shape[0] * x.shape[1]
        for n in depths:
            got = rvq_kernel.quantize_cuda(x, books, n)
            ref = rvq.quantize(x, books, n)
            rep = rvq.token_parity_report(got, ref, x, books)
            plan, _ = rvq_kernel.device_plan(x.device, M, books.shape[1],
                                             books.shape[2], n)
            line = (f"[{tag}] M={M} n={n} (trained codebooks): "
                    f"mismatches {rep['mismatches']} (ties {rep['ties']}, "
                    f"not ties {rep['not_ties']}); plan G={plan.cluster} "
                    f"TM={plan.rows}, {plan.tiles} clusters")
            if timed is None or n in timed:
                ms = graph_ms(lambda: rvq_kernel.quantize_cuda(x, books, n))
                bound_ms, bound_by = rvq_bound_ms(M, n, books.shape[1],
                                                  books.shape[2])
                line += (f"; kernel {ms * 1e3:.2f} us (CUDA graph), bound "
                         f"{bound_ms * 1e3:.2f} us ({bound_by})")
            log(line)
            if not rep["ok"]:
                raise AssertionError(f"training tokens differ beyond ties "
                                     f"at n={n}: {rep}")


def train_cli_setup(tmp, config):
    """A seeded corpus written with the port's write_wav under {tmp}, and
    `config` training on it for one epoch of CLI_STEPS steps at CLI_BATCH,
    written to {tmp}/config.yaml: (its path, the config)."""
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
    with open(config) as f:
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
    return path, cfg


def train_cli_start(tmp, name, extra):
    """`python -m hilcodec_tpu_torch.train -n name -b {tmp}/logs [extra]`,
    started: (process, start time)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "hilcodec_tpu_torch.train", "-n", name,
         "-b", os.path.join(tmp, "logs")] + extra, cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def train_cli_await(tmp, name, run, extra, started):
    """Wait for a train CLI run started by train_cli_start: it must exit 0
    and write {tmp}/logs/{name}/{run:05d}.ckpt.npz (and, for run 2, say
    that it resumed). Returns its standard output and seconds."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        _stop(proc)
        raise
    dt = time.perf_counter() - t0
    for ln in (stdout + stderr).strip().splitlines()[-6:]:
        log(f"[train-cli]   {ln[:160]}")
    ckpt = os.path.join(tmp, "logs", name, f"{run:05d}.ckpt.npz")
    if proc.returncode != 0 or not os.path.exists(ckpt):
        raise AssertionError(f"train CLI run {run} failed "
                             f"(rc {proc.returncode}) or wrote no {ckpt}"
                             f"\n{stderr[-3000:]}")
    if run == 2 and "resumed from" not in stdout:
        raise AssertionError("the second CLI run did not resume")
    log(f"[train-cli] run {run} ({' '.join(extra)}): rc 0 in "
        f"{dt:.1f} s, wrote {os.path.relpath(ckpt, tmp)}")
    return stdout, dt


def phase_train_cli(tmp, config=os.path.join(ROOT, "configs",
                                             "hilcodec_speech_synth.yaml"),
                    name="smoke", runs=2):
    """(d) `python -m hilcodec_tpu_torch.train` of `config` on the corpus
    of train_cli_setup: one epoch writes 00001.ckpt.npz and, with runs=2,
    a second run resumes from it with the summaries of `summaries_config`
    on (-f) and writes 00002.ckpt.npz; under {tmp}/logs/{name}. Returns
    the last run's standard output and seconds."""
    path, cfg = train_cli_setup(tmp, config)
    resume = ["-c", summaries_config(tmp, cfg), "-f", "-p",
              "train.max_epochs=2"]
    for i, extra in enumerate((["-c", path], resume)[:runs]):
        out, dt = train_cli_await(tmp, name, i + 1, extra,
                                  train_cli_start(tmp, name, extra))
    return out, dt


def summaries_config(tmp, cfg):
    """`cfg` with the histograms, the infer epoch and SI-SDR on the pesq
    filelist at interval 1, written to {tmp}/config_summaries.yaml; its
    path."""
    import copy
    import yaml
    cfg = copy.deepcopy(cfg)
    valid = os.path.join(tmp, "valid.txt")
    cfg["data"]["filelists"].update(infer=valid, pesq=valid)
    cfg["data"]["num_infer"] = 2
    cfg["train"]["plot_param_and_grad"] = True
    cfg["infer"] = {"interval": 1, "batch_size": 1}
    cfg["pesq"] = {"interval": 1, "batch_size": 2, "num_workers": 0,
                   "metrics_to_calculate": {"pesq": False, "stoi": False,
                                            "sisdr": True}}
    path = os.path.join(tmp, "config_summaries.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_train(card):
    """The train phase, (a) to (d), then phase 8 on (d)'s checkpoint in the
    same directory; returns (a)'s step times and K1's launches on the timed
    steps, and phase 8's launch counts and t = 4 timings."""
    import tempfile
    trainer, state, res = phase_train_full(card)
    phase_train_tokens(trainer, state)
    del trainer, state
    phase_train_parity()
    with tempfile.TemporaryDirectory() as tmp:
        resumed = phase_train_cli(tmp)
        tools = phase_tools(tmp, card, resumed)
    return res, tools


# --------------------------------------------------------------- phase 8

TOOLS_SECONDS = 3             # the infer input
T4 = 4                        # frames a launch of the frame kernels
T4_FRAMES = 72                # the t = 4 check: 18 launches a kernel
EVAL_FILES = 4


def cli(module, args, timeout=600):
    """`python -m hilcodec_tpu_torch.<module> args` in a subprocess; its
    output, or AssertionError when it fails."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"hilcodec_tpu_torch.{module}"]
                         + args, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)}: rc "
                             f"{out.returncode}\n{out.stderr[-3000:]}")
    return out.stdout, time.perf_counter() - t0


def in_process(main, argv, tag="tools"):
    """An entry point's `main(argv)` in this process (its kernel launches
    count here); its standard output, also logged."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    for ln in buf.getvalue().strip().splitlines():
        log(f"[{tag}]   {ln}")
    return buf.getvalue(), time.perf_counter() - t0


def spawn_serve(cfg, ckpt=None, slots=4, mesh=False):
    """Start `python -m hilcodec_tpu_torch.serve [--ckpt] [--mesh]` on a
    free port: (process, a queue of its output lines, the start time)."""
    import queue
    import threading
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "hilcodec_tpu_torch.serve", "-c", cfg,
         "--slots", str(slots), "--port", "0"]
        + (["--ckpt", ckpt] if ckpt else []) + (["--mesh"] if mesh else []),
        cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    return proc, lines, t0


def await_serving(started):
    """(process, port, seconds from the start to its first "serving"
    line) of a `spawn_serve` handle; kills the process if it fails to
    start."""
    import queue
    proc, lines, t0 = started
    seen = []
    while time.perf_counter() - t0 < 300:
        try:
            ln = lines.get(timeout=5)
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        seen.append(ln.rstrip())
        m = re.match(r"serving mode=\S+ slots=\d+ n_q=\d+ on [\d.]+:(\d+)",
                     ln)
        if m:
            return proc, int(m.group(1)), time.perf_counter() - t0
    proc.kill()
    proc.wait()
    raise AssertionError("serve did not start: "
                         + " | ".join(seen[-10:]))


@contextlib.contextmanager
def serve_started(cfg, ckpt=None):
    """`spawn_serve(cfg, ckpt)` now, so that its start-up overlaps the
    caller's next (untimed) work; yields the handle for `await_serving`
    and kills the process on the way out if it still runs."""
    started = spawn_serve(cfg, ckpt)
    try:
        yield started
    finally:
        proc = started[0]
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_tools(tmp, card, resumed):
    """8. The tools on (d)'s trained checkpoint logs/smoke/00002.ckpt.npz:
    (a) export, then serve --ckpt in a subprocess and an engine built here
    from the exported deploy npz, one 75-frame TCP client each, identical
    tokens; (b) infer at -f 1 and -f 4 with --latency; (c) eval in model
    mode (--stream) and degraded mode on the infer output; the RVQ
    kernel's launches over (a)'s engine, (b) and (c); (d) the frame kernels
    at t = 4 frames a launch on the trained weights; (e) the summaries
    of (d)'s resumed run (`resumed`: its output and seconds), which had
    the infer and pesq epochs and the histograms on; (f)
    clean_checkpoint --dry-run."""
    import torch
    from hilcodec_tpu_torch import clean_checkpoint as tools_clean
    from hilcodec_tpu_torch import eval as tools_eval
    from hilcodec_tpu_torch import infer as tools_infer
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel
    from hilcodec_tpu_torch.serve import CodecServer, SlotEngine
    from hilcodec_tpu_torch.serve.__main__ import serving_weights
    from hilcodec_tpu_torch.utils.hparams import load_config
    from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

    cfg = os.path.join(tmp, "config.yaml")
    ckpt = os.path.join(tmp, "logs", "smoke", "00002.ckpt.npz")
    hps = load_config(cfg)
    sr = hps.data.sampling_rate

    # (a) export, and the two ways to the server
    deploy = os.path.join(tmp, "deploy", "smoke")
    with serve_started(cfg, ckpt) as started:
        out, dt = cli("export", ["-c", cfg, "--ckpt", ckpt, "-o", deploy])
        log(f"[tools] export --ckpt 00002.ckpt.npz in {dt:.1f} s (process "
            f"start included, beside serve --ckpt's start; {card}): "
            f"{out.strip()}")
        proc, port, dt = await_serving(started)
        try:
            log(f"[tools] serve --ckpt serving on port {port} {dt:.1f} s "
                f"after start (beside export; {card})")
            model, params, vq_state = serving_weights(
                hps, params_path=deploy + "_deploy.npz", device="cuda")
            hop, n_q = model.hop_length, model.vq.num_quantizers
            audio = client_audio(0, hop)
            tok_ckpt, pcm_ckpt = asyncio.run(run_client(port, audio, hop,
                                                        n_q))
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    engine = SlotEngine(model, params, vq_state, slots=4, mode="roundtrip",
                        fold=False, devices=[model.device])
    engine.warmup()

    async def served():
        srv = CodecServer(engine, sr=sr, port=0)
        await srv.start()
        try:
            return await run_client(srv.port, audio, hop, n_q)
        finally:
            await srv.stop()

    rvq_kernel.reset_launches()
    tok_npz, pcm_npz = asyncio.run(served())
    lsb = int(np.abs(pcm_npz.astype(np.int64) - pcm_ckpt).max())
    if tok_npz.shape != (n_q, CLIENT_FRAMES) or not np.array_equal(
            tok_npz, tok_ckpt) or lsb > PCM_TOL_LSB:
        raise AssertionError(f"serve --ckpt and the exported deploy npz "
                             f"differ: tokens equal "
                             f"{np.array_equal(tok_npz, tok_ckpt)}, PCM "
                             f"{lsb} steps")
    log(f"[tools] one {CLIENT_FRAMES}-frame TCP client: serve --ckpt and an "
        f"engine on export's deploy npz give identical tokens; PCM max "
        f"|diff| {lsb} int16 steps (tolerance {PCM_TOL_LSB})")
    del engine

    # (b) infer at 1 and 4 frames a step
    wav = speech_batch(np.random.default_rng(SEED + 60), 1,
                       TOOLS_SECONDS * sr)[0, 0]
    inp = os.path.join(tmp, "tools_in.wav")
    write_wav(inp, wav, sr)
    res = {}
    for f in (1, T4):
        o = os.path.join(tmp, f"infer_f{f}")
        text, dt = in_process(tools_infer.main, [
            "-c", cfg, "-i", inp, "--ckpt", ckpt, "-o", o, "-f", str(f),
            "--latency"])
        tok = np.load(o + "_quantized.npy")
        out_wav, out_sr = read_wav(o + "_output.wav")
        L = TOOLS_SECONDS * sr // hop // f * f
        if tok.dtype != np.int16 or tok.shape != (n_q, 1, L) \
                or out_sr != sr or out_wav.shape != (L * hop,) \
                or not np.isfinite(out_wav).all():
            raise AssertionError(f"infer -f {f}: tokens {tok.dtype} "
                                 f"{tok.shape}, wav {out_wav.shape}")
        nums = dict(re.findall(r"(encoder|decoder) RTF:\s+([\d.]+)x", text))
        lat = re.search(r"p50 ([\d.]+)\s+p90 ([\d.]+)\s+p99 ([\d.]+) ms",
                        text)
        res[f] = (tok, np.round(out_wav * 32768).astype(np.int64))
        log(f"[tools] infer -f {f}: encoder RTF {nums['encoder']}x, "
            f"decoder RTF {nums['decoder']}x on {TOOLS_SECONDS} s; "
            f"per-step latency p50 {lat.group(1)} / p90 {lat.group(2)} / "
            f"p99 {lat.group(3)} ms against {f * hop / sr * 1e3:.2f} ms "
            f"({dt:.1f} s with the model load; {card})")
    (tok1, pcm1), (tok4, pcm4) = res[1], res[T4]
    L4 = tok4.shape[-1]
    with torch.no_grad():
        model_f, params_f, vq_f = serving_weights(hps, ckpt_path=ckpt,
                                                  device="cuda")
        z = model_f.codec.encoder.apply(
            params_f["encoder"],
            torch.from_numpy(wav[:L4 * hop]).to(model_f.device)[None, None])
    rep = rvq.token_parity_report(
        torch.from_numpy(tok4[:, 0].astype(np.int64)),
        torch.from_numpy(tok1[:, 0, :L4].astype(np.int64)),
        z[0].T, vq_f["embed"])
    if not rep["ok"]:
        raise AssertionError(f"infer -f {T4} tokens differ from -f 1 beyond "
                             f"ties: {rep}")
    diff = (tok4[:, 0] != tok1[:, 0, :L4]).any(0)
    upto = (int(np.argmax(diff)) if diff.any() else L4) * hop
    lsb = int(np.abs(pcm4[:upto] - pcm1[:upto]).max())
    if lsb > PCM_TOL_LSB:
        raise AssertionError(f"infer -f {T4} PCM off -f 1 by {lsb} steps")
    log(f"[tools] infer -f {T4} against -f 1: token mismatches "
        f"{rep['mismatches']} (ties {rep['ties']}); PCM max |diff| {lsb} "
        f"int16 steps (tolerance {PCM_TOL_LSB})")

    # (c) eval, model mode on the streaming drivers and degraded mode
    ref_dir = os.path.join(tmp, "eval_ref")
    os.makedirs(ref_dir)
    for i, w in enumerate(speech_batch(np.random.default_rng(SEED + 61),
                                       EVAL_FILES, sr)):
        write_wav(os.path.join(ref_dir, f"e{i}.wav"), w[0], sr)
    text, dt = in_process(tools_eval.main, [
        "-c", cfg, "--ckpt", ckpt, "-i", ref_dir, "--stream",
        "-m", "sisdr,stoi,mcd,pesq"])
    got = dict(re.findall(r"^(\w+): ([-\d.]+) \+/- [\d.na]+ \(95% CI, "
                          rf"n={EVAL_FILES}\)", text, re.M))
    if set(got) != {"sisdr", "stoi", "mcd", "pesq"}:
        raise AssertionError(f"eval model mode printed {got}")
    log(f"[tools] eval model mode --stream on {EVAL_FILES} files in "
        f"{dt:.1f} s ({card})")
    launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
    deg_dir = os.path.join(tmp, "eval_deg")
    os.makedirs(deg_dir)
    os.replace(os.path.join(tmp, "infer_f1_output.wav"),
               os.path.join(deg_dir, "tools_in.wav"))
    text, dt = in_process(tools_eval.main, [
        "-i", inp, "-d", deg_dir, "-m", "sisdr,stoi,mcd,pesq"])
    if len(re.findall(r"\(95% CI, n=1\)", text)) != 4:
        raise AssertionError("eval degraded mode printed no score")
    log(f"[tools] rvq_cascade launches over the deploy-npz engine's client, "
        f"infer -f 1 and -f {T4} and eval model mode: {launches}")
    if launches == 0:
        raise AssertionError("the tools launched no rvq_cascade")

    # (d) the frame kernels at t = 4
    t4 = phase_frame_t4(model_f, params_f, vq_f, card)
    del model_f, params_f, vq_f, model, params, vq_state

    # (e) the train CLI's summaries, and (f) the checkpoint GC
    phase_train_summaries(tmp, card, *resumed)
    base = os.path.join(tmp, "logs")
    out, _ = in_process(tools_clean.main, [base, "--dry-run"])
    listed = [ln for ln in out.splitlines() if ln.startswith("would remove")]
    want = [f"would remove {os.path.join(base, 'smoke', '00001.ckpt.npz')}"]
    if listed != want or not os.path.exists(ckpt):
        raise AssertionError(f"clean_checkpoint --dry-run listed {listed}")
    log(f"[tools] clean_checkpoint --dry-run: {out.strip()}")
    return {"launches": launches, "t4": t4}


def phase_frame_t4(model, params, vq_state, card):
    """(d) encode_stream / decode_stream(megakernel=True, frames_per_step=4)
    at 16 and 128 streams against the plain drivers at 4 frames a step:
    tokens exact or ties, PCM on the same tokens within PCM_TOL_LSB, one
    launch of each frame kernel per 4 frames; each kernel timed at t = 4
    beside its plain version and its bound. Returns {kernel: (launches at
    128 streams, ms, plain ms, bound (ms, by))} at 128 streams."""
    import torch
    from hilcodec_tpu_torch.models.codec import (_decoder_megakernel,
                                                 _encoder_megakernel)
    from hilcodec_tpu_torch.ops import decoder_kernel as DK
    from hilcodec_tpu_torch.ops import encoder_kernel as EK
    from hilcodec_tpu_torch.ops import rvq

    hop, books = model.hop_length, vq_state["embed"]
    out = {}
    for B in (SERVE_SLOTS, PATH_STREAMS):
        wav = torch.from_numpy(speech_batch(
            np.random.default_rng(SEED + B), B, T4_FRAMES * hop)).to(
                model.device)
        with torch.no_grad():
            ce, cd = model.init_cache(B)
            DK.reset_launches()
            EK.reset_launches()
            tok, _ = model.encode_stream(params, vq_state, wav, ce,
                                         frames_per_step=T4, megakernel=True)
            y, _ = model.decode_stream(params, vq_state, tok, cd,
                                       frames_per_step=T4, megakernel=True)
            torch.cuda.synchronize()
            launches = {DK.KERNEL: DK.LAUNCHES[DK.KERNEL],
                        EK.KERNEL: EK.LAUNCHES[EK.KERNEL]}
            ref_tok, _ = model.encode_stream(params, vq_state, wav, ce,
                                             frames_per_step=T4)
            ref_y, _ = model.decode_stream(params, vq_state, tok, cd,
                                           frames_per_step=T4)
            z = model.codec.encoder.apply(params["encoder"], wav)
        rep = rvq.token_parity_report(tok, ref_tok, z.transpose(1, 2), books)
        q = [torch.clamp(torch.round(o * 32768.0), -32768, 32767).long()
             for o in (y, ref_y)]
        lsb = int((q[0] - q[1]).abs().max())
        if any(v != T4_FRAMES // T4 for v in launches.values()) \
                or not rep["ok"] or lsb > PCM_TOL_LSB \
                or not torch.isfinite(y).all():
            raise AssertionError(f"frame kernels at t={T4}, B={B}: launches "
                                 f"{launches}, tokens {rep}, PCM {lsb}")
        log(f"[t4] B={B} x {T4_FRAMES} frames, {T4} frames a launch: "
            f"launches {launches}; tokens vs the plain drivers: mismatches "
            f"{rep['mismatches']} (ties {rep['ties']}); PCM on the same "
            f"tokens max |diff| {lsb} int16 steps (tolerance {PCM_TOL_LSB})")
        # one launch at t = 4 on the first step's inputs, timed
        dm = _decoder_megakernel(model.codec.decoder)
        em = _encoder_megakernel(model.codec.encoder)
        q4 = rvq.dequantize(tok[:, :, :T4], books)          # [B, 4, 128]
        ring, window, aux = em.frame_inputs(
            em.init_cache(B, device=model.device)[0], wav[:, :, :T4 * hop])
        for name, mk, p, x, a, caches in (
                (DK.KERNEL, dm, params["decoder"], q4.contiguous(), [],
                 dm.init_cache(B, device=model.device)),
                (EK.KERNEL, em, params["encoder"], window.contiguous(), aux,
                 em.init_cache(B, device=model.device)[1:])):
            w = mk.weights(p)
            ms = cuda_ms(lambda: mk.run(p, x, a, caches), repeats=20)
            plain_ms = cuda_ms(lambda: DK.run_plain(mk.ops, w.per_op, x, a,
                                                    caches), repeats=20)
            bounds, flops, _ = frame_bound_ms(mk, w, x, a, caches)
            log(f"[t4] {name} B={B} t={T4}: {ms:.4f} ms a launch "
                f"({ms / T4:.4f} ms a frame), plain {plain_ms:.4f} ms, "
                f"bound {bounds['tc'][0]:.4f} ms ({bounds['tc'][1]}; "
                f"{flops / B / 1e6:.1f} MFLOP a stream) ({card})")
            if B == PATH_STREAMS:
                out[name] = (launches[name], ms, plain_ms, bounds["tc"])
    return out


def phase_train_summaries(tmp, card, out, dt):
    """(e) The summaries of run smoke's resumed epoch (`out`, its standard
    output, and `dt`, its seconds), which had the histograms, the infer
    epoch and SI-SDR on the pesq filelist at interval 1: event files under
    train/ and valid/ carrying them, or, where a package is missing, the
    loop's one line naming what it does not write."""
    from hilcodec_tpu_torch.utils import summarize as S

    base = os.path.join(tmp, "logs")
    absent = S.missing()
    notice = [ln for ln in out.splitlines() if ln.startswith("TrainLoop:")]
    if absent and len(notice) != 1:
        raise AssertionError(f"{absent} missing, but the loop said {notice}")
    if "metric/sisdr" not in out:
        raise AssertionError("the pesq epoch wrote no metric/sisdr")
    run = os.path.join(base, "smoke")
    if "tensorboard" in absent:
        log(f"[train-tb] no tensorboard: {notice[0]}")
        return
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    tags = {}
    for part in ("train", "valid"):
        ea = EventAccumulator(os.path.join(run, part), size_guidance={
            "scalars": 0, "histograms": 0, "images": 0, "audio": 0})
        ea.Reload()
        tags[part] = ea.Tags()
    # the resumed (second) epoch writes the reconstructions of the two
    # infer files; the ground truth goes out in the first epoch only
    gen = ["gen/wav_0", "gen/wav_1"]
    want_images = [] if "matplotlib" in absent else ["gen/mel_0",
                                                     "gen/mel_1"]
    if not (tags["train"]["histograms"] and "loss/freq" in
            tags["train"]["scalars"] and "metric/sisdr" in
            tags["valid"]["scalars"]
            and sorted(tags["valid"]["audio"]) == gen
            and sorted(tags["valid"]["images"]) == want_images):
        raise AssertionError(f"event files lack the summaries: train "
                             f"{len(tags['train']['histograms'])} "
                             f"histograms, scalars "
                             f"{tags['train']['scalars']}; valid "
                             f"{tags['valid']}")
    log(f"[train-tb] the resumed epoch in {dt:.1f} s ({card}); event "
        f"files: train {len(tags['train']['scalars'])} scalars, "
        f"{len(tags['train']['histograms'])} histograms; valid "
        f"{len(tags['valid']['scalars'])} scalars, "
        f"{len(tags['valid']['audio'])} audio, "
        f"{len(tags['valid']['images'])} images"
        + (f"; {notice[0]}" if notice else ""))


# --------------------------------------------------------------- phase 9

def build_encodec(device):
    """configs/encodec_24khz.yaml at full width: seeded params, N(0, 1)
    codebooks (32 x 1024 x 128), folded."""
    import torch
    from hilcodec_tpu_torch.models.registry import build_codec_model
    from hilcodec_tpu_torch.utils.hparams import load_config

    hps = load_config(ENCODEC_CONFIG)
    model = build_codec_model(hps.model, hps.model_kwargs.to_dict(),
                              device=device)
    params, vq_state = model.seeded(random_books=True)
    return (model, model.fold_params(params), vq_state,
            hps.data.sampling_rate)


def phase_lstm(dev):
    """The EnCodec LSTM (width 512, 2 layers) through torch.lstm on the
    card at 16 streams x 75 frames against a float64 run of the port's
    CPU cell on the same weights: f32 under set_f32_parity_mode, and the
    same call with TF32 allowed, to show that the mode reaches cuDNN's
    RNN."""
    import torch
    from hilcodec_tpu_torch import set_f32_parity_mode
    from hilcodec_tpu_torch.models.encodec import SLSTM
    from hilcodec_tpu_torch.utils.params import tree_map

    lstm = SLSTM(512, 2)
    gen = torch.Generator().manual_seed(SEED + 60)
    params = lstm.init(gen)
    x = torch.randn((16, 512, CLIENT_FRAMES), generator=gen)
    with torch.no_grad():
        ref = lstm.apply(tree_map(lambda v: v.double(), params), x.double())
        p_dev = tree_map(lambda v: v.to(dev), params)
        errs = {}
        for mode in ("tf32", "f32"):
            if mode == "f32":
                set_f32_parity_mode()
            else:
                torch.backends.cudnn.allow_tf32 = True
                torch.backends.cuda.matmul.allow_tf32 = True
            y = lstm.apply(p_dev, x.to(dev))
            errs[mode] = float((y.double().cpu() - ref).abs().max())
    log(f"[encodec-lstm] torch.lstm (cuDNN), 2 layers x 512, 16 x "
        f"{CLIENT_FRAMES} steps, against a float64 CPU run: max |diff| "
        f"{errs['f32']:.3g} in the f32 parity mode (tolerance {LSTM_TOL}), "
        f"{errs['tf32']:.3g} with TF32 allowed")
    if not errs["f32"] <= LSTM_TOL:
        raise AssertionError(f"cuDNN's LSTM is off by {errs['f32']} in the "
                             f"f32 parity mode")
    if not errs["tf32"] > LSTM_TOL:
        raise AssertionError(f"with TF32 allowed cuDNN's LSTM is off by only "
                             f"{errs['tf32']}: this check cannot tell the "
                             f"modes apart")


def phase_serve_cli(config, card, tag, started):
    """`python -m hilcodec_tpu_torch.serve -c CONFIG` (4 slots, its seeded
    weights) in a subprocess, started already (`serve_started`), one
    75-frame client, against a 4-slot engine in this process on the
    weights the CLI builds (`serving_weights`): the same tokens, PCM within
    PCM_TOL_LSB."""
    from hilcodec_tpu_torch.serve import CodecServer, SlotEngine
    from hilcodec_tpu_torch.serve.__main__ import serving_weights
    from hilcodec_tpu_torch.utils.hparams import load_config

    hps = load_config(config)
    model, params, vq_state = serving_weights(hps, device="cuda")
    sr = hps.data.sampling_rate
    hop, n_q = model.hop_length, model.vq.num_quantizers
    audio = client_audio(0, hop)
    proc, port, dt = await_serving(started)
    try:
        tok_cli, pcm_cli = asyncio.run(run_client(port, audio, hop, n_q))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    engine = SlotEngine(model, params, vq_state, slots=4, mode="roundtrip",
                        fold=False, devices=[model.device])
    engine.warmup()

    async def served():
        srv = CodecServer(engine, sr=sr, port=0)
        await srv.start()
        try:
            return await run_client(srv.port, audio, hop, n_q)
        finally:
            await srv.stop()

    tok, pcm = asyncio.run(served())
    lsb = int(np.abs(pcm.astype(np.int64) - pcm_cli).max())
    log(f"[{tag}] serve -c {os.path.relpath(config, ROOT)} serving "
        f"{dt:.1f} s after start (started beside this phase's untimed "
        f"work; {card}); one {CLIENT_FRAMES}-frame client "
        f"against an engine in this process: tokens "
        f"{'identical' if np.array_equal(tok, tok_cli) else 'DIFFER'}, PCM "
        f"max |diff| {lsb} int16 steps")
    if tok_cli.shape != (n_q, CLIENT_FRAMES) or not np.array_equal(
            tok, tok_cli) or lsb > PCM_TOL_LSB:
        raise AssertionError(f"the serve CLI of {config} differs from the "
                             f"engine on the same weights")


def phase_encodec(card):
    """configs/encodec_24khz.yaml on the card: the LSTM's f32 check; a
    16-slot engine behind TCP (8 clients x 75 frames, each against its
    solo stream with the plain quantizer); the serve CLI; ticks at 16 and
    128 slots with
    the profiler; the bench with --model encodec at 16 and 128 streams;
    the trainer at batch 24 x 24000 (1 warm-up, 5 timed steps); the RVQ
    kernel's training tokens at M = 1800, n = 32; one step on the card
    against the CPU step at batch 2. Returns the RVQ kernel's launches on
    the serving, bench and training paths and the training numbers."""
    import torch
    from hilcodec_tpu_torch import bench
    from hilcodec_tpu_torch.ops import rvq_kernel

    with serve_started(ENCODEC_CONFIG) as started:
        phase_lstm(torch.device("cuda", 0))
        model, params, vq_state, sr = build_encodec("cuda")
        log(f"[encodec] configs/encodec_24khz.yaml: hop {model.hop_length}, "
            f"RVQ {model.vq.num_quantizers} x {model.vq.codebook_size} x "
            f"{model.vq.dim}, caches "
            f"{[len(c) for c in model.init_cache(1)]} tensors, slot axes "
            f"{model.cache_axes()}")
        serve_launches = phase_serve(model, params, vq_state, sr,
                                     tag="encodec-serve")
        phase_serve_cli(ENCODEC_CONFIG, card, "encodec-serve-cli", started)
    ticks = phase_timings(model, params, vq_state, card,
                          tag="encodec-timing")
    del model, params, vq_state
    rvq_kernel.reset_launches()
    for streams in ENCODEC_BENCH_STREAMS:
        argv = [str(streams), "--seconds", "1", "--model", "encodec"]
        log(f"[encodec-bench] python -m hilcodec_tpu_torch.bench "
            f"{' '.join(argv)}: {json.dumps(bench.run(argv))}")
    bench_launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
    log(f"[encodec-bench] rvq_cascade launches over both runs "
        f"{bench_launches} (n = 8)")
    trainer, state, train = phase_train_full(card, ENCODEC_CONFIG,
                                             tag="encodec-train")
    # torch.utils.flop_counter does not count cuDNN's LSTM: its products,
    # two LSTMs of 2 layers x 512 over 24 x 75 frames, forward (16 H^2 a
    # row and layer) and backward (twice that)
    lstm_flops = 2 * 2 * 3 * 16 * 512 ** 2 * TRAIN_BATCH * 75
    log(f"[encodec-train] the LSTMs' products, not in the counter above: "
        f"{lstm_flops / 1e12:.3f} TFLOP a step")
    # every dropout depth the path draws: the ring of the kernel's plan
    # is min(4, n) at M = 1800
    phase_train_tokens(trainer, state, depths=range(1, 33),
                       tag="encodec-train-tokens", timed=(1, 2, 3, 13, 32))
    del trainer, state
    torch.cuda.empty_cache()
    phase_train_parity(ENCODEC_CONFIG, tag="encodec-train-parity")
    return dict(serve_launches=serve_launches, bench_launches=bench_launches,
                ticks=ticks, train=train)


# --------------------------------------------------------------- phase 10

AVOCODO_BATCH = 12            # configs/avocodo_music.yaml's batch
AVOCODO_BENCH_STREAMS = (16, 128)
HILTRAINER_STEPS = 3


def phase_avocodo(card):
    """configs/avocodo_music.yaml on the card (encoder 64 / decoder 96, RVQ
    12 x 1024 x 128, CoMBD + SBD): a 16-slot engine behind TCP (8 clients
    x 75 frames, each against its solo stream with the plain quantizer,
    one RVQ launch a tick); the serve CLI; ticks at 16 and 128 slots with
    the profiler; the bench with --model avocodo at 16 and 128 streams;
    the Avocodo trainer at batch 12 x 24000 (1 warm-up, 5 timed steps);
    the RVQ kernel's training tokens at M = 900 for n = 2, 4, 8, 12; one
    step on the card against the CPU step at batch 2; 3 steps of
    configs/avocodo_synth_hiltrainer.yaml at batch 24, beside the train CLI
    of configs/avocodo_synth.yaml for one epoch; the tools on its
    checkpoint. Returns the RVQ kernel's launches on each path and the
    numbers of the serving and training paths."""
    import tempfile
    import torch
    from hilcodec_tpu_torch import bench
    from hilcodec_tpu_torch.ops import rvq_kernel

    t0 = time.perf_counter()

    def done(part):
        log(f"[time] phase 10 {part} done at "
            f"{time.perf_counter() - t0:.1f} s into the phase")

    with serve_started(AVOCODO_CONFIG) as started:
        model, params, vq_state, sr = build_flagship("cuda", AVOCODO_CONFIG)
        log(f"[avocodo] configs/avocodo_music.yaml: hop {model.hop_length}, "
            f"RVQ {model.vq.num_quantizers} x {model.vq.codebook_size} x "
            f"{model.vq.dim}, caches "
            f"{[len(c) for c in model.init_cache(1)]} tensors, slot axes "
            f"{model.cache_axes()}")
        serve_launches = phase_serve(model, params, vq_state, sr,
                                     tag="avocodo-serve")
        phase_serve_cli(AVOCODO_CONFIG, card, "avocodo-serve-cli", started)
    done("serving")
    ticks = phase_timings(model, params, vq_state, card,
                          tag="avocodo-timing")
    del model, params, vq_state
    done("ticks")
    rvq_kernel.reset_launches()
    for streams in AVOCODO_BENCH_STREAMS:
        argv = [str(streams), "--seconds", "1", "--model", "avocodo"]
        log(f"[avocodo-bench] python -m hilcodec_tpu_torch.bench "
            f"{' '.join(argv)}: {json.dumps(bench.run(argv))}")
    bench_launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
    log(f"[avocodo-bench] rvq_cascade launches over both runs "
        f"{bench_launches} (n = 8)")
    done("bench")
    trainer, state, train = phase_train_full(
        card, AVOCODO_CONFIG, tag="avocodo-train", batch=AVOCODO_BATCH)
    phase_train_tokens(trainer, state, depths=(2, 4, 8, 12),
                       tag="avocodo-train-tokens", batch=AVOCODO_BATCH)
    del trainer, state
    torch.cuda.empty_cache()
    done("training")
    with tempfile.TemporaryDirectory() as tmp:
        # the train CLI's epoch runs beside the untimed parity step and
        # the ablation; the tools take its checkpoint
        cli = ["-c", train_cli_setup(tmp, os.path.join(
            ROOT, "configs", "avocodo_synth.yaml"))[0]]
        started = train_cli_start(tmp, "avo", cli)
        try:
            phase_train_parity(AVOCODO_CONFIG, tag="avocodo-train-parity")
            hil_launches = phase_hiltrainer(card)
            train_cli_await(tmp, "avo", 1, cli, started)
        finally:
            _stop(started[0])
        torch.cuda.empty_cache()
        done("parity, the hiltrainer ablation and the train CLI")
        tools_launches = phase_avocodo_tools(tmp, card)
    return dict(serve_launches=serve_launches, bench_launches=bench_launches,
                ticks=ticks, train=train, hil_launches=hil_launches,
                tools_launches=tools_launches)


def phase_hiltrainer(card):
    """configs/avocodo_synth_hiltrainer.yaml (the Avocodo generator under
    the balancer trainer, MFBD + MSTFTD) for HILTRAINER_STEPS steps at its
    batch of 24: every loss finite, one RVQ launch a step (M = 1800)."""
    from hilcodec_tpu_torch.ops import rvq_kernel
    from hilcodec_tpu_torch.train.loop import step_generator
    from hilcodec_tpu_torch.train.step import metrics_to_host, to_device

    _, trainer, state = train_setup("cuda", TRAIN_BATCH, SEED + 70,
                                    AVOCODO_HILTRAINER)
    rng = np.random.default_rng(SEED + 71)
    rvq_kernel.reset_launches()
    walls, host = [], []
    for i in range(HILTRAINER_STEPS):
        wav = to_device(speech_batch(rng, TRAIN_BATCH, TRAIN_SEGMENT),
                        trainer.device)
        t0 = time.perf_counter()
        draws = trainer.sample_draws(step_generator(SEED, i), wav.shape)
        state, m = trainer.train_step(state, wav, draws)
        host.append(metrics_to_host(m))
        walls.append(time.perf_counter() - t0)
    launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
    log(f"[avocodo-hiltrainer] {type(trainer).__name__} of "
        f"configs/avocodo_synth_hiltrainer.yaml, {HILTRAINER_STEPS} steps "
        f"at batch {TRAIN_BATCH}: wall s {[round(w, 3) for w in walls]} "
        f"(the first builds cuDNN's plans; beside the train CLI); "
        f"rvq_cascade launches {launches} "
        f"({card})")
    for k in sorted(k for k in host[0] if k.startswith("loss/")):
        log(f"[avocodo-hiltrainer]   {k}: "
            + ", ".join(f"{h[k]:.4g}" for h in host))
    bad = [(i, k) for i, h in enumerate(host) for k, v in h.items()
           if k != "num_replaces" and not np.all(np.isfinite(v))]
    if bad or launches != HILTRAINER_STEPS:
        raise AssertionError(f"hiltrainer: non-finite {bad}, rvq_cascade "
                             f"launches {launches}")
    return launches


def phase_avocodo_tools(tmp, card):
    """On the 00001.ckpt.npz that the train CLI of configs/
    avocodo_synth.yaml wrote under {tmp}: export, infer -f 1 with
    --latency and eval in model mode (offline, through the trainer's
    facade) in this process; the RVQ kernel's launches over infer and
    eval."""
    from hilcodec_tpu_torch import eval as tools_eval
    from hilcodec_tpu_torch import export as tools_export
    from hilcodec_tpu_torch import infer as tools_infer
    from hilcodec_tpu_torch.ops import rvq_kernel
    from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

    cfg = os.path.join(tmp, "config.yaml")
    ckpt = os.path.join(tmp, "logs", "avo", "00001.ckpt.npz")
    deploy = os.path.join(tmp, "deploy", "avo")
    out, dt = in_process(tools_export.main, ["-c", cfg, "--ckpt", ckpt,
                                             "-o", deploy])
    with np.load(deploy + "_deploy.npz") as z:
        books = z["codebooks"].shape
        heads = sorted(k for k in z.files if k.startswith("decoder/heads/"))
    log(f"[avocodo-tools] export --ckpt 00001.ckpt.npz in {dt:.1f} s "
        f"(in this process; {card}); codebooks {books}, head leaves "
        f"{heads}")
    if books != (12, 1024, 128) or "decoder/heads/2/w" not in heads:
        raise AssertionError("export wrote no Avocodo deploy npz")

    sr = 24000
    wav = speech_batch(np.random.default_rng(SEED + 80), 1,
                       TOOLS_SECONDS * sr)[0, 0]
    inp = os.path.join(tmp, "tools_in.wav")
    write_wav(inp, wav, sr)
    rvq_kernel.reset_launches()
    o = os.path.join(tmp, "infer_avo")
    text, dt = in_process(tools_infer.main, [
        "-c", cfg, "-i", inp, "--ckpt", ckpt, "-o", o, "-f", "1",
        "--latency"])
    tok = np.load(o + "_quantized.npy")
    out_wav, out_sr = read_wav(o + "_output.wav")
    L = TOOLS_SECONDS * sr // 320
    if tok.dtype != np.int16 or tok.shape != (12, 1, L) or out_sr != sr \
            or out_wav.shape != (L * 320,) or not np.isfinite(out_wav).all():
        raise AssertionError(f"infer: tokens {tok.dtype} {tok.shape}, wav "
                             f"{out_wav.shape}")
    nums = dict(re.findall(r"(encoder|decoder) RTF:\s+([\d.]+)x", text))
    lat = re.search(r"p50 ([\d.]+)\s+p90 ([\d.]+)\s+p99 ([\d.]+) ms",
                    text)
    log(f"[avocodo-tools] infer -f 1: encoder RTF {nums['encoder']}x, "
        f"decoder RTF {nums['decoder']}x on {TOOLS_SECONDS} s; per-step "
        f"latency p50 {lat.group(1)} / p90 {lat.group(2)} / p99 "
        f"{lat.group(3)} ms against 13.33 ms ({dt:.1f} s with the model "
        f"load; {card})")

    ref_dir = os.path.join(tmp, "eval_ref")
    os.makedirs(ref_dir)
    for i, w in enumerate(speech_batch(np.random.default_rng(SEED + 81),
                                       EVAL_FILES, sr)):
        write_wav(os.path.join(ref_dir, f"e{i}.wav"), w[0], sr)
    text, dt = in_process(tools_eval.main, [
        "-c", cfg, "--ckpt", ckpt, "-i", ref_dir, "-m", "sisdr,stoi,mcd"])
    got = dict(re.findall(r"^(\w+): ([-\d.]+) \+/- [\d.na]+ \(95% CI, "
                          rf"n={EVAL_FILES}\)", text, re.M))
    if set(got) != {"sisdr", "stoi", "mcd"}:
        raise AssertionError(f"eval model mode printed {got}")
    launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
    log(f"[avocodo-tools] eval model mode (offline, the trainer's facade) "
        f"on {EVAL_FILES} files in {dt:.1f} s ({card}); rvq_cascade "
        f"launches over infer and eval {launches}")
    if launches == 0:
        raise AssertionError("the Avocodo tools launched no rvq_cascade")
    return launches


# --------------------------------------------------------------- phase 11

SHAPEGAIN_TIMED = 5
NOVQ_STEPS = 2


def phase_routing(card):
    """The `vq:` routing on configs/hilcodec_shapegain_synth.yaml (32 / 48
    channels): shape-gain training at batch 24 (1 warm-up, 5 timed steps;
    losses finite, the shape / gain EMA state moved, replaces counted, no
    RVQ launch); the same config with `vq: ''` for NOVQ_STEPS steps (zero
    VQ loss, no replaces); one shape-gain step on the card against the
    CPU step at batch 2, its argmax flips reported."""
    import torch
    from hilcodec_tpu_torch.ops import rvq_kernel
    from hilcodec_tpu_torch.train.loop import build_trainer, step_generator
    from hilcodec_tpu_torch.train.step import metrics_to_host, to_device
    from hilcodec_tpu_torch.utils.hparams import load_config

    trainer, state, res = phase_train_full(
        card, SHAPEGAIN_CONFIG, tag="shapegain-train",
        timed=SHAPEGAIN_TIMED, rvq_steps=False)
    if set(res["vq_moved"]) != {"shape", "shape_num", "gain", "gain_num"} \
            or int(res["replaces"].sum()) == 0:
        raise AssertionError(f"shape-gain state moved {res['vq_moved']}, "
                             f"replaces {res['replaces']}")
    del trainer, state
    torch.cuda.empty_cache()

    hps = load_config(SHAPEGAIN_CONFIG)
    hps.model_kwargs["vq"] = ""
    trainer = build_trainer(hps, "cuda")
    state = trainer.init_state(torch.Generator().manual_seed(SEED + 90))
    rng = np.random.default_rng(SEED + 91)
    rvq_kernel.reset_launches()
    host = []
    for i in range(NOVQ_STEPS):
        wav = to_device(speech_batch(rng, TRAIN_BATCH, TRAIN_SEGMENT),
                        trainer.device)
        state, m = trainer.train_step(
            state, wav, trainer.sample_draws(step_generator(SEED, i),
                                             wav.shape))
        host.append(metrics_to_host(m))
    log(f"[novq-train] {type(trainer.model.vq).__name__}, {NOVQ_STEPS} "
        f"steps at batch {TRAIN_BATCH}: " + "; ".join(
            ", ".join(f"{k} {v:.4g}" for k, v in h.items()
                      if k.startswith("loss/")) for h in host)
        + f"; rvq_cascade launches {rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]}")
    bad = [(i, k) for i, h in enumerate(host) for k, v in h.items()
           if k != "num_replaces" and not np.all(np.isfinite(v))]
    if bad or any(h["loss/vq"] != 0.0 or h["num_replaces"].size
                  for h in host) or rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]:
        raise AssertionError(f"vq '': non-finite {bad} or a quantizer ran")
    del trainer, state
    torch.cuda.empty_cache()
    phase_train_parity(SHAPEGAIN_CONFIG, tag="shapegain-train-parity")
    return res


# --------------------------------------------------------------- phase 12

AUDIODEC_ROWS = (1, SERVE_SLOTS, 128)   # tools, serving, the bench's 128
AUDIODEC_BENCH_STREAMS = (16, 128)


def write_audiodec_config(tmp):
    """AudioDec at its shipped defaults (`AudioDec()`, RVQ 8 x 1024 x 64,
    hop 300): no config in configs/ selects it, so a temporary yaml."""
    import yaml
    path = os.path.join(tmp, "audiodec.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"model": "audiodec", "model_kwargs": {},
                        "data": {"sampling_rate": 24000}}, f)
    return path


def phase_rvq64(dev):
    """K1 at AudioDec's shape (n = 8, K = 1024, C = 64) against the plain
    cascade at M = 1, 16, 128 (tokens exact or ties, two more launches
    bitwise equal), then timed through a CUDA graph beside its plain
    version and its bound. Returns {M: (ms, plain_ms, bound_ms, bound_by)}
    and the largest dequantized difference."""
    import torch
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel

    gen = torch.Generator().manual_seed(SEED + 120)
    books = torch.randn((8, 1024, 64), generator=gen).to(dev)
    out, max_err = {}, 0.0
    for M in AUDIODEC_ROWS:
        x = torch.randn((1, M, 64), generator=gen).to(dev)
        ref = rvq.quantize(x, books, 8)
        got = rvq_kernel.quantize_cuda(x, books, 8)
        same = all(torch.equal(got, rvq_kernel.quantize_cuda(x, books, 8))
                   for _ in range(2))
        rep = rvq.token_parity_report(got, ref, x, books)
        err = float((rvq.dequantize(got, books)
                     - rvq.dequantize(ref, books)).abs().max())
        max_err = max(max_err, err)
        plan, _ = rvq_kernel.device_plan(dev, M, 1024, 64, 8)
        ms = graph_ms(lambda: rvq_kernel.quantize_cuda(x, books, 8))
        plain_ms = cuda_ms(lambda: rvq.quantize(x, books, 8))
        bound_ms, bound_by = rvq_bound_ms(M, 8, 1024, 64)
        out[M] = (ms, plain_ms, bound_ms, bound_by)
        ok = rep["ok"] and same and tuple(got.shape) == (8, 1, M)
        log(f"[audiodec-kernel] rvq_cascade M={M} n=8 K=1024 C=64 "
            f"(G={plan.cluster} TM={plan.rows}, {plan.tiles} cluster(s), "
            f"slice {plan.slice} x {plan.chunks} chunk(s)): mismatches "
            f"{rep['mismatches']} (ties {rep['ties']}), dequantized max abs "
            f"err {err:.3g}, two more launches "
            f"{'bitwise equal' if same else 'DIFFER'}; kernel "
            f"{ms * 1e3:.2f} us (CUDA graph), plain {plain_ms * 1e3:.1f} "
            f"us, bound {bound_ms * 1e3:.2f} us ({bound_by}) "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rvq_cascade at C = 64, M = {M}: {rep}")
    return out, max_err


def phase_audiodec(card):
    """AudioDec at full width (its defaults: encoder 32 -> 512 channels,
    decoder 512 channels with grouped k = 11 blocks, hop 300, RVQ 8 x 1024
    x 64; seeded weights, N(0, 1) codebooks, folded): K1 at C = 64; a
    16-slot engine behind TCP (8 clients x 75 frames against their solo
    streams, one RVQ launch a tick); the serve CLI; ticks at 16 and 128
    slots against the 12.5 ms frame, with the profiler; the bench with
    --model audiodec at 16 and 128 streams; export and infer -f 1 on the
    seeded weights. Returns the RVQ kernel's timings and launches."""
    import tempfile
    import torch
    from hilcodec_tpu_torch import bench
    from hilcodec_tpu_torch import export as tools_export
    from hilcodec_tpu_torch import infer as tools_infer
    from hilcodec_tpu_torch.ops import rvq_kernel
    from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

    t0 = time.perf_counter()

    def done(part):
        log(f"[time] phase 12 {part} done at "
            f"{time.perf_counter() - t0:.1f} s into the phase")

    timings, max_err = phase_rvq64(torch.device("cuda", 0))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_audiodec_config(tmp)
        with serve_started(cfg) as started:
            model, params, vq_state, sr = build_flagship("cuda", cfg)
            log(f"[audiodec] AudioDec(): hop {model.hop_length}, RVQ "
                f"{model.vq.num_quantizers} x {model.vq.codebook_size} x "
                f"{model.vq.dim}, caches "
                f"{[len(c) for c in model.init_cache(1)]} tensors, slot "
                f"axes {model.cache_axes()}")
            serve_launches = phase_serve(model, params, vq_state, sr,
                                         tag="audiodec-serve")
            phase_serve_cli(cfg, card, "audiodec-serve-cli", started)
        done("serving")
        ticks = phase_timings(model, params, vq_state, card,
                              tag="audiodec-timing")
        del model, params, vq_state
        torch.cuda.empty_cache()
        done("ticks")
        rvq_kernel.reset_launches()
        for streams in AUDIODEC_BENCH_STREAMS:
            argv = [str(streams), "--seconds", "1", "--model", "audiodec"]
            log(f"[audiodec-bench] python -m hilcodec_tpu_torch.bench "
                f"{' '.join(argv)}: {json.dumps(bench.run(argv))}")
        bench_launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
        log(f"[audiodec-bench] rvq_cascade launches over both runs "
            f"{bench_launches} (n = 8, C = 64)")
        done("bench")

        deploy = os.path.join(tmp, "deploy", "ad")
        _, dt = in_process(tools_export.main, ["-c", cfg, "-o", deploy])
        with np.load(deploy + "_deploy.npz") as z:
            books = z["codebooks"].shape
            n_leaves = len(z.files)
        log(f"[audiodec-tools] export (seeded weights) in {dt:.1f} s: "
            f"{n_leaves} leaves, codebooks {books} ({card})")
        if books != (8, 1024, 64):
            raise AssertionError(f"export wrote codebooks {books}")
        wav = speech_batch(np.random.default_rng(SEED + 121), 1,
                           TOOLS_SECONDS * 24000)[0, 0]
        inp = os.path.join(tmp, "in.wav")
        write_wav(inp, wav, 24000)
        rvq_kernel.reset_launches()
        o = os.path.join(tmp, "infer_ad")
        text, dt = in_process(tools_infer.main, [
            "-c", cfg, "-i", inp, "-o", o, "-f", "1", "--latency"])
        tools_launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
        tok = np.load(o + "_quantized.npy")
        out_wav, out_sr = read_wav(o + "_output.wav")
        L = TOOLS_SECONDS * 24000 // 300
        if tok.shape != (8, 1, L) or out_wav.shape != (L * 300,) \
                or not np.isfinite(out_wav).all():
            raise AssertionError(f"infer: tokens {tok.shape}, wav "
                                 f"{out_wav.shape}")
        nums = dict(re.findall(r"(encoder|decoder) RTF:\s+([\d.]+)x", text))
        lat = re.search(r"p50 ([\d.]+)\s+p90 ([\d.]+)\s+p99 ([\d.]+) ms",
                        text)
        log(f"[audiodec-tools] infer -f 1: encoder RTF {nums['encoder']}x, "
            f"decoder RTF {nums['decoder']}x on {TOOLS_SECONDS} s; per-step "
            f"latency p50 {lat.group(1)} / p90 {lat.group(2)} / p99 "
            f"{lat.group(3)} ms against 12.50 ms; rvq_cascade launches "
            f"{tools_launches} ({card})")
        if tools_launches == 0:
            raise AssertionError("infer launched no rvq_cascade")
    done("tools")
    return dict(timings=timings, max_err=max_err,
                serve_launches=serve_launches, bench_launches=bench_launches,
                tools_launches=tools_launches, ticks=ticks)


# --------------------------------------------------------------- phase 13

LM_STEPS = 60                 # train_lm steps at its default batch of 32
LM_SEG = 150                  # the CLIs' default segment (2 s at 75 fps)
LM_ARCH = "200,8,5,150"       # the CLIs' default LM
CODER_SYMBOLS = 3000
# the live stepper against the batched LM, max abs probability difference:
# the CPU tests' bound (PROB_ATOL of tests/test_torch_lm.py); the card
# read 1.79e-7
LM_STEP_TOL = 1e-5


def phase_coder():
    """The range coder's native (the checkout's csrc/rangecoder.cpp, built
    with g++) and Python paths on seeded LM-like cdfs over 1024 symbols:
    the same bytes, both decode back; times of each."""
    from hilcodec_tpu_torch.ops import cuda_build
    from hilcodec_tpu_torch.ops import entropy_coding as E

    path, secs, _ = cuda_build.build_host("rangecoder")
    rng = np.random.default_rng(SEED + 130)
    cdfs = np.stack([E.quantize_cdf(rng.dirichlet(np.ones(1024) * a))
                     for a in rng.uniform(0.02, 2.0, CODER_SYMBOLS)])
    syms = np.array([rng.choice(1024, p=np.diff(c) / c[-1]) for c in cdfs])
    times = {}
    for native in (True, False):
        t0 = time.perf_counter()
        data = E.encode_symbols(syms, cdfs, native=native)
        t1 = time.perf_counter()
        back = E.decode_symbols(data, cdfs, native=native)
        times[native] = (data, t1 - t0, time.perf_counter() - t1,
                         np.array_equal(back, syms))
    same = times[True][0] == times[False][0]
    log(f"[coder] csrc/rangecoder.cpp built with {cuda_build.gxx()} "
        f"{' '.join(cuda_build.GXX_FLAGS)} in {secs:.2f} s -> "
        f"{os.path.relpath(path, ROOT)}; {CODER_SYMBOLS} symbols, "
        f"{len(times[True][0])} bytes: native and Python bytes "
        f"{'identical' if same else 'DIFFER'}; encode / decode native "
        f"{times[True][1] * 1e3:.2f} / {times[True][2] * 1e3:.2f} ms, "
        f"Python {times[False][1] * 1e3:.1f} / {times[False][2] * 1e3:.1f} "
        f"ms; roundtrips {times[True][3]} / {times[False][3]}")
    if not (same and times[True][3] and times[False][3]):
        raise AssertionError("the native and Python range coders disagree")


def phase_entropy(card):
    """Entropy-coded token streams on the card: the range coder; the
    flagship's codec state (train_setup: seeded, k-means codebooks) saved
    as a checkpoint; `train_lm` for LM_STEPS steps at the default LM on
    its tokens of a seeded speech corpus (the held-out loss must fall);
    `entropy_code` encode -> .hilstream -> decode (tokens exact, CRC);
    `infer --entropy-stream` live on 3 s of seeded speech (roundtrip
    exact; kbps, coder latency p50 / p99 against the 13.33 ms frame, the
    decoder's lag); the live stepper's probabilities against the batched
    LM's; and, reported only, the live stream decoded on the CPU. The
    CLIs run in this process: the RVQ kernel's launches of the flagship's
    tokenizer (C = 128) are counted."""
    import tempfile
    import torch
    from hilcodec_tpu_torch import entropy_code, infer, train_lm
    from hilcodec_tpu_torch.ops import rvq_kernel
    from hilcodec_tpu_torch.serve.entropy_live import (LiveTokenDecoder,
                                                       lm_stepper)
    from hilcodec_tpu_torch.train.lm import lm_inputs_from_tokens
    from hilcodec_tpu_torch.utils.bitstream import read_hilstream
    from hilcodec_tpu_torch.utils.checkpoint import save_checkpoint
    from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

    t0 = time.perf_counter()

    def done(part):
        log(f"[time] phase 13 {part} done at "
            f"{time.perf_counter() - t0:.1f} s into the phase")

    phase_coder()
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        _, _, state = train_setup("cuda", TRAIN_BATCH, SEED + 131)
        ckpt = save_checkpoint(os.path.join(tmp, "codec"), 1, state)
        del state
        torch.cuda.empty_cache()
        rng = np.random.default_rng(SEED + 132)
        for split, count, seconds in (("train", 8, 6), ("eval", 2, 4)):
            os.makedirs(os.path.join(tmp, "corpus", split))
            for i, w in enumerate(speech_batch(rng, count, seconds * 24000)):
                write_wav(os.path.join(tmp, "corpus", split, f"{i}.wav"),
                          w[0], 24000)
        done("set-up")

        lm_dir = os.path.join(tmp, "lm")
        rvq_kernel.reset_launches()
        text, dt = in_process(train_lm.main, [
            "-c", CONFIG, "--ckpt", ckpt, "--data",
            os.path.join(tmp, "corpus"), "--steps", str(LM_STEPS), "--out",
            lm_dir], tag="lm-train")
        launches += rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
        bits0 = float(re.search(r"step 0: held-out ([\d.]+)", text).group(1))
        final = float(re.search(r"FINAL: held-out ([\d.]+)", text).group(1))
        ms = re.findall(r"(\d+) ms/step", text)[-1]
        log(f"[lm-train] default LM ({LM_ARCH}) {LM_STEPS} steps at batch "
            f"32: held-out {bits0:.3f} -> {final:.3f} bits/token, {ms} "
            f"ms/step, {dt:.1f} s with tokenizing ({card})")
        if not final < bits0:
            raise AssertionError("train_lm: the held-out loss did not fall")
        lm_ckpt = os.path.join(lm_dir, f"{LM_STEPS:05d}.ckpt.npz")
        done("train_lm")

        wav = speech_batch(np.random.default_rng(SEED + 133), 1,
                           4 * 24000)[0, 0]
        inp = os.path.join(tmp, "in4.wav")
        write_wav(inp, wav, 24000)
        stream = os.path.join(tmp, "s.hilstream")
        base = ["-c", CONFIG, "--ckpt", ckpt, "--lm", lm_ckpt]
        rvq_kernel.reset_launches()
        text, dt_enc = in_process(entropy_code.main, base + [
            "-i", inp, "--out", stream], tag="entropy-code")
        launches += rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
        enc = json.loads(text.strip().splitlines()[-1])
        text, dt_dec = in_process(entropy_code.main, base + [
            "--decode", stream, "--out-wav", stream + ".wav"],
            tag="entropy-code")
        dec = json.loads(text.strip().splitlines()[-1])
        out_wav, _ = read_wav(stream + ".wav")
        meta, _ = read_hilstream(stream)
        log(f"[entropy-code] {enc['input_seconds']} s, {enc['tokens']} "
            f"tokens in {meta['n_seg']} segments: roundtrip_exact "
            f"{enc['roundtrip_exact']}, {enc['bits_per_token']} bits/token, "
            f"{enc['kbps_entropy_coded']} kbps against "
            f"{enc['kbps_fixed_rate']} fixed ({enc['saved_pct']}% saved); "
            f"encode + check {dt_enc:.1f} s, standalone decode "
            f"{dt_dec:.1f} s, CRC held, {len(out_wav)} samples ({card})")
        if not enc["roundtrip_exact"] or dec["tokens"] != enc["tokens"] \
                or len(out_wav) != meta["n_seg"] * LM_SEG * 320 \
                or not np.isfinite(out_wav).all():
            raise AssertionError(f"entropy_code: {enc} / {dec}")
        done("entropy_code")

        wav = speech_batch(np.random.default_rng(SEED + 134), 1,
                           TOOLS_SECONDS * 24000)[0, 0]
        inp = os.path.join(tmp, "in3.wav")
        write_wav(inp, wav, 24000)
        o = os.path.join(tmp, "live")
        rvq_kernel.reset_launches()
        text, dt = in_process(infer.main, [
            "-c", CONFIG, "--ckpt", ckpt, "-i", inp, "-o", o,
            "--entropy-stream", lm_ckpt, "--lm-arch", LM_ARCH],
            tag="entropy-live")
        launches += rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
        m = re.search(r"roundtrip_exact=(\w+)\s+([\d.]+) kbps .*fixed-rate "
                      r"([\d.]+) kbps", text)
        lat = re.search(r"coder latency: p50 ([\d.]+) ms\s+p99 ([\d.]+) ms",
                        text)
        lag = re.search(r"lag: mean ([\d.]+) frames \((\d+) ms\), max (\d+)",
                        text)
        log(f"[entropy-live] infer --entropy-stream on {TOOLS_SECONDS} s: "
            f"roundtrip_exact {m.group(1)}, {m.group(2)} kbps against "
            f"{m.group(3)} fixed; coder latency a frame p50 {lat.group(1)} "
            f"/ p99 {lat.group(2)} ms against 13.33 ms; decoder lag mean "
            f"{lag.group(1)} frames ({lag.group(2)} ms), max {lag.group(3)} "
            f"({card})")
        if m.group(1) != "True":
            raise AssertionError("the live roundtrip is not exact")
        done("live")

        # the live stepper against the batched LM on the same tokens
        frames = np.load(o + "_quantized.npy")[:, 0].T.astype(np.int64)
        lm, lm_params = entropy_code.load_lm(lm_ckpt, 8, 1024, 200, 8, 5,
                                             LM_SEG, "cuda")
        seg = frames[:LM_SEG]
        with torch.no_grad():
            batched = lm.apply(lm_params, lm_inputs_from_tokens(
                torch.from_numpy(seg.T[:, None]).cuda()))[0][0]
        batched = batched.cpu().numpy().astype(np.float64)
        run, st, off, prev, worst = lm_stepper(lm, lm_params), None, 0, \
            None, 0.0
        for i in range(LM_SEG):
            probs, st, off = run(prev, st, off)
            worst = max(worst, float(np.abs(probs - batched[..., i]).max()))
            prev = seg[i]
        log(f"[entropy-live] live stepper against the batched LM on the "
            f"card, {LM_SEG} frames: max abs probability difference "
            f"{worst:.3g} (bound {LM_STEP_TOL:g})")
        if not worst <= LM_STEP_TOL:
            raise AssertionError("the live stepper's probabilities depart "
                                 "from the batched LM's")

        # finding, not asserted: the card's live stream decoded on the CPU
        meta, blob = read_hilstream(o + ".hilstream")
        cpu_lm, cpu_params = entropy_code.load_lm(lm_ckpt, 8, 1024, 200, 8,
                                                  5, LM_SEG, "cpu")
        dec = LiveTokenDecoder(cpu_lm, cpu_params, seg_tokens=LM_SEG)
        dec.feed(blob, finished=True)
        try:
            got = np.stack(dec.pull_n(len(frames)))
            agree = (got == frames).all(1)
            first = int(np.argmin(agree)) if not agree.all() else None
            log(f"[entropy-cross] the card's live stream decoded by the "
                f"port on the CPU: {int(agree.sum())} of {len(frames)} "
                f"frames equal the card's tokens; first divergence at frame "
                f"{first} (reported, not required: decoding is promised on "
                f"the encoding device kind only)")
        except Exception as e:       # a finding, not a check of the port
            log(f"[entropy-cross] the CPU decode of the card's stream "
                f"raised {e!r} (reported, not required)")
    done("all")
    return dict(launches=launches)


# --------------------------------------------------------------- phase 14

# each HiFi-GAN family's adversarial and feature-matching losses take the
# weight the flagship's families have (configs/hilcodec_speech.yaml): the
# balancer combines only the keys it has weights for
HIFIGAN_WEIGHT = 1.1
# the card-against-CPU step's gradients applied by each optimizer
PHASE14_OPTIMIZERS = (
    ("AdamP", {"lr": 5e-4, "betas": [0.5, 0.9], "weight_decay": 1e-5}),
    ("SGDP", {"lr": 5e-4, "momentum": 0.9, "nesterov": True,
              "weight_decay": 1e-5}),
    ("RAdam", {"lr": 5e-4, "betas": [0.5, 0.9], "weight_decay": 1e-5}))
# bf16 losses against f32's from the same state and batch: the JAX
# package's own bar (tests/test_train_step.py)
BF16_LOSS_RTOL = 0.1


def phase14_configs(tmp):
    """Temporary yamls derived from configs/hilcodec_speech.yaml: the
    HiFi-GAN step (MPD and MSD at the JAX defaults, MelGradLoss), the same
    with configs/avocodo_music.yaml's SBD (its `h` form written out as the
    aggregate's SBD arguments), and the precision / memory modes."""
    import copy
    import yaml
    with open(CONFIG) as f:
        base = yaml.safe_load(f)
    with open(AVOCODO_CONFIG) as f:
        h = yaml.safe_load(f)["disc_kwargs"]["sbd_kwargs"]["h"]

    def with_families(cfg, kwargs):
        cfg = copy.deepcopy(cfg)
        for name, kw in kwargs.items():
            cfg["disc_kwargs"][f"{name}_kwargs"] = kw
            for key in (f"{name}_g", f"{name}_fm"):
                cfg["train"]["balancer_kwargs"]["weights"][key] = \
                    HIFIGAN_WEIGHT
        return cfg

    def pqmf(v):
        return dict(zip(("subbands", "taps", "cutoff_freq", "beta"), v))

    hifigan = with_families(base, {"mpd": {"use": True},
                                   "msd": {"use": True}})
    hifigan["train"]["mel_grad_function"] = True
    sbd = with_families(hifigan, {"sbd": {
        "use": True, "channels": h["sbd_filters"],
        "strides": h["sbd_strides"], "kernel_sizes": h["sbd_kernel_sizes"],
        "dilations": h["sbd_dilations"],
        "band_ranges": h["sbd_band_ranges"],
        "transpose": h["sbd_transpose"],
        "pqmf_kwargs": pqmf(h["pqmf_config"]["sbd"]),
        "f_pqmf_kwargs": pqmf(h["pqmf_config"]["fsbd"]),
        "segment_size": h["segment_size"]}})
    modes = {"bf16": {"compute_dtype": "bfloat16"},
             "remat": {"remat": "all"},
             "bf16+remat": {"compute_dtype": "bfloat16", "remat": "all"}}
    out = {"hifigan": hifigan, "hifigan+sbd": sbd}
    for name, train in modes.items():
        out[name] = copy.deepcopy(base)
        out[name]["train"].update(train)
    paths = {}
    for name, cfg in out.items():
        paths[name] = os.path.join(tmp, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    return paths


def phase_hifigan(card, paths):
    """(a) MPD + MSD (+ SBD) with MelGradLoss in the flagship trainer: one
    step on the card against the CPU at batch 2, its gradients applied by
    AdamP, SGDP and RAdam; then the HiFi-GAN step timed at batch 24."""
    import torch
    phase_train_parity(paths["hifigan+sbd"], tag="hifigan-parity",
                       optimizers=PHASE14_OPTIMIZERS)
    trainer, state, res = phase_train_full(card, paths["hifigan"],
                                           tag="hifigan-train")
    log(f"[hifigan-train] discriminators {list(trainer.disc.discs)}, mel "
        f"loss {type(trainer.mel_loss).__name__}; f32 at batch "
        f"{TRAIN_BATCH} {'fits' if res['peak'] < 80e9 else 'does not fit'}"
        f" in the card's memory ({res['peak'] / 2**30:.2f} GiB peak of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f})")
    del trainer, state
    torch.cuda.empty_cache()
    return res


def _all_f32(state, what):
    """Every floating leaf of the masters, the optimizer states, the VQ
    state and the balancer in f32 and finite."""
    import torch
    from hilcodec_tpu_torch.utils.params import flatten
    for part in ("params_g", "params_d", "opt_g", "opt_d", "vq_state",
                 "balancer"):
        for k, v in flatten(getattr(state, part)).items():
            if v.is_floating_point() and (v.dtype != torch.float32
                                          or not bool(v.isfinite().all())):
                raise AssertionError(f"{what}: {part}/{k} is {v.dtype} "
                                     f"or not finite")


def phase_bf16_tokens(trainer, state, depths=(2, 4, 8)):
    """The bf16 encoder's latents, cast to f32 as the training forward
    casts them, through the RVQ kernel and the plain cascade at M = 1800:
    the same tokens."""
    import torch
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel

    wav = speech_batch(np.random.default_rng(SEED + 60), TRAIN_BATCH,
                       TRAIN_SEGMENT)
    books = state.vq_state["embed"]
    with torch.no_grad():
        z = trainer.model.codec.encoder.apply(
            trainer._cast(state.params_g["encoder"]),
            torch.from_numpy(wav).cuda().to(torch.bfloat16))
        if z.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 encoder returned {z.dtype}")
        x = z.float().transpose(1, 2).contiguous()
        for n in depths:
            rep = rvq.token_parity_report(
                rvq_kernel.quantize_cuda(x, books, n),
                rvq.quantize(x, books, n), x, books)
            log(f"[bf16-tokens] encoder in {z.dtype}, latents cast to "
                f"{x.dtype}, M={x.shape[0] * x.shape[1]} n={n}: mismatches "
                f"{rep['mismatches']} (ties {rep['ties']}, not ties "
                f"{rep['not_ties']})")
            if rep["mismatches"]:
                raise AssertionError(f"bf16 path tokens differ at n={n}: "
                                     f"{rep}")


def phase_precision(card, paths, f32):
    """(b) The flagship in bf16, with remat all, and both, timed at batch
    24 beside phase 7(a)'s f32 numbers (`f32`) from this run; bf16 losses
    against f32's from one state and batch; remat's gradients against
    none's; K1's tokens on the bf16 path."""
    import torch
    from hilcodec_tpu_torch.train import step as step_module
    from hilcodec_tpu_torch.train.loop import step_generator
    from hilcodec_tpu_torch.train.step import to_device
    from hilcodec_tpu_torch.utils.params import flatten

    rows = {"f32 (phase 7a)": f32}
    # bf16 runs the shapes of its f32 counterpart: its FLOPs are not
    # counted again
    same_shapes = {"bf16": "f32 (phase 7a)", "bf16+remat": "remat"}
    for mode in ("bf16", "remat", "bf16+remat"):
        twin = same_shapes.get(mode)
        trainer, state, res = phase_train_full(
            card, paths[mode], tag=f"{mode}-train",
            rvq_per_step=2 if "remat" in mode else 1,
            flops_of=(twin, rows[twin]) if twin else None)
        _all_f32(state, mode)
        if mode == "bf16":
            phase_bf16_tokens(trainer, state)
        rows[mode] = res
        del trainer, state
        torch.cuda.empty_cache()

    # one state and batch through f32, bf16 and remat: all
    _, trainer, state = train_setup("cuda", TRAIN_BATCH, SEED + 70)
    wav = to_device(speech_batch(np.random.default_rng(SEED + 71),
                                 TRAIN_BATCH, TRAIN_SEGMENT), trainer.device)
    draws = trainer.sample_draws(step_generator(SEED, 7), wav.shape)
    ref = trainer.compute_grads(state, wav, draws)
    # the dtypes the discriminators' logits and feature maps come out in,
    # before the step casts them back to f32 for the losses
    seen, to_f32 = set(), step_module._f32

    def recording(tree):
        seen.update(v.dtype for v in flatten(tree).values())
        return to_f32(tree)
    step_module._f32 = recording
    try:
        half = dataclasses.replace(trainer, compute_dtype=torch.bfloat16
                                   ).compute_grads(state, wav, draws)
    finally:
        step_module._f32 = to_f32
    log(f"[precision] bf16 step: discriminator logits and feature maps "
        f"in {sorted(map(str, seen))}")
    if seen != {torch.bfloat16}:
        raise AssertionError(f"bf16 discriminators gave {seen}")
    gaps = {k: _rel(half["losses"][k], v) for k, v in ref["losses"].items()}
    log(f"[precision] bf16 against f32, same state, batch {TRAIN_BATCH} and "
        f"draws (depth {draws.n}): loss relative gaps " + ", ".join(
            f"{k} {v:.3g}" for k, v in gaps.items())
        + f" (bar {BF16_LOSS_RTOL}); d_loss {float(half['d_loss']):.5g} "
        f"against {float(ref['d_loss']):.5g}")
    bad = {k: v for k, v in gaps.items() if not v <= BF16_LOSS_RTOL}
    if bad or not bool(half["finite"]):
        raise AssertionError(f"bf16 losses off f32's by {bad} or non-"
                             f"finite balancer")
    del half
    remat = dataclasses.replace(trainer, remat="all").compute_grads(
        state, wav, draws)
    for side in ("g_grads", "d_grads"):
        fa, fb = flatten(remat[side]), flatten(ref[side])
        floor = GRAD_FLOOR_REL * float(torch.sqrt(sum(
            torch.sum(v.double() ** 2) for v in fb.values())))
        worst = max((_rel_l2(fa[k], fb[k], floor), k) for k in fb)
        log(f"[precision] remat all against none, {side}: worst per-leaf "
            f"rel L2 {worst[0]:.2g} ({worst[1]}; floor {GRAD_FLOOR_REL} of "
            f"the global norm), bar {GRAD_RTOL}")
        if worst[0] > GRAD_RTOL:
            raise AssertionError(f"remat gradients differ: {worst}")
    del trainer, state, ref, remat
    torch.cuda.empty_cache()
    log(f"[precision] {card}, batch {TRAIN_BATCH} x {TRAIN_SEGMENT}:")
    for mode, r in rows.items():
        top = r["top"][0] if r["top"] else ("none", 0.0)
        log(f"[precision]   {mode}: step p50 / p90 {r['p50']:.1f} / "
            f"{r['p90']:.1f} ms, {r['audio_s']:.1f} audio s/s, peak "
            f"{r['peak'] / 2**30:.2f} GiB, busy {r['busy'] * 100:.0f}%, "
            f"{r['kernels']:.0f} kernels a step, bound {r['bound_ms']:.1f} "
            f"ms, RVQ launches {r['launches']}; top kernel {top[0]} "
            f"{top[1]:.1f} ms a step")
    return rows


def phase_train_options(card, f32):
    """Phase 14: the HiFi-GAN discriminators and the precision and memory
    modes of the flagship trainer."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = phase14_configs(tmp)
        hifigan = phase_hifigan(card, paths)
        log(f"[time] phase 14 (a) done at "
            f"{time.perf_counter() - t0:.1f} s into the phase")
        rows = phase_precision(card, paths, f32)
    return dict(hifigan=hifigan, **rows)


# --------------------------------------------------------------- phase 15

PRECISIONS = ("bf16w", "bf16")
BF16_FRAME_BATCHES = (1, SERVE_SLOTS, PATH_STREAMS)
OPTION_STREAMS = (SERVE_SLOTS, PATH_STREAMS)
# a frame kernel against its plain version of the same dtype: at most one
# bf16 spacing at each tensor's largest magnitude (both compute in f32 and
# round where a cache or the output is stored; sums in another order may
# round a value the other way)
BF16_KERNEL_SPACINGS = 1.0
# the frame-kernel path against the plain frame step of the same dtype, 75
# frames: the latents within LATENT_SPACINGS bf16 spacings (the kernel
# rounds only where it stores, the plain bf16 step after every op), the
# PCM on the same tokens within PATH_PCM_SPACINGS; the path's tokens are
# the plain cascade's of its own latents (exact or f32 ties), and where
# they differ from the plain step's, each first divergence's two
# codewords lie within BF16_TIE_REL of each other in relative distance
# from the plain step's latents (bf16's spacing at 1: two sets of bf16
# latents that round at different points differ by about that)
LATENT_SPACINGS = 32
PATH_PCM_SPACINGS = 64
BF16_TIE_REL = 2.0 ** -7
EXPORT_STREAMS = SERVE_SLOTS
BENCH15_SECONDS = "0.5"      # 37 frames a bench run, for the run's time
OPTION_TRAIN_BATCH = 2


def spacings(got, ref):
    """max |got - ref| in units of bf16's spacing at ref's largest
    magnitude (2^(floor(log2 max|ref|) - 7))."""
    got, ref = got.float(), ref.float()
    top = float(ref.abs().max())
    if top == 0.0:
        return float((got - ref).abs().max())
    return float((got - ref).abs().max()) / 2.0 ** (np.floor(np.log2(top))
                                                    - 7)


def _cast_mode(params, mode):
    import torch
    from hilcodec_tpu_torch.models.codec import cast_streaming_params
    act = torch.bfloat16 if mode == "bf16" else torch.float32
    return cast_streaming_params(params, torch.bfloat16,
                                 kernels_only=mode == "bf16w"), act


def phase_frame_bf16(model, params, vq_state):
    """K3 and K4 at --dtype bf16w and bf16 on the flagship: against their
    plain version of the same dtype at 1, 16 and 128 streams (3 frames,
    caches threaded through the plain version's), timed at 16 and 128
    beside the plain version and a bound (`frame_bound_ms` of bf16
    weights); then the frame-kernel path (encode_stream /
    decode_stream(megakernel=True)) at 16 streams x 75 frames against the
    plain frame step of the same dtype: tokens, PCM, launches, the latents
    from the encoder frame kernel's steps run again (their tokens equal to
    the entry point's). Returns {(kernel, mode): entry fields}."""
    import torch
    from hilcodec_tpu_torch.models.codec import _encoder_megakernel
    from hilcodec_tpu_torch.ops import decoder_kernel as DK
    from hilcodec_tpu_torch.ops import encoder_kernel as EK
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel

    out = {}
    for mode in PRECISIONS:
        p, act = _cast_mode(params, mode)
        gen = torch.Generator().manual_seed(SEED + 15)
        for B in BF16_FRAME_BATCHES:
            for name, mk, pp, inputs, cache, frame in frame_cases(
                    model, p, B, gen, act):
                w = mk.weights(pp)
                worst = abs_err = 0.0
                for _ in range(3):
                    x, aux, lc, ring = inputs(cache, frame())
                    y, got = mk.run(pp, x, aux, lc)
                    torch.cuda.synchronize()
                    y_ref, ref = DK.run_plain(mk.ops, w.per_op, x, aux, lc)
                    for a, b in zip([y] + got, [y_ref] + ref):
                        if (a.dtype != b.dtype or a.shape != b.shape
                                or not torch.isfinite(a.float()).all()):
                            raise AssertionError(f"{name} {mode} B={B}: bad "
                                                 f"output or dtype")
                        worst = max(worst, spacings(a, b))
                        abs_err = max(abs_err, float(
                            (a.float() - b.float()).abs().max()))
                    cache = ref if ring is None else [ring] + ref
                log(f"[bf16-kernel] {name} --dtype {mode} B={B} x3 frames: "
                    f"output {y.dtype}, caches {got[0].dtype}; max diff from "
                    f"the plain version {worst:.3f} bf16 spacings (bar "
                    f"{BF16_KERNEL_SPACINGS})")
                if worst > BF16_KERNEL_SPACINGS:
                    raise AssertionError(f"{name} --dtype {mode} disagrees "
                                         f"with its plain version at B={B}")
                entry = out.setdefault((name, mode), {"max_spacings": 0.0,
                                                      "max_abs_err": 0.0})
                entry["max_spacings"] = max(entry["max_spacings"], worst)
                entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
                if B in OPTION_STREAMS:
                    ms = cuda_ms(lambda: mk.run(pp, x, aux, lc), repeats=20)
                    plain = cuda_ms(lambda: DK.run_plain(
                        mk.ops, w.per_op, x, aux, lc), repeats=10)
                    bounds, _, _ = frame_bound_ms(mk, w, x, aux, lc,
                                                  bf16_weights=True)
                    entry[B] = (ms, plain, bounds["tc"])
                    log(f"[bf16-kernel] {name} --dtype {mode} B={B}: "
                        f"{ms:.4f} ms a launch, plain {plain:.4f} ms, "
                        f"bound {bounds['tc'][0]:.4f} ms "
                        f"({bounds['tc'][1]}; bf16 bytes where stored "
                        f"bf16, the 1x1 products at the cost of an "
                        f"f32-accurate product of bf16 weights)")
        # the frame-kernel path against the plain frame step, same dtype:
        # encode_stream / decode_stream(megakernel=True), then, for the
        # latents, the encoder frame kernel's steps again on the same
        # inputs (their tokens must be the entry point's)
        hop, books = model.hop_length, vq_state["embed"]
        B = SERVE_SLOTS
        wav = torch.from_numpy(np.stack([
            client_audio(i, hop).astype(np.float32) / 32768.0
            for i in range(B)])[:, None]).to(model.device, act)
        ce, cd = model.init_cache(B, act)
        em = _encoder_megakernel(model.codec.encoder)
        with torch.no_grad():
            DK.reset_launches()
            EK.reset_launches()
            rvq_kernel.reset_launches()
            tok, _ = model.encode_stream(p, vq_state, wav, ce,
                                         megakernel=True)
            y, _ = model.decode_stream(p, vq_state, tok, cd, megakernel=True)
            torch.cuda.synchronize()
            launches = {DK.KERNEL: DK.LAUNCHES[DK.KERNEL],
                        EK.KERNEL: EK.LAUNCHES[EK.KERNEL],
                        rvq_kernel.KERNEL:
                            rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]}
            cache, zk, toks = em.cache_to_time_major(ce), [], []
            for f in range(CLIENT_FRAMES):
                z, cache = em.step(p["encoder"], cache,
                                   wav[:, :, f * hop:(f + 1) * hop])
                zk.append(z.float())
                toks.append(rvq_kernel.quantize(z.transpose(1, 2).float(),
                                                books))
            if not torch.equal(torch.cat(toks, -1), tok):
                raise AssertionError(f"--dtype {mode}: encode_stream("
                                     f"megakernel=True) gives other tokens "
                                     f"than its frame kernel's steps")
            cache, zr = ce, []
            for f in range(CLIENT_FRAMES):
                z, cache = model.codec.encoder.step(
                    p["encoder"], cache, wav[:, :, f * hop:(f + 1) * hop])
                zr.append(z.float())
            y_ref, _ = model.decode_stream(p, vq_state, tok, cd)
        zk = torch.cat(zk, -1).transpose(1, 2).cpu()
        zr = torch.cat(zr, -1).transpose(1, 2).cpu()
        own = rvq.token_parity_report(tok, rvq.quantize(zk, books.cpu()), zk,
                                      books)
        plain = rvq.token_parity_report(tok, rvq.quantize(zr, books.cpu()),
                                        zr, books, tie_rel=BF16_TIE_REL)
        lat, pcm = spacings(zk, zr), spacings(y, y_ref)
        log(f"[bf16-path] --dtype {mode}: encode_stream / decode_stream("
            f"megakernel=True) {B} streams x {CLIENT_FRAMES} frames, "
            f"launches {launches}; tokens equal to those of the encoder "
            f"frame kernel's steps run again; latents "
            f"{lat:.2f} bf16 spacings from the plain {act} frame step's "
            f"(bar {LATENT_SPACINGS}); tokens against the plain cascade of "
            f"the path's own latents: mismatches {own['mismatches']} (ties "
            f"{own['ties']}, not ties {own['not_ties']}); against the plain "
            f"step's tokens: mismatches {plain['mismatches']} of "
            f"{tok.numel()} (rate {plain['rate']:.2e}), first divergences "
            f"inside bf16 noise {plain['ties']}, outside "
            f"{plain['not_ties']} (worst relative distance gap "
            f"{plain['worst_rel_gap']:.2e}, bar {BF16_TIE_REL:.2e}); PCM on "
            f"the same tokens {pcm:.2f} bf16 spacings (bar "
            f"{PATH_PCM_SPACINGS})")
        if (any(v != CLIENT_FRAMES for v in launches.values())
                or not own["ok"] or plain["not_ties"]
                or lat > LATENT_SPACINGS
                or pcm > PATH_PCM_SPACINGS
                or not torch.isfinite(y.float()).all()):
            raise AssertionError(f"--dtype {mode} frame-kernel path: "
                                 f"{launches} {own} {plain} latents {lat} "
                                 f"PCM {pcm}")
        for name in (DK.KERNEL, EK.KERNEL):
            out[(name, mode)]["launches"] = launches[name]
    return out


def phase_bench_precision():
    """The bench at 16 and 128 streams, BENCH15_SECONDS of audio, in this
    process: the flagship plain and --megakernel, and --model audiodec,
    each at --dtype f32, bf16w and bf16 (one turn each, for the run's
    time)."""
    from hilcodec_tpu_torch import bench
    runs = []
    for streams in OPTION_STREAMS:
        base = [str(streams), "--seconds", BENCH15_SECONDS]
        for extra in ([], ["--megakernel"], ["--model", "audiodec"]):
            for dtype in ("f32",) + PRECISIONS:
                runs.append(base + ["--dtype", dtype] + extra)
    for argv in runs:
        log(f"[bench-precision] python -m hilcodec_tpu_torch.bench "
            f"{' '.join(argv)}: {json.dumps(bench.run(argv))}")


def tick_ms(model, params, vq_state, slots, dtype, rng):
    """Engine tick p50 / p99 (ms) over TIMED_TICKS ticks, every slot
    active, at `dtype`, and the engine."""
    from hilcodec_tpu_torch.serve import SlotEngine
    engine = SlotEngine(model, params, vq_state, slots=slots,
                        mode="roundtrip", fold=False, dtype=dtype,
                        devices=[model.device])
    engine.warmup()
    for _ in range(slots):
        engine.attach()
    hop, times = model.hop_length, []
    for t in range(TIMED_TICKS + 5):
        for s in range(slots):
            engine.submit(s, (rng.standard_normal(hop) * 3000).astype(
                np.int16))
        t0 = time.perf_counter()
        engine.tick()
        if t >= 5:
            times.append(time.perf_counter() - t0)
    return (float(np.percentile(times, 50)) * 1e3,
            float(np.percentile(times, 99)) * 1e3), engine


def phase_ticks_bf16(builds, card):
    """Engine ticks at 16 and 128 slots for each model of `builds` at
    dtype bfloat16 beside float32, in turns (f32, bf16) in this run; at
    128 slots each then under torch.profiler for 10 ticks."""
    import torch
    rng = np.random.default_rng(SEED + 15)
    for tag, (model, params, vq_state) in builds.items():
        frame_ms = model.hop_length / 24.0
        for slots in OPTION_STREAMS:
            res = {}
            for d in (torch.float32, torch.bfloat16):
                name = str(d).split(".")[-1]
                res[name], engine = tick_ms(model, params, vq_state, slots,
                                            d, rng)
                if slots == PATH_STREAMS:
                    profile_ticks(engine, slots, res[name][0] / 1e3, rng,
                                  tag=f"bf16-ticks {tag} {name}")
                del engine
            log(f"[bf16-ticks] {tag} {slots} slots: " + "; ".join(
                f"{d} tick p50 {a:.2f} ms, p99 {b:.2f} ms"
                for d, (a, b) in res.items())
                + f" (frame {frame_ms:.2f} ms; {card})")


def write_variant_config(tmp, name, base, **kw):
    """A temporary yaml: `base`'s config with model_kwargs updated."""
    import yaml
    with open(base) as f:
        cfg = yaml.safe_load(f)
    cfg["model_kwargs"].update(kw)
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_option_variant(tmp):
    """The flagship at full width with weight standardization, the
    learnable STFT in the encoder and channelwise skip scales: a 16-slot
    engine serves 16 streams x 75 ticks (one RVQ launch a tick), tokens
    exact or f32 ties against the port's CPU frame loop on the same
    weights; two finite train steps at batch 2; then the frame kernels on
    the weight-standardized flagship (identity skips, fixed STFT)."""
    import torch
    from hilcodec_tpu_torch.models.registry import build_codec_model
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel
    from hilcodec_tpu_torch.serve import SlotEngine
    from hilcodec_tpu_torch.train.loop import step_generator
    from hilcodec_tpu_torch.train.step import metrics_to_host, to_device
    from hilcodec_tpu_torch.utils.hparams import load_config

    cfg = write_variant_config(tmp, "variant", CONFIG,
                               norm="weight_standardization",
                               spec_learnable=True, skip="channelwise_scale")
    model, params, vq_state, _ = build_flagship("cuda", cfg)
    hop, B = model.hop_length, SERVE_SLOTS
    engine = SlotEngine(model, params, vq_state, slots=B, fold=False,
                        devices=[model.device])
    pcm = np.stack([client_audio(i, hop) for i in range(B)])
    slots = [engine.attach() for _ in range(B)]
    rvq_kernel.reset_launches()
    toks = []
    for f in range(CLIENT_FRAMES):
        for s in slots:
            engine.submit(s, pcm[s, f * hop:(f + 1) * hop])
        res = engine.tick()
        toks.append(np.stack([res[s]["tokens"] for s in slots],
                             1)[..., None])
    launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
    tok = torch.from_numpy(np.concatenate(toks, -1).astype(np.int64))
    hps = load_config(cfg)
    cpu = build_codec_model(hps.model, hps.model_kwargs.to_dict(),
                            device="cpu")
    pc, vc = cpu.to_device(params, vq_state)
    wav = torch.from_numpy(pcm.astype(np.float32) / 32768.0)[:, None]
    cache, zs = cpu.init_cache(B)[0], []
    with torch.no_grad():
        for f in range(CLIENT_FRAMES):
            z, cache = cpu.codec.encoder.step(
                pc["encoder"], cache, wav[:, :, f * hop:(f + 1) * hop])
            zs.append(z)
        z = torch.cat(zs, -1).transpose(1, 2)
        ref = rvq.quantize(z, vc["embed"])
    rep = rvq.token_parity_report(tok, ref, z, vc["embed"])
    log(f"[variant] weight_standardization + spec_learnable + "
        f"channelwise_scale, full width: {B} slots x {CLIENT_FRAMES} ticks, "
        f"rvq_cascade launches {launches}; tokens against the CPU frame "
        f"loop: mismatches {rep['mismatches']} (ties {rep['ties']}, not "
        f"ties {rep['not_ties']})")
    if not rep["ok"] or launches != CLIENT_FRAMES:
        raise AssertionError(f"option variant serving: {rep}, {launches}")
    del engine, cpu
    _, trainer, state = train_setup("cuda", OPTION_TRAIN_BATCH, SEED + 15,
                                    config=cfg)
    rng = np.random.default_rng(SEED + 16)
    host = []
    for i in range(2):
        w = to_device(speech_batch(rng, OPTION_TRAIN_BATCH, TRAIN_SEGMENT),
                      trainer.device)
        state, m = trainer.train_step(
            state, w, trainer.sample_draws(step_generator(SEED + 15, i),
                                           w.shape))
        host.append(metrics_to_host(m))
    bad = [(i, k) for i, h in enumerate(host) for k, v in h.items()
           if k != "num_replaces" and not np.all(np.isfinite(v))]
    log(f"[variant-train] 2 steps at batch {OPTION_TRAIN_BATCH}: " + "; ".join(
        ", ".join(f"{k} {v:.4g}" for k, v in h.items()
                  if k.startswith("loss/")) for h in host))
    if bad:
        raise AssertionError(f"option variant training: non-finite {bad}")
    del trainer, state
    torch.cuda.empty_cache()
    ws = write_variant_config(tmp, "ws", CONFIG,
                              norm="weight_standardization")
    wmodel, wparams, _, _ = build_flagship("cuda", ws)
    phase_frame_kernels(wmodel, wparams, batches=(SERVE_SLOTS,),
                        tag=" (weight standardization)")


def phase_export_program(model, params, vq_state, tmp):
    """`export --program`'s programs on the card at 16 streams: saved,
    loaded back and stepped for 75 frames; tokens equal to the eager
    step's, and the RVQ kernel launched by the program once a frame."""
    import torch
    from hilcodec_tpu_torch.export import export_programs
    from hilcodec_tpu_torch.ops import rvq_kernel

    B, hop = EXPORT_STREAMS, model.hop_length
    t0 = time.perf_counter()
    written = export_programs(model, params, vq_state,
                              os.path.join(tmp, "prog"), streams=B)
    t_export = time.perf_counter() - t0
    enc = torch.export.load(os.path.join(tmp, "prog_enc.pt2")).module()
    dec = torch.export.load(os.path.join(tmp, "prog_dec.pt2")).module()
    wav = torch.from_numpy(np.stack([
        client_audio(i, hop).astype(np.float32) / 32768.0
        for i in range(B)])[:, None]).to(model.device)
    ce, cd = model.init_cache(B)
    pe, pd = list(ce), list(cd)
    toks, ref = [], []
    with torch.no_grad():
        rvq_kernel.reset_launches()
        for f in range(CLIENT_FRAMES):
            out = enc(wav[:, :, f * hop:(f + 1) * hop], *pe)
            toks.append(out[0])
            pe = list(out[1:])
            out = dec(out[0], *pd)
            pd = list(out[1:])
        torch.cuda.synchronize()
        launches = rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
        for f in range(CLIENT_FRAMES):
            t, ce = model.encode_stream(params, vq_state,
                                        wav[:, :, f * hop:(f + 1) * hop], ce)
            ref.append(t)
    same = torch.equal(torch.cat(toks, -1), torch.cat(ref, -1))
    log(f"[export] --program at {B} streams: "
        + ", ".join(f"{os.path.basename(k)} {v / 1e6:.1f} MB"
                    for k, v in written.items())
        + f", traced and saved in {t_export:.1f} s; loaded back, "
        f"{CLIENT_FRAMES} dispatches of each: tokens "
        f"{'equal to' if same else 'DIFFER from'} the eager step's, "
        f"rvq_cascade launched {launches} times by the program, the "
        f"decoder's output finite {bool(torch.isfinite(out[0]).all())}")
    if not same or launches != CLIENT_FRAMES or not torch.isfinite(
            out[0]).all():
        raise AssertionError("the exported program disagrees with the "
                             "eager step or did not launch the RVQ kernel")
    return launches


def phase_encodec_pads(tmp):
    """EnCodec at full width with pad_mode edge and wrap: one offline
    encode and decode of 2 x 1 s on the card, finite, tokens exact or f32
    ties against the port's CPU run on the same weights."""
    import torch
    from hilcodec_tpu_torch.models.registry import build_codec_model
    from hilcodec_tpu_torch.ops import rvq
    from hilcodec_tpu_torch.utils.hparams import load_config

    for mode in ("edge", "wrap"):
        cfg = write_variant_config(tmp, f"encodec_{mode}", ENCODEC_CONFIG,
                                   pad_mode=mode)
        model, params, vq_state, _ = build_flagship("cuda", cfg)
        hps = load_config(cfg)
        cpu = build_codec_model(hps.model, hps.model_kwargs.to_dict(),
                                device="cpu")
        pc, vc = cpu.to_device(params, vq_state)
        wav = torch.from_numpy(np.stack([
            client_audio(i, model.hop_length) for i in range(2)]
            ).astype(np.float32)[:, None] / 32768.0)
        with torch.no_grad():
            tok = model.encode(params, vq_state, wav.to(model.device))
            y = model.decode(params, vq_state, tok)
            z = cpu.codec.encoder.apply(pc["encoder"], wav).transpose(1, 2)
            ref = rvq.quantize(z, vc["embed"])
        rep = rvq.token_parity_report(tok, ref, z, vc["embed"])
        ok = rep["ok"] and bool(torch.isfinite(y).all())
        log(f"[encodec-pad] pad_mode {mode}: offline encode / decode of "
            f"2 x {CLIENT_FRAMES} frames on the card, output finite "
            f"{bool(torch.isfinite(y).all())}; tokens against the CPU: "
            f"mismatches {rep['mismatches']} (ties {rep['ties']}, not "
            f"ties {rep['not_ties']})")
        if not ok:
            raise AssertionError(f"EnCodec pad_mode {mode}: {rep}")


def phase_options(card):
    """Phase 15: the serving path's precision and model options."""
    import tempfile
    import torch
    from hilcodec_tpu_torch import bench

    t0 = time.perf_counter()

    def done(part):
        log(f"[time] phase 15 {part} done at "
            f"{time.perf_counter() - t0:.1f} s into the phase")

    model, params, vq_state, _ = build_flagship("cuda")
    frames = phase_frame_bf16(model, params, vq_state)
    done("bf16 frame kernels")
    with tempfile.TemporaryDirectory() as tmp:
        export_launches = phase_export_program(model, params, vq_state, tmp)
        done("export")
        phase_bench_precision()
        done("bench")
        ad = bench.build_audiodec_bench_model(torch.device("cuda"))
        phase_ticks_bf16({"flagship": (model, params, vq_state),
                          "audiodec": (ad, *bench.bench_params(ad))}, card)
        done("ticks")
        del model, params, vq_state, ad
        torch.cuda.empty_cache()
        phase_option_variant(tmp)
        done("variant")
        phase_encodec_pads(tmp)
        done("encodec pads")
    return {"frames": frames, "export_launches": export_launches}


# --------------------------------------------------------------- phase 16

DP_WARMUP = 2
DP_TIMED = 5
# the host I/O corpus: seeded speech WAVs of 1.5 s, read in segments of
# TRAIN_SEGMENT at TRAIN_BATCH a batch
HOST_FILES = 24
HOST_FILE_SAMPLES = 36000
HOST_BATCHES = 20
LOADER_BATCHES = 8
SHARD_SLOTS = (SERVE_SLOTS, PATH_STREAMS)
# the sharded engine and `bench --mesh` on the one card: two shards on it,
# so the slot split, the per-shard caches and the concatenation run
SHARD_PAIR = ["cuda:0", "cuda:0"]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_corpus(tmp):
    """(c) HOST_FILES seeded speech WAVs under {tmp}/wavs, and their
    `DatasetPreprocessed` dump under {tmp}/feats (`{name}_wav.npy` of the
    WAV as read back, `{name}_pitch.npy` from extract_pitch at the
    config's data.hop_size) with the filelist {tmp}/feats.txt. Returns
    (the WAV paths, extract_pitch's ms per audio second)."""
    from hilcodec_tpu_torch.data.datasets import extract_pitch
    from hilcodec_tpu_torch.utils.hparams import load_config
    from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

    hop = load_config(CONFIG).data.hop_size
    rng = np.random.default_rng(SEED + 160)
    for sub in ("wavs", "feats"):
        os.makedirs(os.path.join(tmp, sub))
    paths, names, pitch_s = [], [], 0.0
    for i in range(HOST_FILES):
        name = f"s{i:02d}"
        path = os.path.join(tmp, "wavs", f"{name}.wav")
        write_wav(path, speech_batch(rng, 1, HOST_FILE_SAMPLES)[0, 0], 24000)
        wav, _ = read_wav(path)
        t0 = time.perf_counter()
        pitch, voiced = extract_pitch(wav, 24000, hop)
        pitch_s += time.perf_counter() - t0
        if len(pitch) != len(wav) // hop + 1 or not np.isfinite(pitch).all():
            raise AssertionError(f"extract_pitch of {name}: {pitch.shape}")
        np.save(os.path.join(tmp, "feats", f"{name}_wav.npy"), wav)
        np.save(os.path.join(tmp, "feats", f"{name}_pitch.npy"), pitch)
        paths.append(path)
        names.append(name)
    with open(os.path.join(tmp, "feats.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    audio_s = HOST_FILES * HOST_FILE_SAMPLES / 24000
    return paths, pitch_s * 1e3 / audio_s


def loader_config(tmp, dataset):
    """configs/hilcodec_speech.yaml with its train set on {tmp}'s corpus:
    `DirectoriesDataset` over {tmp}/wavs or `DatasetPreprocessed` over
    {tmp}/feats (one batch of TRAIN_BATCH an epoch)."""
    from hilcodec_tpu_torch.utils.hparams import load_config
    hps = load_config(CONFIG)
    data = hps.data
    data.dataset.train = dataset
    data.classes.clean.directories_to_include = [os.path.join(tmp, "wavs")]
    data.length = TRAIN_BATCH * LOADER_BATCHES
    data.data_dir = os.path.join(tmp, "feats")
    data.filelists.train = os.path.join(tmp, "feats.txt")
    return hps


def phase_host_io(tmp, paths, pitch_ms, card):
    """(c) Host numbers on the card's machine's CPU: the native reader's
    read_batch of TRAIN_BATCH x TRAIN_SEGMENT segments against the stdlib
    reader on the same segments (equal arrays), ms p50 over HOST_BATCHES
    batches; the loader's batches a second at TRAIN_BATCH with
    DirectoriesDataset and with DatasetPreprocessed; extract_pitch's ms
    per audio second; the files each reader read."""
    from hilcodec_tpu_torch.data import datasets as DS
    from hilcodec_tpu_torch.data import native
    from hilcodec_tpu_torch.data.loader import get_dataset_dataloader
    from hilcodec_tpu_torch.utils import wavio

    rng = np.random.default_rng(SEED + 161)
    native.read_batch(paths[:1], [0], 16)                  # builds it
    nat, std = [], []
    for _ in range(HOST_BATCHES):
        pick = rng.integers(0, len(paths), TRAIN_BATCH)
        starts = rng.integers(0, HOST_FILE_SAMPLES - TRAIN_SEGMENT,
                              TRAIN_BATCH)
        files = [paths[i] for i in pick]
        t0 = time.perf_counter()
        a = native.read_batch(files, starts, TRAIN_SEGMENT)
        nat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        b = np.stack([wavio.read_wav(p, int(s), TRAIN_SEGMENT)[0]
                      for p, s in zip(files, starts)])
        std.append(time.perf_counter() - t0)
        if not np.array_equal(a, b):
            raise AssertionError("native read_batch differs from the "
                                 "stdlib reader")
    log(f"[host-io] read_batch of {TRAIN_BATCH} x {TRAIN_SEGMENT} samples "
        f"(host numbers, this machine's CPU; {card}): native ms p50 "
        f"{np.percentile(nat, 50) * 1e3:.3f}, stdlib ms p50 "
        f"{np.percentile(std, 50) * 1e3:.3f} over {HOST_BATCHES} batches "
        f"({np.percentile(std, 50) / np.percentile(nat, 50):.1f}x); arrays "
        f"equal")
    for k in DS.READS:
        DS.READS[k] = 0
    rates = {}
    for dataset in ("DirectoriesDataset", "DatasetPreprocessed"):
        _, loader = get_dataset_dataloader(loader_config(tmp, dataset),
                                           "train", ["wav"])
        n, t0 = 0, time.perf_counter()
        while n < LOADER_BATCHES:
            for batch in loader:
                if batch["wav"].shape != (TRAIN_BATCH, TRAIN_SEGMENT):
                    raise AssertionError(f"{dataset}: batch "
                                         f"{batch['wav'].shape}")
                n += 1
        rates[dataset] = n / (time.perf_counter() - t0)
    reads = dict(DS.READS)
    log(f"[host-io] loader at batch {TRAIN_BATCH} ({loader.num_workers} "
        f"threads): DirectoriesDataset "
        f"{rates['DirectoriesDataset']:.1f} batches/s, DatasetPreprocessed "
        f"{rates['DatasetPreprocessed']:.1f} batches/s over "
        f"{LOADER_BATCHES} batches each; extract_pitch "
        f"{pitch_ms:.2f} ms per audio second; files read: native "
        f"{reads['native']}, stdlib {reads['stdlib']} (host numbers; "
        f"{card})")
    if reads["native"] == 0 or reads["stdlib"] != 0:
        raise AssertionError(f"reads by reader: {reads}")
    return dict(native_ms=np.percentile(nat, 50) * 1e3,
                stdlib_ms=np.percentile(std, 50) * 1e3, rates=rates,
                pitch_ms=pitch_ms, reads=reads)


def dp_cli_config(tmp):
    """configs/hilcodec_speech_synth.yaml training on {tmp}'s
    DatasetPreprocessed dump: CLI_STEPS steps of CLI_BATCH an epoch, two
    of the WAVs as its valid filelist; its path."""
    import yaml
    with open(os.path.join(ROOT, "configs", "hilcodec_speech_synth.yaml")) \
            as f:
        cfg = yaml.safe_load(f)
    data = cfg["data"]
    data["dataset"]["train"] = "DatasetPreprocessed"
    data["data_dir"] = os.path.join(tmp, "feats")
    data["wav_dir"] = os.path.join(tmp, "wavs")
    with open(os.path.join(tmp, "dp_train.txt"), "w") as f:
        f.write("\n".join(f"s{i:02d}" for i in range(CLI_STEPS * CLI_BATCH))
                + "\n")
    with open(os.path.join(tmp, "dp_valid.txt"), "w") as f:
        f.write("s20.wav\ns21.wav\n")
    data["filelists"] = {"train": os.path.join(tmp, "dp_train.txt"),
                         "valid": os.path.join(tmp, "dp_valid.txt")}
    cfg["train"].update(batch_size=CLI_BATCH, max_epochs=1, save_interval=1,
                        num_workers=0)
    cfg["valid"] = {"batch_size": 2}
    path = os.path.join(tmp, "dp_config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def torchrun_train(tmp):
    """`python -m torch.distributed.run --nproc_per_node 1 -m
    hilcodec_tpu_torch.train` on dp_cli_config for one epoch, started:
    (process, start time)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "1", "--master_addr", "127.0.0.1", "--master_port",
         str(free_port()), "-m", "hilcodec_tpu_torch.train", "-n", "dp",
         "-b", os.path.join(tmp, "logs"), "-c",
         os.path.join(tmp, "dp_config.yaml")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, time.perf_counter()


def await_torchrun(tmp, started):
    proc, t0 = started
    out, _ = proc.communicate(timeout=600)
    dt = time.perf_counter() - t0
    for ln in out.strip().splitlines()[-4:]:
        log(f"[dp-cli]   {ln[:160]}")
    ckpt = os.path.join(tmp, "logs", "dp", "00001.ckpt.npz")
    if proc.returncode != 0 or not os.path.exists(ckpt):
        raise AssertionError(f"torchrun train: rc {proc.returncode}, "
                             f"{ckpt} written: {os.path.exists(ckpt)}\n"
                             f"{out[-3000:]}")
    log(f"[dp-cli] python -m torch.distributed.run --nproc_per_node 1 -m "
        f"hilcodec_tpu_torch.train on a DatasetPreprocessed corpus: rc 0 "
        f"in {dt:.1f} s (NCCL, world 1), rank 0 wrote "
        f"{os.path.relpath(ckpt, tmp)}")


def dp_resume(tmp, card):
    """(a) The torchrun run's checkpoint resumed in this process, in the
    group of one rank: `TrainLoop` on the run directory (its config copy)
    for a second epoch; rank 0 writes 00002.ckpt.npz."""
    from hilcodec_tpu_torch.train.loop import TrainLoop
    from hilcodec_tpu_torch.utils.hparams import load_config

    run_dir = os.path.join(tmp, "logs", "dp")
    t0 = time.perf_counter()
    loop = TrainLoop(load_config(os.path.join(run_dir, "config.yaml")),
                     run_dir=run_dir, device="cuda")
    loop.init_or_resume()
    resumed = loop.epoch
    loop.run(max_epochs=2)
    ckpt = os.path.join(run_dir, "00002.ckpt.npz")
    if resumed != 1 or loop.n_proc != 1 or not os.path.exists(ckpt):
        raise AssertionError(f"the resume: epoch {resumed}, world "
                             f"{loop.n_proc}, {ckpt} written: "
                             f"{os.path.exists(ckpt)}")
    log(f"[dp-cli] resumed at epoch {resumed} in this process (TrainLoop "
        f"in the NCCL group of one rank) and wrote "
        f"{os.path.relpath(ckpt, tmp)} in {time.perf_counter() - t0:.1f} s "
        f"({card})")


def _stop(proc):
    """Kill a subprocess this phase started if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _flat_equal(a, b):
    from hilcodec_tpu_torch.utils import params as P
    fa, fb = P.tree_to_flat(a), P.tree_to_flat(b)
    return [k for k in fa if not np.array_equal(fa[k], fb[k])], len(fa)


def dp_pair(card):
    """(a) The flagship trainer in an NCCL group of one rank, in this
    process (the caller initialized it): one step from phase 7's initial
    state, first batch and draws under deterministic cuDNN, with the
    group and without (state and metrics bitwise). Returns the trainers,
    their states after that step and the batches for dp_timed."""
    import torch
    from hilcodec_tpu_torch.parallel import dist as D
    from hilcodec_tpu_torch.train.loop import step_generator
    from hilcodec_tpu_torch.train.step import to_device

    _, trainer, state = train_setup("cuda", TRAIN_BATCH, SEED + 20)
    dp = dataclasses.replace(trainer, group=D.default_group())
    rng = np.random.default_rng(SEED + 21)
    batches = [to_device(speech_batch(rng, TRAIN_BATCH, TRAIN_SEGMENT),
                         trainer.device)
               for _ in range(DP_WARMUP + DP_TIMED)]
    draws = trainer.sample_draws(step_generator(SEED, 0), batches[0].shape)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        plain, m_plain = trainer.train_step(state, batches[0], draws)
        grouped, m_dp = dp.train_step(state, batches[0], draws)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    differ, n_leaves = _flat_equal(plain, grouped)
    m_differ = [k for k in m_plain if not torch.equal(m_plain[k], m_dp[k])]
    log(f"[dp] one flagship step (batch {TRAIN_BATCH} x {TRAIN_SEGMENT}, "
        f"phase 7's initial state, first batch and draws) in an NCCL group "
        f"of one rank against the step without a group, deterministic "
        f"cuDNN: {n_leaves - len(differ)} / {n_leaves} state leaves and "
        f"{len(m_plain) - len(m_differ)} / {len(m_plain)} metrics bitwise "
        f"equal")
    if differ or m_differ:
        raise AssertionError(f"the world-1 step differs: "
                             f"{(differ + m_differ)[:8]}")
    return dict(trainers={"plain": trainer, "dp": dp},
                states={"plain": plain, "dp": grouped}, batches=batches)


def dp_timed(pair, card, phase7):
    """(a) The two trainers of dp_pair in turns (plain, grouped, grouped,
    plain, ...; each on its own state, the same batches and draws):
    DP_WARMUP - 1 steps each, then DP_TIMED timed (CUDA events), beside
    phase 7's p50; K1 once a grouped step."""
    import torch
    from hilcodec_tpu_torch.ops import rvq_kernel
    from hilcodec_tpu_torch.train.loop import step_generator

    trainers, states = pair["trainers"], pair["states"]
    timed = {"plain": [], "dp": []}
    launches = 0
    for i, b in enumerate(pair["batches"][1:]):
        draws = trainers["plain"].sample_draws(step_generator(SEED, i + 1),
                                               b.shape)
        for name in (("plain", "dp") if i % 2 == 0 else ("dp", "plain")):
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            rvq_kernel.reset_launches()
            ev[0].record()
            states[name], m = trainers[name].train_step(states[name], b,
                                                        draws)
            ev[1].record()
            if i + 1 >= DP_WARMUP:
                timed[name].append(ev)
                if name == "dp":
                    launches += rvq_kernel.LAUNCHES[rvq_kernel.KERNEL]
                    m_dp = m
        if i + 1 == DP_WARMUP - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(m_dp["loss/freq"]))
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in timed.items()}
    p50 = {k: float(np.percentile(v, 50)) for k, v in ms.items()}
    log(f"[dp] {DP_TIMED} timed steps in the group of one rank (the G and D "
        f"gradients, the balancer EMA, the VQ statistics and candidates and "
        f"the metrics through NCCL), in turns with the step without a "
        f"group: step ms p50 {p50['dp']:.1f} (all "
        f"{', '.join(f'{x:.1f}' for x in ms['dp'])}) against "
        f"{p50['plain']:.1f} without a group (all "
        f"{', '.join(f'{x:.1f}' for x in ms['plain'])}; "
        f"{(p50['dp'] / p50['plain'] - 1) * 100:+.1f}%), and phase 7's "
        f"{phase7['p50']:.1f}; rvq_cascade launches {launches} in the "
        f"grouped steps ({card})")
    if launches != DP_TIMED or not finite:
        raise AssertionError(f"DP steps: {launches} K1 launches in "
                             f"{DP_TIMED} steps, finite {finite}")
    return dict(launches=launches, p50=p50["dp"], plain_p50=p50["plain"])


def shard_latents(model, params, audio):
    """The encoder's latents [CLIENT_FRAMES, slots, C] of `audio` (int16
    [slots, samples]), frame by frame at all the slots' rows, as the
    unsharded engine's frame step computes them (the tie check's
    reference)."""
    import torch
    hop = model.hop_length
    wav = torch.from_numpy(audio.astype(np.float32) / 32768.0).to(
        model.device)[:, None]
    ce, _ = model.init_cache(len(audio))
    zs = []
    with torch.no_grad():
        for f in range(CLIENT_FRAMES):
            z, ce = model.codec.encoder.step(params["encoder"], ce,
                                             wav[:, :, f * hop:(f + 1) * hop])
            zs.append(z[..., 0].float())
    return torch.stack(zs)


def engine_tokens(tokens):
    """Engine tokens [F, S, n_q] as the parity report takes them: a tensor
    [n_q, F * S]."""
    import torch
    return torch.from_numpy(tokens.astype(np.int64)).permute(2, 0, 1)


def shard_parity(families):
    """(b) For each family of `families` ({name: (model, params,
    vq_state)}) at 16 and 128 slots: SlotEngine(devices=SHARD_PAIR), two
    shards on the one card, against devices=None (one shard), every slot
    active over CLIENT_FRAMES ticks of seeded client audio. Tokens equal,
    or f32 ties of the one-shard engine's latents (the rule of the CPU
    tests' assert_token_parity_exact_or_fp_tie); PCM within PCM_TOL_LSB up
    to a slot's first differing token; the RVQ kernel once a tick and
    shard. Returns the flagship's engines (for shard_ticks) and the
    sharded engines' RVQ launches by (family, slots)."""
    from hilcodec_tpu_torch.ops import rvq, rvq_kernel
    from hilcodec_tpu_torch.serve import SlotEngine

    engines, launches = {}, {}
    for family, (model, params, vq_state) in families.items():
        hop = model.hop_length
        for slots in SHARD_SLOTS:
            audio = np.stack([client_audio(i, hop) for i in range(slots)])
            out = {}
            for name, devices in (("plain", None), ("sharded", SHARD_PAIR)):
                eng = SlotEngine(model, params, vq_state, slots=slots,
                                 mode="roundtrip", fold=False,
                                 devices=devices)
                eng.warmup()
                for _ in range(slots):
                    eng.attach()
                rvq_kernel.reset_launches()
                toks, pcms = [], []
                for f in range(CLIENT_FRAMES):
                    for s in range(slots):
                        eng.submit(s, audio[s, f * hop:(f + 1) * hop])
                    res = eng.tick()
                    toks.append(np.stack([res[s]["tokens"]
                                          for s in range(slots)]))
                    pcms.append(np.stack([res[s]["pcm"]
                                          for s in range(slots)]))
                out[name] = (np.stack(toks), np.stack(pcms),
                             rvq_kernel.LAUNCHES[rvq_kernel.KERNEL])
                if family == "flagship":
                    engines[slots, name] = eng
            (ta, pa, la), (tb, pb, lb) = out["plain"], out["sharded"]
            # tokens [F, S, n_q] -> [n_q, F * S], positions as the latents'
            x = shard_latents(model, params, audio)
            rep = rvq.token_parity_report(
                *(engine_tokens(t) for t in (tb, ta)), x, vq_state["embed"])
            differ = (ta != tb).any(-1)                       # [F, S]
            first = np.where(differ.any(0), differ.argmax(0), CLIENT_FRAMES)
            lsb = max(int(np.abs(pa[:first[s], s].astype(np.int64)
                                 - pb[:first[s], s]).max(initial=0))
                      for s in range(slots))
            log(f"[shard] {family}, {slots} slots x {CLIENT_FRAMES} ticks: "
                f"SlotEngine(devices={SHARD_PAIR}) ({len(SHARD_PAIR)} "
                f"shards of {slots // len(SHARD_PAIR)} slots on the one "
                f"card) against devices=None: token mismatches "
                f"{int((ta != tb).sum())} of {ta.size} (f32 ties "
                f"{rep['ties']}, not ties {rep['not_ties']}), PCM max "
                f"|diff| {lsb} int16 steps up to a slot's first differing "
                f"token; rvq_cascade launches {lb} / {la}")
            if (not rep["ok"] or lsb > PCM_TOL_LSB
                    or lb != CLIENT_FRAMES * len(SHARD_PAIR)
                    or la != CLIENT_FRAMES):
                raise AssertionError(f"the sharded {family} engine differs "
                                     f"at {slots} slots: {rep}")
            launches[family, slots] = lb
    return engines, launches


def serve_mesh_check(started, model, params, vq_state, sr):
    """(b) `serve --mesh` (started already): 8 TCP clients x CLIENT_FRAMES
    frames against an engine in this process on the same weights and the
    same devices (every visible card): the same tokens, PCM within
    PCM_TOL_LSB."""
    import torch
    from hilcodec_tpu_torch.parallel.dist import mesh_devices
    from hilcodec_tpu_torch.serve import CodecServer, SlotEngine

    hop, n_q = model.hop_length, model.vq.num_quantizers
    srv_proc, port, dt = await_serving(started)
    audio = [client_audio(i, hop) for i in range(N_CLIENTS)]

    async def clients(p):
        return await asyncio.gather(*(run_client(p, a, hop, n_q)
                                      for a in audio))
    try:
        got = asyncio.run(clients(port))
    finally:
        srv_proc.terminate()
        srv_proc.wait(timeout=30)
    eng = SlotEngine(model, params, vq_state, slots=SERVE_SLOTS,
                     mode="roundtrip", fold=False,
                     devices=mesh_devices(model.device))
    eng.warmup()

    async def served():
        srv = CodecServer(eng, sr=sr, port=0)
        await srv.start()
        try:
            return await clients(srv.port)
        finally:
            await srv.stop()
    ref = asyncio.run(served())
    same = all(np.array_equal(a[0], b[0]) for a, b in zip(got, ref))
    lsb = max(int(np.abs(a[1].astype(np.int64) - b[1]).max())
              for a, b in zip(got, ref))
    log(f"[shard] serve -c {os.path.relpath(CONFIG, ROOT)} --slots "
        f"{SERVE_SLOTS} --mesh (every visible card: "
        f"{torch.cuda.device_count()}) serving {dt:.1f} s after start "
        f"(beside untimed work); {N_CLIENTS} TCP clients x {CLIENT_FRAMES} "
        f"frames against the engine on the same cards in this process: "
        f"tokens "
        f"{'identical' if same else 'DIFFER'}, PCM max |diff| {lsb} int16 "
        f"steps")
    if not same or lsb > PCM_TOL_LSB:
        raise AssertionError("serve --mesh differs from the engine")


def shard_ticks(engines, hop, card):
    """(b) The flagship's two engines of shard_parity (one shard, and two
    on the one card): tick p50 / p99 at 16 and 128 slots, in turns (a
    tick each), CLIENT_FRAMES ticks each."""
    rng = np.random.default_rng(SEED + 162)
    ticks = {}
    for slots in SHARD_SLOTS:
        times = {"plain": [], "sharded": []}
        for t in range(CLIENT_FRAMES):
            for name in (("plain", "sharded") if t % 2 == 0
                         else ("sharded", "plain")):
                eng = engines[slots, name]
                for s in range(slots):
                    eng.submit(s, (rng.standard_normal(hop) * 3000).astype(
                        np.int16))
                t0 = time.perf_counter()
                eng.tick()
                times[name].append(time.perf_counter() - t0)
        for name, v in times.items():
            ticks[slots, name] = (np.percentile(v, 50) * 1e3,
                                  np.percentile(v, 99) * 1e3)
        (a50, a99), (b50, b99) = ticks[slots, "plain"], ticks[slots,
                                                               "sharded"]
        log(f"[shard] {slots} slots, tick p50 / p99 over {CLIENT_FRAMES} "
            f"ticks each, the two engines in turns: devices=None {a50:.2f} "
            f"/ {a99:.2f} ms, devices={SHARD_PAIR} {b50:.2f} / {b99:.2f} "
            f"ms ({b50 / a50:.2f}x at p50; {card})")
    return ticks


def shard_bench():
    """(b) The bench at PATH_STREAMS, plain and --megakernel, unsharded
    and --mesh, one turn each; --mesh spans SHARD_PAIR (its device list
    replaced, as the CPU test does: two shards of the streams on the one
    card); every kernel's launches over the --mesh runs."""
    import torch
    from hilcodec_tpu_torch import bench
    from hilcodec_tpu_torch.ops import decoder_kernel as DK
    from hilcodec_tpu_torch.ops import encoder_kernel as EK
    from hilcodec_tpu_torch.ops import rvq_kernel

    launches = {}
    every_card = bench.mesh_devices
    for extra in ([], ["--megakernel"]):
        for mesh in ([], ["--mesh"]):
            argv = [str(PATH_STREAMS), "--seconds", "1"] + extra + mesh
            for mod in (rvq_kernel, DK, EK):
                mod.reset_launches()
            bench.mesh_devices = lambda d: [torch.device(x)
                                            for x in SHARD_PAIR]
            try:
                res = bench.run(argv)
            finally:
                bench.mesh_devices = every_card
            if mesh:
                launches[bool(extra)] = {
                    rvq_kernel.KERNEL: rvq_kernel.LAUNCHES[rvq_kernel.KERNEL],
                    DK.KERNEL: DK.LAUNCHES[DK.KERNEL],
                    EK.KERNEL: EK.LAUNCHES[EK.KERNEL]}
            log(f"[shard-bench] python -m hilcodec_tpu_torch.bench "
                f"{' '.join(argv)}"
                + (f" (over {SHARD_PAIR})" if mesh else "")
                + f": {json.dumps(res)}"
                + (f"; launches {launches[bool(extra)]}" if mesh else ""))
    frames = (1 + bench.REPS) * CLIENT_FRAMES * len(SHARD_PAIR)
    if (launches[False][rvq_kernel.KERNEL] != frames
            or any(v != frames for v in launches[True].values())):
        raise AssertionError(f"bench --mesh launches {launches}")
    return launches


def phase_parallel(card, phase7):
    """16. Data parallelism, slot sharding and the host I/O: (c)'s corpus
    and host numbers first, with nothing else running; then the untimed
    work of (a) and (b) beside the torchrun CLI run and the `serve --mesh`
    start-up; the resume; then, with nothing else running, the timed
    turns of (a) and (b) and the bench."""
    import tempfile
    import torch
    import torch.distributed as dist
    from hilcodec_tpu_torch.serve.__main__ import serving_weights
    from hilcodec_tpu_torch.utils.hparams import load_config

    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            paths, pitch_ms = host_corpus(tmp)
            host = phase_host_io(tmp, paths, pitch_ms, card)
            dp_cli_config(tmp)
            run = torchrun_train(tmp)
            started = spawn_serve(CONFIG, slots=SERVE_SLOTS, mesh=True)
            procs += [run[0], started[0]]
            torch.cuda.set_device(0)
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                    f"{free_port()}", world_size=1, rank=0)
            try:
                pair = dp_pair(card)
                hps = load_config(CONFIG)
                model, params, vq_state = serving_weights(hps, device="cuda")
                engines, engine_launches = shard_parity({
                    "flagship": (model, params, vq_state),
                    "encodec": build_encodec("cuda")[:3]})
                serve_mesh_check(started, model, params, vq_state,
                                 hps.data.sampling_rate)
                await_torchrun(tmp, run)
                dp_resume(tmp, card)
                dp = dp_timed(pair, card, phase7)
                del pair
            finally:
                dist.destroy_process_group()
            ticks = shard_ticks(engines, model.hop_length, card)
            del engines, model, params, vq_state
            bench = shard_bench()
        finally:
            for p in procs:
                _stop(p)
    return dict(host=host, dp=dp, shard=dict(
        engine=engine_launches["flagship", SERVE_SLOTS],
        engine128=engine_launches["flagship", PATH_STREAMS],
        encodec=engine_launches["encodec", SERVE_SLOTS],
        encodec128=engine_launches["encodec", PATH_STREAMS],
        bench=bench[False], bench_mega=bench[True], ticks=ticks))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import hilcodec_tpu_torch  # noqa: F401  (fails outside a checkout)
    from hilcodec_tpu_torch.ops import rvq_kernel

    from hilcodec_tpu_torch.ops import decoder_kernel, encoder_kernel

    t_start = time.perf_counter()

    def done(phase):
        log(f"[time] phase {phase} done at "
            f"{time.perf_counter() - t_start:.1f} s")

    name, line = phase_device()
    done(1)
    max_err, timings = phase_kernels(torch.device("cuda", 0))
    model, params, vq_state, sr = build_flagship("cuda")
    frame_err, frame_timings = phase_frame_kernels(model, params)
    for ch in ODD_CHANNELS:
        phase_frame_kernels(*build_small(ch), batches=(3,),
                            tag=f" (channels {ch})")
    done(2)
    launches = phase_serve(model, params, vq_state, sr)
    done(3)
    phase_timings(model, params, vq_state, line)
    done(4)
    frame_launches = phase_frame_path(model, params, vq_state)
    done(5)
    phase_bench()
    done(6)
    del model, params, vq_state
    train, tools = phase_train(line)
    done("7-8")
    encodec = phase_encodec(line)
    done(9)
    torch.cuda.empty_cache()
    avocodo = phase_avocodo(line)
    done(10)
    torch.cuda.empty_cache()
    phase_routing(line)
    done(11)
    torch.cuda.empty_cache()
    audiodec = phase_audiodec(line)
    done(12)
    torch.cuda.empty_cache()
    entropy = phase_entropy(line)
    done(13)
    torch.cuda.empty_cache()
    options = phase_train_options(line, train)
    done(14)
    torch.cuda.empty_cache()
    serving = phase_options(line)
    done(15)
    torch.cuda.empty_cache()
    parallel = phase_parallel(line, train)
    done(16)

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
        "launches_tools_path": tools["launches"],
        "launches_encodec_bench": encodec["bench_launches"],
        "launches_lm_path": entropy["launches"],
        "launches_hifigan_train_path": options["hifigan"]["launches"],
        "launches_bf16_train_path": options["bf16"]["launches"],
        "launches_remat_train_path": options["remat"]["launches"],
        "launches_bf16_remat_train_path": options["bf16+remat"]["launches"],
        "launches_export_program": serving["export_launches"],
        "launches_dp_train_path": parallel["dp"]["launches"],
        "launches_sharded_engine": parallel["shard"]["engine"],
        "launches_sharded_engine_128": parallel["shard"]["engine128"],
        "launches_bench_mesh": parallel["shard"]["bench"][rvq_kernel.KERNEL],
        "launches_bench_mesh_megakernel":
            parallel["shard"]["bench_mega"][rvq_kernel.KERNEL],
        "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]
    # the same kernel at K2's shape (n_q = 32), on the EnCodec serving path
    # at M = SERVE_SLOTS rows, and its training path at M = 1800
    ms, plain_ms, bound_ms, bound_by = timings[(SERVE_SLOTS, 32)]
    kernels.append({
        "name": f"{rvq_kernel.KERNEL}@n_q=32", "route": "cuda",
        "source": rvq_kernel.SOURCE,
        "replaces": "hilcodec_tpu/ops/pallas_rvq.py:130",
        "launches": encodec["serve_launches"],
        "launches_train_path": encodec["train"]["launches"],
        "launches_sharded_engine": parallel["shard"]["encodec"],
        "launches_sharded_engine_128": parallel["shard"]["encodec128"],
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "ms_m1800": timings[(1800, 32)][0],
        "bound_ms_m1800": timings[(1800, 32)][2], "library_ms": None})
    # the same kernel on Avocodo's 12-stage stack: its serving path at
    # M = SERVE_SLOTS, its trainer at M = 900, the `trainer: hilcodec`
    # ablation at M = 1800, the bench (n = 8) and the tools
    ms, plain_ms, bound_ms, bound_by = timings[(SERVE_SLOTS, 12)]
    entry = {
        "name": f"{rvq_kernel.KERNEL}@n_q=12", "route": "cuda",
        "source": rvq_kernel.SOURCE,
        "replaces": "hilcodec_tpu/ops/pallas_rvq.py:148",
        "launches": avocodo["serve_launches"],
        "launches_train_path": avocodo["train"]["launches"],
        "launches_hiltrainer_path": avocodo["hil_launches"],
        "launches_bench": avocodo["bench_launches"],
        "launches_tools_path": avocodo["tools_launches"],
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    for M in RVQ12_ROWS[1:]:
        entry[f"ms_m{M}"] = timings[(M, 12)][0]
        entry[f"plain_ms_m{M}"] = timings[(M, 12)][1]
        entry[f"bound_ms_m{M}"] = timings[(M, 12)][2]
    kernels.append(entry)
    # the same kernel at AudioDec's C = 64: its serving path at M =
    # SERVE_SLOTS (the launches), its bench (M = 16 and 128) and its tools
    # (M = 1)
    ms, plain_ms, bound_ms, bound_by = audiodec["timings"][SERVE_SLOTS]
    entry = {
        "name": f"{rvq_kernel.KERNEL}@C=64", "route": "cuda",
        "source": rvq_kernel.SOURCE,
        "replaces": "hilcodec_tpu/ops/pallas_rvq.py:148",
        "launches": audiodec["serve_launches"],
        "launches_bench": audiodec["bench_launches"],
        "launches_tools_path": audiodec["tools_launches"],
        "max_abs_err": audiodec["max_err"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    for M in AUDIODEC_ROWS:
        if M != SERVE_SLOTS:
            entry[f"ms_m{M}"], entry[f"plain_ms_m{M}"], \
                entry[f"bound_ms_m{M}"], _ = audiodec["timings"][M]
    kernels.append(entry)
    for mod, replaces in ((decoder_kernel,
                           "hilcodec_tpu/ops/pallas_decoder.py:490"),
                          (encoder_kernel,
                           "hilcodec_tpu/ops/pallas_encoder.py:234")):
        # the bound of the engine the kernel runs its GEMMs on (tensor
        # cores), and beside it the bound with every operation on the f32
        # CUDA cores, the one PR 2's kernel was held to
        ms, plain_ms, bounds = frame_timings[(mod.KERNEL, PATH_STREAMS)]
        t4_launches, t4_ms, t4_plain_ms, t4_bound = tools["t4"][mod.KERNEL]
        kernels.append({
            "name": mod.KERNEL, "route": "cuda", "source": mod.SOURCE,
            "replaces": replaces, "launches": frame_launches[mod.KERNEL],
            "max_abs_err": frame_err[mod.KERNEL], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bounds["tc"][0],
            "bound_by": bounds["tc"][1], "bound_f32_ms": bounds["f32"][0],
            "bound_f32_by": bounds["f32"][1], "library_ms": None,
            "launches_bench_mesh_megakernel":
                parallel["shard"]["bench_mega"][mod.KERNEL],
            "launches_t4": t4_launches, "ms_t4": t4_ms,
            "plain_ms_t4": t4_plain_ms, "bound_ms_t4": t4_bound[0],
            "bound_t4_by": t4_bound[1]})
    for mod, replaces in ((decoder_kernel,
                           "hilcodec_tpu/ops/pallas_decoder.py:490"),
                          (encoder_kernel,
                           "hilcodec_tpu/ops/pallas_encoder.py:234")):
        # the same kernels at --dtype bf16w (bf16 weights, widened when
        # packed) and bf16 (bf16 input, caches and output too): timed at
        # 128 streams (16 beside it), launches on the 16-stream path,
        # errors against the plain version of the same dtype
        for mode in PRECISIONS:
            e = serving["frames"][(mod.KERNEL, mode)]
            ms, plain_ms, (bound_ms, bound_by) = e[PATH_STREAMS]
            ms16, plain16, (bound16, _) = e[SERVE_SLOTS]
            kernels.append({
                "name": f"{mod.KERNEL}@{mode}", "route": "cuda",
                "source": mod.SOURCE, "replaces": replaces,
                "launches": e["launches"], "max_abs_err": e["max_abs_err"],
                "max_bf16_spacings": e["max_spacings"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "ms_b16": ms16, "plain_ms_b16": plain16,
                "bound_ms_b16": bound16})
    print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
