"""Micro-benchmark of the depthwise conv1d forward and backward in two
forms (counterpart of the JAX package's `scripts/bench_dwconv.py`).

At the generator's train shapes (batch 24; the speech model's encoder and
decoder stages), it times the forward and the gradient of sum(y) with
respect to x and w of:
  conv  -- one depthwise convolution (cuDNN; groups = C), the model's
           form (`ops/conv.py`);
  shift -- k shifted multiply-adds (the JAX package's `shift` lowering,
           an XLA elementwise form; kept here only, the model runs the
           convolution).
Each time is REPS calls back to back over 4 seeded input variants between
two CUDA events, after one warm-up call, ending in a synchronize; f32 with
TF32 off (the parity mode).

Usage: python -m hilcodec_tpu_torch.scripts.bench_dwconv [batch=24]
           [--device D]
Prints one JSON line per shape: {C, T, k, stride, conv_fwd_ms,
conv_bwd_ms, shift_fwd_ms, shift_bwd_ms}.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, set_f32_parity_mode
from . import pop_device
from .streaming_roofline import timed_s

# (C, T, k, stride, dilation) at the speech model's encoder / decoder
# stages (channels 64 / 96 doubling a stage, strides [8, 5, 4, 2])
SHAPES = [
    (64, 24000, 5, 1, 1),    # enc stage 0 residual dw
    (128, 24000, 16, 8, 1),  # enc down dw (k = 2 * stride)
    (128, 3000, 5, 1, 1),
    (256, 600, 5, 1, 1),
    (512, 150, 5, 1, 1),
    (96, 24000, 5, 1, 1),    # dec full-rate residual dw
]
REPS = 20
VARIANTS = 4


def conv_dw(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            dilation: int = 1) -> torch.Tensor:
    """Causal depthwise conv: left pad d(k-1)-(s-1), one convolution.
    w: [C, 1, k]."""
    k = w.shape[-1]
    pad = dilation * (k - 1) - (stride - 1)
    return F.conv1d(F.pad(x, (pad, 0)), w, stride=stride,
                    dilation=dilation, groups=x.shape[1])


def shift_dw(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
             dilation: int = 1) -> torch.Tensor:
    """The same conv as k shifted multiply-adds."""
    k = w.shape[-1]
    pad = dilation * (k - 1) - (stride - 1)
    xp = F.pad(x, (pad, 0))
    tout = (xp.shape[-1] - dilation * (k - 1) - 1) // stride + 1
    y = x.new_zeros((x.shape[0], x.shape[1], tout))
    for j in range(k):
        sl = xp[:, :, j * dilation:j * dilation + (tout - 1) * stride + 1:
                stride]
        y = y + w[None, :, 0, j:j + 1] * sl
    return y


def grad_sum(f, x, w, stride, dilation):
    """d sum(f(x, w)) / d(x, w)."""
    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    with torch.enable_grad():
        return torch.autograd.grad(f(x, w, stride, dilation).sum(), (x, w))


def time_ms(fn, argsets, device: torch.device, reps: int = REPS) -> float:
    """ms a call: `reps` calls back to back over the argument sets, after
    one warm-up call, ending in a synchronize."""
    fn(*argsets[0])

    def calls():
        for i in range(reps):
            fn(*argsets[i % len(argsets)])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return timed_s(calls, device) / reps * 1e3


def run(argv: Optional[List[str]] = None, shapes=SHAPES) -> List[dict]:
    argv, device = pop_device(sys.argv[1:] if argv is None else argv)
    batch = int(argv[0]) if argv else 24
    device = resolve_device(device)
    if device.type == "cuda":
        set_f32_parity_mode()
    rng = np.random.default_rng(0)
    rows = []
    for C, T, k, s, d in shapes:
        xs = [torch.from_numpy(rng.standard_normal((batch, C, T))
                               .astype(np.float32)).to(device)
              for _ in range(VARIANTS)]
        w = torch.from_numpy(rng.standard_normal((C, 1, k))
                             .astype(np.float32)).to(device)
        row = {"C": C, "T": T, "k": k, "stride": s}
        with torch.no_grad():
            for name, f in (("conv", conv_dw), ("shift", shift_dw)):
                row[f"{name}_fwd_ms"] = round(time_ms(
                    lambda x, w, f=f: f(x, w, s, d),
                    [(x, w) for x in xs], device), 3)
                row[f"{name}_bwd_ms"] = round(time_ms(
                    lambda x, w, f=f: grad_sum(f, x, w, s, d),
                    [(x, w) for x in xs], device), 3)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del xs
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
