"""Causal 1-D convolutions, batch and streaming.

Counterpart of `hilcodec_tpu/ops/conv.py`. Tensors are `[B, C, L]`,
conv weights `[Cout, Cin/groups, k]`, transposed-conv weights
`[Cin, Cout/groups, k]` (torch's layouts, which the JAX tree keeps).

The semantics are the JAX package's, not torch's `SConvTranspose1d` trim:
  * causal conv: left pad d(k-1)-(s-1), right pad to a full last window;
    a streaming step keeps d(k-1)-(s-1) input samples of history;
  * causal transposed conv: output length L*s for every (k, s, d), i.e. the
    full transposed conv cut at L*s (the JAX right pad is s-1 on an
    lhs-dilated conv); a streaming step keeps floor(d(k-1)/s) input
    frames and drops the first cache_len*s output samples.
These are plain cuDNN / ATen convolutions (the JAX package runs them as
XLA convolutions, not as Pallas kernels). On the CPU, two forms must not
let a row's result depend on the batch, so that a stream gives the same
bits alone as inside a slot batch: oneDNN picks its kernel for a pointwise
(1x1) or a 1-output-channel convolution by batch size. For CPU tensors
`conv1d` computes a pointwise conv as `row_matmul` over time-major rows
and a 1-output-channel conv as an explicit k-tap sum followed by one
channel reduction. Depthwise, transposed, strided and 1-input-channel
convolutions are batch-invariant as they are. On the card every
convolution stays with cuDNN, which is faster there and not bitwise
batch-invariant in any form.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# rows per product in row_matmul on the CPU
ROW_BLOCK = 16


def row_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N], each row computed the same way whatever the
    number of rows.

    MKL picks its CPU kernel by row count (one row goes to a GEMV), which
    changes a row's low bits with the batch. On the CPU every row therefore
    goes through a product of exactly ROW_BLOCK rows (the last block padded
    with zeros); on the card this is one matmul."""
    if a.device.type != "cpu":
        return a @ b
    rows = a.reshape(-1, a.shape[-1])
    m = rows.shape[0]
    pad = (-m) % ROW_BLOCK
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad, rows.shape[1])])
    b = b.contiguous()
    out = torch.cat([rows[i:i + ROW_BLOCK] @ b
                     for i in range(0, rows.shape[0], ROW_BLOCK)])
    return out[:m].reshape(*a.shape[:-1], b.shape[1])


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, dilation: int = 1, groups: int = 1,
           padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain conv1d with asymmetric zero padding (left, right)."""
    if padding != (0, 0):
        x = F.pad(x, padding)
    w = w.to(x.dtype)
    b = None if b is None else b.to(x.dtype)
    cpu = x.device.type == "cpu"
    if cpu and groups == 1 and stride == 1 and w.shape[-1] == 1:
        y = row_matmul(x.transpose(1, 2), w[:, :, 0].T).transpose(1, 2)
        return y if b is None else y + b[None, :, None]
    if cpu and groups == 1 and stride == 1 and w.shape[0] == 1:
        k = w.shape[-1]
        t = x.shape[-1] - dilation * (k - 1)
        y = None
        for j in range(k):
            term = (x[:, :, j * dilation:j * dilation + t]
                    * w[0, :, j][None, :, None])
            y = term if y is None else y + term
        y = torch.sum(y, dim=1, keepdim=True)
        return y if b is None else y + b[None, :, None]
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


def causal_pad_total(kernel_size: int, stride: int = 1,
                     dilation: int = 1) -> int:
    """Left padding of a causal strided conv: d*(k-1) - (s-1)."""
    return dilation * (kernel_size - 1) - (stride - 1)


def extra_pad_for_full_windows(length: int, kernel_size: int, stride: int,
                               padding_total: int) -> int:
    """Right padding so the final conv window is full."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + kernel_size - padding_total
    return ideal - length


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, stride: int = 1,
                  dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Batched causal conv: left-pad d*(k-1)-(s-1), right-pad to a full
    last window (zero padding, the flagship's `pad_mode: constant`)."""
    k = w.shape[-1]
    pad_total = causal_pad_total(k, stride, dilation)
    extra = extra_pad_for_full_windows(x.shape[-1], k, stride, pad_total)
    return conv1d(x, w, b, stride, dilation, groups,
                  padding=(pad_total, extra))


def causal_conv1d_cache_len(kernel_size: int, stride: int = 1,
                            dilation: int = 1) -> int:
    return dilation * (kernel_size - 1) - (stride - 1)


def causal_conv1d_step(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, stride: int = 1,
                       dilation: int = 1, groups: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming step: concat cache, conv, keep the last `cache_len`
    samples. x: [B, Cin, L] with L a multiple of `stride`."""
    cache_len = cache.shape[-1]
    xc = torch.cat([cache, x], dim=-1)
    new_cache = xc[:, :, xc.shape[-1] - cache_len:]
    return conv1d(xc, w, b, stride, dilation, groups), new_cache


def _convt_window(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor], stride: int, dilation: int,
                  groups: int, start: int, length: int) -> torch.Tensor:
    """Samples [start, start+length) of the full transposed conv, with
    zeros past its end (plus bias)."""
    y = F.conv_transpose1d(x, w.to(x.dtype), None, stride=stride,
                           dilation=dilation, groups=groups)
    y = y[:, :, start:start + length]
    if y.shape[-1] < length:
        y = F.pad(y, (0, length - y.shape[-1]))
    if b is not None:
        y = y + b.to(y.dtype)[None, :, None]
    return y


def causal_conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                            b: Optional[torch.Tensor] = None, stride: int = 1,
                            dilation: int = 1, groups: int = 1
                            ) -> torch.Tensor:
    """Batched causal transposed conv: the first L*s samples of the full
    transposed conv, for every (k, s, d) (the JAX package's streaming
    semantic; batch == concatenated steps)."""
    return _convt_window(x, w, b, stride, dilation, groups, 0,
                         x.shape[-1] * stride)


def causal_conv_transpose1d_cache_len(kernel_size: int, stride: int = 1,
                                      dilation: int = 1) -> int:
    return (dilation * (kernel_size - 1)) // stride


def causal_conv_transpose1d_step(x: torch.Tensor, cache: torch.Tensor,
                                 w: torch.Tensor,
                                 b: Optional[torch.Tensor] = None,
                                 stride: int = 1, dilation: int = 1,
                                 groups: int = 1
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming transposed-conv step: emits exactly L*s samples.

    The JAX step pads (d(k-1) - cache_len*s, s-1) on the lhs-dilated conv
    of [cache, x]; that is the full transposed conv of [cache, x] from
    sample cache_len*s on."""
    cache_len = cache.shape[-1]
    xc = torch.cat([cache, x], dim=-1)
    new_cache = xc[:, :, xc.shape[-1] - cache_len:]
    y = _convt_window(xc, w, b, stride, dilation, groups,
                      cache_len * stride, x.shape[-1] * stride)
    return y, new_cache
