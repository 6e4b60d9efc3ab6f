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
`pad_mode` pads the batched conv as `jnp.pad(x, ..., mode=pad_mode)` does,
for every mode that needs no extra argument (`pad1d`): "reflect" (the
EnCodec family's default), "symmetric" and "wrap" extend the input
periodically, so a pad as long as the input or longer is defined (torch's
`F.pad` raises there); "edge", "linear_ramp" (to zero), "maximum",
"minimum", "mean" and "median" (over the whole axis) follow numpy. The
streaming step keeps zero caches in every mode, as the JAX step does.
The JAX package's `set_depthwise_lowering` chooses how XLA lowers a
depthwise conv ("conv", or "shift": k shifted multiply-adds, a tuning of
TPU autodiff); both compute the same function, so the port takes either
name (`DEPTHWISE_LOWERINGS`, from `train.depthwise_lowering` and the
bench's `--depthwise`) and runs the convolution.
These are plain cuDNN / ATen convolutions (the JAX package runs them as
XLA convolutions, not as Pallas kernels). On the CPU, no form may let a
row's result depend on the batch, so that a stream gives the same bits
alone as inside a slot batch: oneDNN picks its kernel for a dense
convolution (groups 1, several input channels; pointwise, strided or
transposed too) by batch size. For CPU tensors `conv1d` computes a dense
conv as `row_matmul` over its k-tap windows (a grouped conv of several
channels a group, AudioDec's, group by group), and `conv_transpose1d` a
dense transposed conv as one `row_matmul` followed by an overlap-add of
its k taps. Depthwise and 1-input-channel convolutions are
batch-invariant as they are. On the card every
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

# the JAX package's depthwise lowerings (XLA's choice): one convolution here
DEPTHWISE_LOWERINGS = ("conv", "shift")


class _RowMatmul(torch.autograd.Function):
    """rows [m, K] @ b [K, N] in blocks of ROW_BLOCK rows. The backward is
    two plain products: only the forward must not depend on the batch, and
    a backward through the blocks' slices would allocate a zero gradient
    of all m rows for each block."""

    @staticmethod
    def forward(ctx, rows, b):
        ctx.save_for_backward(rows, b)
        m = rows.shape[0]
        pad = (-m) % ROW_BLOCK
        if pad:
            rows = torch.cat([rows, rows.new_zeros(pad, rows.shape[1])])
        b = b.contiguous()
        return torch.cat([rows[i:i + ROW_BLOCK] @ b
                          for i in range(0, rows.shape[0], ROW_BLOCK)])[:m]

    @staticmethod
    def backward(ctx, g):
        rows, b = ctx.saved_tensors
        return (g @ b.T if ctx.needs_input_grad[0] else None,
                rows.T @ g if ctx.needs_input_grad[1] else None)


def row_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N], each row computed the same way whatever the
    number of rows.

    MKL picks its CPU kernel by row count (one row goes to a GEMV), which
    changes a row's low bits with the batch. On the CPU every row therefore
    goes through a product of exactly ROW_BLOCK rows (the last block padded
    with zeros); on the card this is one matmul."""
    if a.device.type != "cpu":
        return a @ b
    out = _RowMatmul.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*a.shape[:-1], b.shape[1])


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, dilation: int = 1, groups: int = 1,
           padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain conv1d with asymmetric zero padding (left, right)."""
    if padding != (0, 0):
        x = F.pad(x, padding)
    w = w.to(x.dtype)
    b = None if b is None else b.to(x.dtype)
    if x.device.type == "cpu" and groups > 1 and w.shape[1] > 1:
        # a grouped conv of several channels a group: each group as a
        # dense conv of its own
        bs = [None] * groups if b is None else b.chunk(groups)
        return torch.cat([conv1d(xg, wg, bg, stride, dilation)
                          for xg, wg, bg in zip(x.chunk(groups, dim=1),
                                                w.chunk(groups), bs)], dim=1)
    if x.device.type == "cpu" and groups == 1 and w.shape[1] > 1:
        # rows of k-tap windows, [B, t, Cin*k] @ [Cin*k, Cout]
        cout, cin, k = w.shape
        t = (x.shape[-1] - dilation * (k - 1) - 1) // stride + 1
        taps = torch.stack([x[:, :, j * dilation:
                              j * dilation + (t - 1) * stride + 1:stride]
                            for j in range(k)], dim=-1)
        rows = taps.permute(0, 2, 1, 3).reshape(x.shape[0], t, cin * k)
        y = row_matmul(rows, w.reshape(cout, cin * k).T).transpose(1, 2)
        return y if b is None else y + b[None, :, None]
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """The full transposed conv (no bias), length (L-1)*s + d*(k-1) + 1.
    A dense one on the CPU is x's time-major rows times w as one
    `row_matmul`, then each tap j added in at offset j*d, stride s."""
    w = w.to(x.dtype)
    cin, cout_g, k = w.shape
    if x.device.type != "cpu" or groups != 1 or cin == 1:
        return F.conv_transpose1d(x, w, None, stride=stride,
                                  dilation=dilation, groups=groups)
    B, L = x.shape[0], x.shape[-1]
    prod = row_matmul(x.transpose(1, 2), w.reshape(cin, cout_g * k))
    prod = prod.reshape(B, L, cout_g, k).permute(0, 2, 1, 3)
    y = x.new_zeros((B, cout_g, (L - 1) * stride + dilation * (k - 1) + 1))
    for j in range(k):
        y[:, :, j * dilation:j * dilation + (L - 1) * stride + 1:stride] += \
            prod[..., j]
    return y


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


def reflect_index(length: int, left: int, right: int,
                  device=None) -> torch.Tensor:
    """Source indices of numpy's reflect pad of a length-`length` axis by
    (left, right): the input extended with period 2*(length-1), so a pad
    longer than the input reflects again."""
    i = torch.arange(-left, length + right, device=device)
    if length == 1:
        return torch.zeros_like(i)
    period = 2 * (length - 1)
    m = torch.remainder(i, period)
    return torch.where(m < length, m, period - m)


# np.pad's modes that take no extra argument, as jnp.pad passes them on;
# "empty" is left out: its values are undefined
PAD_MODES = ("constant", "edge", "linear_ramp", "maximum", "mean", "median",
             "minimum", "reflect", "symmetric", "wrap")


def _periodic_index(length: int, left: int, right: int, mode: str,
                    device=None) -> torch.Tensor:
    """Source indices of numpy's reflect / symmetric / wrap pad: the input
    extended periodically, so a pad of any length is defined."""
    i = torch.arange(-left, length + right, device=device)
    if mode == "wrap":
        return torch.remainder(i, length)
    if mode == "symmetric":
        m = torch.remainder(i, 2 * length)
        return torch.where(m < length, m, 2 * length - 1 - m)
    return reflect_index(length, left, right, device)


def _stat(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The statistic of the whole last axis that a stat mode pads with."""
    if mode == "maximum":
        return x.amax(-1, keepdim=True)
    if mode == "minimum":
        return x.amin(-1, keepdim=True)
    if mode == "mean":
        return x.mean(-1, keepdim=True)
    s = x.sort(-1).values              # median: the mean of the middle two
    n = x.shape[-1]
    return (s[..., (n - 1) // 2:(n - 1) // 2 + 1]
            + s[..., n // 2:n // 2 + 1]) / 2


def pad1d(x: torch.Tensor, padding: Tuple[int, int],
          mode: str = "constant") -> torch.Tensor:
    """Pad the last axis by (left, right) as `jnp.pad(mode=mode)` does:
    zeros; numpy's reflect, symmetric or wrap (an index gather, defined for
    pads of any length); the edge value; a linear ramp from the edge value
    to zero; or the maximum, minimum, mean or median of the whole axis."""
    left, right = padding
    if mode in ("constant", "zeros"):
        return F.pad(x, padding)
    if mode == "empty":
        raise ValueError("pad_mode 'empty' leaves the pad's values "
                         "undefined; choose one of " + ", ".join(PAD_MODES))
    if mode not in PAD_MODES:
        raise ValueError(f"unknown pad_mode {mode!r}; choose one of "
                         + ", ".join(PAD_MODES))
    L = x.shape[-1]
    if mode in ("reflect", "symmetric", "wrap"):
        return x.index_select(-1, _periodic_index(L, left, right, mode,
                                                  x.device))
    if mode == "edge":
        i = torch.arange(-left, L + right, device=x.device).clamp(0, L - 1)
        return x.index_select(-1, i)
    if mode == "linear_ramp":
        # np.linspace(0, edge, pad, endpoint=False), mirrored on the right
        def ramp(edge, n):
            return edge * (torch.arange(n, dtype=x.dtype, device=x.device)
                           / n)
        return torch.cat([ramp(x[..., :1], left), x,
                          ramp(x[..., -1:], right).flip(-1)], dim=-1)
    v = _stat(x, mode)
    return torch.cat([v.expand(*x.shape[:-1], left), x,
                      v.expand(*x.shape[:-1], right)], dim=-1)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, stride: int = 1,
                  dilation: int = 1, groups: int = 1,
                  pad_mode: str = "constant") -> torch.Tensor:
    """Batched causal conv: left-pad d*(k-1)-(s-1), right-pad to a full
    last window; zero padding (`pad_mode: constant`, the flagship's) or any
    other mode of `pad1d` (`reflect`, the EnCodec family's default)."""
    k = w.shape[-1]
    pad_total = causal_pad_total(k, stride, dilation)
    extra = extra_pad_for_full_windows(x.shape[-1], k, stride, pad_total)
    if pad_mode not in ("constant", "zeros"):
        return conv1d(pad1d(x, (pad_total, extra), pad_mode), w, b, stride,
                      dilation, groups)
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
    y = conv_transpose1d(x, w, stride, dilation, groups)
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
