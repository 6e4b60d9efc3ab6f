"""Streaming causal transformer over ring KV caches (Mimi's, moshi's
`ProjectedTransformer` at equal input and model widths).

Each layer: x + s1 * attn(LayerNorm(x)), then x + s2 * ffn(LayerNorm(x)),
with per-channel LayerScale gains s1 / s2, pre-norm LayerNorms (eps 1e-5),
no biases in the projections, an exact-GELU feed-forward and no final
norm. Attention is causal over a window of `context` positions (a query
sees the `context` latest positions, itself included), with RoPE on q and
k in moshi's interleaved pairs (x[2i], x[2i+1]) at
freq_i = max_period ** (-2i / head_dim).

Layout: activations `[B, C, T]` as the conv stacks around it (moshi's
`conv_layout`). `apply` runs a whole sequence with the window mask and no
cache. `step` takes t >= 1 new positions (Mimi takes 2 a frame step) and
carries the cache list `[pos, k_0, v_0, k_1, v_1, ...]`:

  * `pos` [B] int64: the number of positions each row has seen. Rows
    advance together here, but each keeps its own count, so that a slot
    engine can reset one row alone.
  * `k_l`, `v_l` [B, H, context, D]: a ring, preallocated; position p
    lives in slot p % context. A step reads the ring as it was, scores
    the new positions against it and against themselves (a slot whose
    position has left the window, or that was never written, is masked),
    then writes the new keys and values into their slots in place.

So a step reads each layer's ring once, whatever t. The attention is
plain products and a softmax (`torch.matmul`, IEEE f32 under the
package's parity mode), inside the span `mimi.attention` once a layer's
call; the ring write is in the span too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..utils.spans import span

Params = Dict[str, Any]
Cache = List[torch.Tensor]


def rope_tables(positions: torch.Tensor, head_dim: int,
                max_period: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] -> (cos, sin) [B, 1, T, head_dim / 2]."""
    ds = torch.arange(head_dim // 2, device=positions.device,
                      dtype=torch.float32)
    freqs = torch.exp(ds * (-math.log(max_period) * 2.0 / head_dim))
    phase = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(phase)[:, None], torch.sin(phase)[:, None]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, T, D] rotated in interleaved pairs (moshi's `apply_rope`)."""
    B, H, T, D = x.shape
    xp = x.float().reshape(B, H, T, D // 2, 2)
    xr, xi = xp[..., 0], xp[..., 1]
    out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return out.reshape(B, H, T, D).to(x.dtype)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), g.to(x.dtype), b.to(x.dtype),
                        eps)


@dataclasses.dataclass(frozen=True)
class StreamingTransformer:
    """`num_layers` pre-norm layers of d_model, `num_heads` heads, a
    `dim_feedforward` FFN, attention over a window of `context`
    positions."""
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 8
    dim_feedforward: int = 2048
    context: int = 250
    max_period: float = 10000.0
    layer_scale: float = 0.01
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def init(self, gen: torch.Generator) -> Params:
        """torch.nn.Linear's default draws, U(-1/sqrt(fan_in), +), for the
        projections; LayerNorms at (1, 0); LayerScale gains at
        `layer_scale`."""
        C, Fd = self.d_model, self.dim_feedforward

        def lin(out_f, in_f):
            s = 1.0 / math.sqrt(in_f)
            return torch.empty((out_f, in_f)).uniform_(-s, s, generator=gen)

        return {"layers": [{
            "norm1_g": torch.ones(C), "norm1_b": torch.zeros(C),
            "in_proj_w": lin(3 * C, C), "out_proj_w": lin(C, C),
            "scale1": torch.full((C,), self.layer_scale),
            "norm2_g": torch.ones(C), "norm2_b": torch.zeros(C),
            "lin1_w": lin(Fd, C), "lin2_w": lin(C, Fd),
            "scale2": torch.full((C,), self.layer_scale)}
            for _ in range(self.num_layers)]}

    # -- shared pieces ------------------------------------------------------
    def _qkv(self, p: Params, h: torch.Tensor, cos, sin):
        """h [B, T, C] -> q, k, v [B, H, T, D], q and k rotated."""
        B, T, C = h.shape
        qkv = (h @ p["in_proj_w"].T.to(h.dtype)).reshape(
            B, T, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _rest(self, p: Params, x: torch.Tensor,
              attn: torch.Tensor) -> torch.Tensor:
        """The attention output's projection and gain, then the FFN
        branch. x [B, T, C]; attn [B, H, T, D]."""
        B, T, C = x.shape
        a = attn.transpose(1, 2).reshape(B, T, C)
        x = x + p["scale1"].to(x.dtype) * (a @ p["out_proj_w"].T.to(x.dtype))
        h = layer_norm(x, p["norm2_g"], p["norm2_b"], self.norm_eps)
        h = F.gelu(h @ p["lin1_w"].T.to(x.dtype))
        return x + p["scale2"].to(x.dtype) * (h @ p["lin2_w"].T.to(x.dtype))

    # -- whole sequence -----------------------------------------------------
    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T] -> [B, C, T], positions 0..T-1, the window mask."""
        B, C, T = x.shape
        pos = torch.arange(T, device=x.device)
        cos, sin = rope_tables(pos[None].expand(B, T), self.head_dim,
                               self.max_period)
        delta = pos[:, None] - pos[None, :]
        bias = torch.zeros((T, T), dtype=x.dtype, device=x.device)
        bias = bias.masked_fill((delta < 0) | (delta >= self.context),
                                float("-inf"))
        scale = 1.0 / math.sqrt(self.head_dim)
        x = x.transpose(1, 2)
        for p in params["layers"]:
            h = layer_norm(x, p["norm1_g"], p["norm1_b"], self.norm_eps)
            q, k, v = self._qkv(p, h, cos, sin)
            with span("mimi.attention"):
                s = (q @ k.transpose(-1, -2)) * scale + bias
                attn = torch.softmax(s, dim=-1) @ v
            x = self._rest(p, x, attn)
        return x.transpose(1, 2)

    # -- streaming ----------------------------------------------------------
    def init_cache(self, batch: int, dtype=torch.float32,
                   device="cpu") -> Cache:
        """[pos [B] int64 zeros, then k, v [B, H, context, D] zeros a
        layer]."""
        shape = (batch, self.num_heads, self.context, self.head_dim)
        ring = [torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(2 * self.num_layers)]
        return [torch.zeros((batch,), dtype=torch.int64, device=device)] \
            + ring

    def step(self, params: Params, cache: Cache, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Cache]:
        """x [B, C, t] (t new positions) -> (y [B, C, t],
        the cache with the ring written in place and pos advanced by
        t)."""
        B, C, t = x.shape
        ctx = self.context
        pos = cache[0]
        dev = x.device
        ar = torch.arange(t, device=dev)
        positions = pos[:, None] + ar[None, :]                   # [B, t]
        cos, sin = rope_tables(positions, self.head_dim, self.max_period)
        # the position each slot holds before this step, and which slots
        # a query may see: written, and inside its window
        slots = torch.arange(ctx, device=dev)
        held = pos[:, None] - 1 - torch.remainder(
            pos[:, None] - 1 - slots[None, :], ctx)              # [B, ctx]
        seen = (held[:, None, :] >= 0) & (
            positions[:, :, None] - held[:, None, :] < ctx)      # [B, t, ctx]
        bias_old = torch.zeros((B, 1, t, ctx), dtype=x.dtype, device=dev)
        bias_old = bias_old.masked_fill(~seen[:, None], float("-inf"))
        delta = ar[:, None] - ar[None, :]
        bias_new = torch.zeros((t, t), dtype=x.dtype, device=dev)
        bias_new = bias_new.masked_fill((delta < 0) | (delta >= ctx),
                                        float("-inf"))
        bias = torch.cat([bias_old, bias_new.expand(B, 1, t, t)], dim=-1)
        # the ring keeps the last `context` of the new positions
        kept = min(t, ctx)
        write = torch.remainder(positions[:, t - kept:], ctx)[
            :, None, :, None].expand(B, self.num_heads, kept, self.head_dim)
        scale = 1.0 / math.sqrt(self.head_dim)
        xs = x.transpose(1, 2)
        for li, p in enumerate(params["layers"]):
            k_ring, v_ring = cache[1 + 2 * li], cache[2 + 2 * li]
            h = layer_norm(xs, p["norm1_g"], p["norm1_b"], self.norm_eps)
            q, k, v = self._qkv(p, h, cos, sin)
            with span("mimi.attention"):
                s = torch.cat([q @ k_ring.transpose(-1, -2),
                               q @ k.transpose(-1, -2)], dim=-1)
                w = torch.softmax(s * scale + bias, dim=-1)
                attn = w[..., :ctx] @ v_ring + w[..., ctx:] @ v
                k_ring.scatter_(2, write, k[:, :, t - kept:].to(k_ring.dtype))
                v_ring.scatter_(2, write, v[:, :, t - kept:].to(v_ring.dtype))
            xs = self._rest(p, xs, attn)
        return xs.transpose(1, 2), [pos + t] + list(cache[1:])
