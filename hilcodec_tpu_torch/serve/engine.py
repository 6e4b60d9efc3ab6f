"""Slot-batched streaming serving engine (`hilcodec_tpu/serve/engine.py`).

One frame step over a fixed batch of S slots, with live client streams
mapped onto slot rows:

  * attach -> claim a free slot row; its cache rows are reset to the init
              cache inside the next tick (a masked select);
  * frame  -> at most one pending frame per slot joins the next tick;
              slots with nothing pending run on zero input and a masked
              select keeps their cache rows unchanged, so a stream that
              skips a tick does not advance;
  * detach -> the slot returns to the free list; the next occupant's reset
              masks away whatever state the previous stream left.

The caches are allocated once on the device and updated in place, row by
row, through `torch.where` selects (the JAX engine donates and replaces
them instead). Each cache tensor is selected along its own batch axis, as
`CodecModel.cache_axes` reads it off the shapes (axis 0 of a conv cache,
axis 1 of an LSTM's [layers, S, H] state). The JAX engine masks axis 0 of
every cache, which fails on EnCodec's LSTM state; the port does not.
Per tick the host uploads the [S, 1, hop] int16 frame batch and two
boolean masks and downloads one packed int16 array; the int16 <->
f32 conversion runs on the device, with round-half-even and clipping, so
the outputs equal rounding the solo-stream float outputs on the host.
The engine runs on CUDA unless `device` names another device; on CUDA it
keeps convolutions and matmuls in IEEE f32 (TF32 off). `dtype` (f32 by
default, as the JAX engine's) is the caches' dtype; any other dtype also
casts every leaf of the folded params (`cast_streaming_params`) and the
uploaded PCM, so the frame step runs in it; the latents still reach the
quantizer in f32.

`devices` places the engine: one device, or several to shard the slots
over (the JAX engine's `mesh=`; `parallel/dist.place_shards`). Each
device holds its own copy of the params and the VQ state and the caches
of its slot range, each cache split on its own batch axis. Streams are
independent, so the shards share nothing: a tick uploads each shard's
rows, launches every shard's frame step from this thread, then fetches
their outputs. The default is one shard on CUDA.

A tick opens the spans `slot_engine.collect`, `slot_engine.upload`,
`slot_engine.step` and `slot_engine.fetch` (`utils/spans.py`, present
only under torch.profiler); `stats` keeps running sums of the same
phases' host time and of each frame's wait from `submit` to `collect`.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device, set_f32_parity_mode
from ..models.codec import cast_streaming_params
from ..parallel.dist import place_shards
from ..utils.spans import span


@dataclass
class _Batch:
    """One tick's worth of work, snapshotted by collect()."""
    x: np.ndarray                 # [S, 1, hop] int16 (decode: [n_q, S, 1])
    active: List[int]             # slots with a real frame this tick
    active_mask: np.ndarray       # [S] bool
    reset_mask: np.ndarray        # [S] bool
    seq: Dict[int, int] = field(default_factory=dict)


def _dec16(x16: torch.Tensor) -> torch.Tensor:
    return x16.to(torch.float32) / 32768.0


def _enc16(wav: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as np.round does
    return torch.clamp(torch.round(wav * 32768.0), -32768, 32767
                       ).to(torch.int16)


def _select_rows(dst: List[torch.Tensor], src: List[torch.Tensor],
                 mask: torch.Tensor, axes: List[int]) -> None:
    """dst[i][..., s, ...] = src[i][..., s, ...] where mask[s], in place,
    with s on axis axes[i] of tensor i (its batch axis)."""
    for d, s, a in zip(dst, src, axes):
        shape = [1] * d.ndim
        shape[a] = -1
        torch.where(mask.reshape(shape), s, d, out=d)


class _Shard:
    """One device's part of the engine: its copy of the params and the VQ
    state, and the caches of its slot range `rows`."""

    def __init__(self, model, params, vq_state, rows: range, mode: str,
                 n: Optional[int], dtype):
        self.model, self.device, self.rows = model, model.device, rows
        self.mode, self.n, self.dtype = mode, n, dtype
        self.params, self.vq_state = params, vq_state
        self.need_enc = mode in ("roundtrip", "encode")
        self.need_dec = mode in ("roundtrip", "decode")
        self.axes_enc, self.axes_dec = model.cache_axes()
        self.alloc()

    def alloc(self) -> None:
        ce, cd = self.model.init_cache(len(self.rows), self.dtype,
                                       self.device)
        ce1, cd1 = self.model.init_cache(1, self.dtype, self.device)
        self.cache_enc = ce if self.need_enc else []
        self.cache_dec = cd if self.need_dec else []
        # per-slot init rows: a reset is a masked select against them
        self.init_enc = ce1 if self.need_enc else []
        self.init_dec = cd1 if self.need_dec else []

    def upload(self, batch: "_Batch"):
        """This shard's rows of the tick's frames and masks, on its
        device."""
        r = slice(self.rows.start, self.rows.stop)
        x = batch.x[:, r] if self.mode == "decode" else batch.x[r]
        reset = batch.reset_mask[r]
        return (torch.from_numpy(np.ascontiguousarray(x)).to(self.device),
                torch.from_numpy(batch.active_mask[r]).to(self.device),
                torch.from_numpy(reset).to(self.device), bool(reset.any()))

    @torch.no_grad()
    def step(self, x: torch.Tensor, active_m: torch.Tensor,
             reset_m: torch.Tensor, any_reset: bool) -> torch.Tensor:
        model, n = self.model, self.n
        params, vq_state = self.params, self.vq_state
        if any_reset:
            _select_rows(self.cache_enc,
                         [i.expand_as(c) for i, c in
                          zip(self.init_enc, self.cache_enc)], reset_m,
                         self.axes_enc)
            _select_rows(self.cache_dec,
                         [i.expand_as(c) for i, c in
                          zip(self.init_dec, self.cache_dec)], reset_m,
                         self.axes_dec)
        if self.mode == "roundtrip":
            tok, wav, ce, cd = model.encode_decode_stream(
                params, vq_state, _dec16(x).to(self.dtype),
                list(self.cache_enc), list(self.cache_dec), n=n)
            _select_rows(self.cache_enc, ce, active_m, self.axes_enc)
            _select_rows(self.cache_dec, cd, active_m, self.axes_dec)
            # tokens ride as extra int16 columns after the hop PCM samples,
            # so the host fetch is one transfer: [S, 1, hop + n_q]
            return torch.cat([_enc16(wav),
                              tok.permute(1, 2, 0).to(torch.int16)], dim=-1)
        if self.mode == "encode":
            tok, ce = model.encode_stream(params, vq_state,
                                          _dec16(x).to(self.dtype),
                                          list(self.cache_enc), n=n)
            _select_rows(self.cache_enc, ce, active_m, self.axes_enc)
            return tok.to(torch.int16)                    # [n_q, S, 1]
        wav, cd = model.decode_stream(params, vq_state, x.long(),
                                      list(self.cache_dec))
        _select_rows(self.cache_dec, cd, active_m, self.axes_dec)
        return _enc16(wav)                                # [S, 1, hop]


class SlotEngine:
    """S-slot streaming codec engine around one frame step.

    mode: "roundtrip" (PCM in -> tokens + PCM out), "encode" (PCM in ->
    tokens out), "decode" (tokens in -> PCM out). `n` pins the quantizer
    count (bandwidth); None = the model's full stack. `dtype`: the frame
    step's dtype (caches, params and PCM; see the module note). `devices`:
    the devices the slots are split over, evenly (default: CUDA alone;
    see the module note).
    """

    def __init__(self, model, params, vq_state, *, slots: int = 8,
                 n: Optional[int] = None, mode: str = "roundtrip",
                 fold: bool = True, dtype=torch.float32,
                 max_queue: int = 1024,
                 devices: Optional[Sequence] = None):
        if mode not in ("roundtrip", "encode", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        devs = ([resolve_device(None)] if devices is None
                else [torch.device(d) for d in devices])
        if any(d.type == "cuda" for d in devs):
            set_f32_parity_mode()
        self.model = model
        self.mode = mode
        self.slots = slots
        self.n = n
        self.hop = model.hop_length
        self.n_q = n if n is not None else model.vq.num_quantizers
        self.max_queue = max_queue
        if fold:
            params = model.fold_params(params)
        if dtype != torch.float32:
            params = cast_streaming_params(params, dtype, kernels_only=False)
        self.dtype = dtype
        self._shards = [_Shard(m, p, v, rows, mode, n, dtype)
                        for m, p, v, rows in place_shards(
                            model, params, vq_state, devs, slots)]

        # host state, mutated only under _lock (collect/attach/detach);
        # run() touches device caches only, serialized by the tick owner
        self._lock = threading.Lock()
        self._free = list(range(slots - 1, -1, -1))
        self._queues: Dict[int, collections.deque] = {}
        self._to_reset: set = set()
        self._seq: Dict[int, int] = {}
        # running sums of the host's time: run()'s three phases, collect()
        # and, per frame collected, its wait in its slot's queue
        self.stats = {"ticks": 0, "frames": 0, "tick_s_sum": 0.0,
                      "tick_s_max": 0.0, "up_s_sum": 0.0,
                      "dispatch_s_sum": 0.0, "fetch_s_sum": 0.0,
                      "collect_s_sum": 0.0, "wait_s_sum": 0.0}

    @property
    def devices(self) -> List[torch.device]:
        return [sh.device for sh in self._shards]

    @property
    def _cache_enc(self) -> List[torch.Tensor]:
        return [c for sh in self._shards for c in sh.cache_enc]

    @property
    def _cache_dec(self) -> List[torch.Tensor]:
        return [c for sh in self._shards for c in sh.cache_dec]

    # ------------------------------------------------------------ host side

    def attach(self) -> int:
        """Claim a slot; its cache rows reset inside the next tick."""
        with self._lock:
            if not self._free:
                raise RuntimeError(f"all {self.slots} slots busy")
            slot = self._free.pop()
            self._queues[slot] = collections.deque()
            self._to_reset.add(slot)
            self._seq[slot] = 0
            return slot

    def detach(self, slot: int) -> None:
        with self._lock:
            self._queues.pop(slot, None)
            self._to_reset.discard(slot)
            self._seq.pop(slot, None)
            if slot not in self._free:
                self._free.append(slot)

    def submit(self, slot: int, frame: np.ndarray) -> None:
        """Queue one frame. encode/roundtrip: [hop] int16 PCM (float input
        is quantized to the int16 wire format here). decode: [n_q] int
        tokens."""
        frame = np.asarray(frame)
        if self.mode != "decode":
            if frame.dtype != np.int16:
                frame = np.clip(np.round(frame.astype(np.float64) * 32768.0),
                                -32768, 32767).astype(np.int16)
        else:
            frame = frame.astype(np.int16)
        with self._lock:
            q = self._queues.get(slot)
            if q is None:
                raise KeyError(f"slot {slot} not attached")
            if len(q) >= self.max_queue:
                raise RuntimeError(f"slot {slot} queue over {self.max_queue}")
            q.append((frame, time.perf_counter()))

    def pending(self) -> bool:
        with self._lock:
            return any(self._queues.values()) or bool(self._to_reset)

    def collect(self) -> Optional[_Batch]:
        """Snapshot <=1 frame per slot + pending resets for one tick."""
        t0 = time.perf_counter()
        with span("slot_engine.collect"):
            batch = self._collect(t0)
        self.stats["collect_s_sum"] += time.perf_counter() - t0
        return batch

    def _collect(self, now: float) -> Optional[_Batch]:
        with self._lock:
            if not (any(self._queues.values()) or self._to_reset):
                return None
            active, frames, wait = [], {}, 0.0
            for slot, q in self._queues.items():
                if q:
                    active.append(slot)
                    frames[slot], t_sub = q.popleft()
                    wait += now - t_sub
            reset_m = np.zeros(self.slots, bool)
            for slot in self._to_reset:
                reset_m[slot] = True
            self._to_reset.clear()
            seq = {s: self._seq[s] for s in active}
            for s in active:
                self._seq[s] += 1
        self.stats["wait_s_sum"] += wait
        active_m = np.zeros(self.slots, bool)
        active_m[active] = True
        if self.mode == "decode":
            x = np.zeros((self.n_q, self.slots, 1), np.int16)
            for s in active:
                x[:, s, 0] = frames[s]
        else:
            x = np.zeros((self.slots, 1, self.hop), np.int16)
            for s in active:
                x[s, 0, :] = frames[s]
        return _Batch(x=x, active=sorted(active), active_mask=active_m,
                      reset_mask=reset_m, seq=seq)

    def run(self, batch: _Batch) -> Dict[int, dict]:
        """Execute one tick; returns {slot: {"tokens":..., "pcm":..., "seq":}}.
        Must not run concurrently with itself (one tick owner)."""
        t0 = time.perf_counter()
        with span("slot_engine.upload"):
            inputs = [sh.upload(batch) for sh in self._shards]
        t_up = time.perf_counter()
        # every shard's step is launched before any output is fetched
        with span("slot_engine.step"):
            ys = [sh.step(*inp) for sh, inp in zip(self._shards, inputs)]
        t_disp = time.perf_counter()
        with span("slot_engine.fetch"):
            ys = [y.cpu().numpy() for y in ys]
            y = ys[0] if len(ys) == 1 else np.concatenate(
                ys, axis=1 if self.mode == "encode" else 0)
            out: Dict[int, dict] = {}
            for s in batch.active:
                if self.mode == "roundtrip":
                    out[s] = {"tokens": y[s, 0, self.hop:],
                              "pcm": y[s, 0, :self.hop], "seq": batch.seq[s]}
                elif self.mode == "encode":
                    out[s] = {"tokens": y[:, s, 0], "seq": batch.seq[s]}
                else:
                    out[s] = {"pcm": y[s, 0], "seq": batch.seq[s]}
        t1 = time.perf_counter()
        st = self.stats
        st["ticks"] += 1
        st["frames"] += len(batch.active)
        st["tick_s_sum"] += t1 - t0
        st["tick_s_max"] = max(st["tick_s_max"], t1 - t0)
        st["up_s_sum"] += t_up - t0
        st["dispatch_s_sum"] += t_disp - t_up
        st["fetch_s_sum"] += t1 - t_disp
        return out

    def tick(self) -> Dict[int, dict]:
        batch = self.collect()
        return self.run(batch) if batch is not None else {}

    def warmup(self) -> float:
        """Run the slot step once on an all-inactive tick (masks all false,
        state-preserving), so the first client frame finds the kernels
        built and the allocator warm. Returns the wall seconds spent."""
        t0 = time.perf_counter()
        if self.mode == "decode":
            x = np.zeros((self.n_q, self.slots, 1), np.int16)
        else:
            x = np.zeros((self.slots, 1, self.hop), np.int16)
        off = np.zeros(self.slots, bool)
        self.run(_Batch(x=x, active=[], active_mask=off, reset_mask=off))
        return time.perf_counter() - t0

    def recover(self) -> None:
        """Rebuild the device caches after a failed step (which may have
        left them half updated) and mark every attached slot for a reset,
        so the engine keeps serving: streams restart, the process lives."""
        for sh in self._shards:
            sh.alloc()
        with self._lock:
            # queued host-side frames stay valid and are still answered
            for slot in self._queues:
                self._to_reset.add(slot)
