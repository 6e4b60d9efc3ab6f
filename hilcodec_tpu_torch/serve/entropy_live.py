"""Live (per-frame) entropy-coded token streaming
(`hilcodec_tpu/serve/entropy_live.py`).

One frame of tokens in, settled bitstream bytes out, with the token LM
(`models/encodec.LMModel`) stepped frame by frame through its streaming
transformer state. Unlike the offline coder (the entropy_code CLI, which
batches segments time-major), this codes ONE stream with symbols in
(t, q) order; the LM state and the frame context reset every `seg_tokens`
frames, so the probabilities match the LM's training regime. Encoder and
decoder step the LM identically: the same program on the same device and
shapes (the determinism contract of ops/entropy_coding.py).

The JAX package pins its stepper to the host CPU; here it runs where the
LM's params lie (the entry point's device, the card by default).

Latency: the arithmetic coder emits bits only as intervals settle, so the
decoder keeps a margin of available bits before it decodes a frame
(`BitReader` zero-pads only at the final flush); `finish()` flushes the
tail, so the stream always drains exactly.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.entropy_coding import (ArithmeticDecoder, ArithmeticEncoder,
                                  BitReader, quantize_cdf)

# bits a single decode step may need beyond its symbol's settled bits
# (interval precision 16 + renormalization slack); per frame: n_q symbols
_MARGIN_BITS_PER_SYMBOL = 64


def lm_stepper(lm, lm_params):
    """One-frame LM step on the device of `lm_params`: (prev_tokens [n_q]
    or None, states, offset) -> (probs [card, n_q] f64, states, offset).
    States threading mirrors entropy_code's teacher forcing shifted by one
    frame; states=None on a segment's first frame reproduces the batched
    apply's zero state (one zero frame attended at position -1)."""
    device = lm_params["emb"].device

    @torch.no_grad()
    def run(prev: Optional[np.ndarray], states, offset):
        if prev is None:
            idx = torch.zeros((1, lm.n_q, 1), dtype=torch.long,
                              device=device)            # 0 = missing
        else:
            idx = torch.from_numpy(np.asarray(prev, np.int64).reshape(
                1, lm.n_q, 1) + 1).to(device)
        probs, states, offset = lm.apply(lm_params, idx, states, offset)
        return (probs[0, :, :, 0].cpu().numpy().astype(np.float64),
                states, offset)

    return run


class LiveTokenEncoder:
    """Feed one [n_q] token frame at a time; get settled bytes back."""

    def __init__(self, lm, lm_params, seg_tokens: int = 150):
        self.n_q, self.card = lm.n_q, lm.card
        self.seg_tokens = seg_tokens
        self._run = lm_stepper(lm, lm_params)
        self._enc = ArithmeticEncoder()
        self._t = 0
        self._states = None
        self._offset = 0
        self._prev: Optional[np.ndarray] = None
        self.frames = 0

    def push(self, tokens: np.ndarray) -> bytes:
        tokens = np.asarray(tokens).reshape(self.n_q)
        if self._t == self.seg_tokens:     # segment boundary: reset the LM
            self._t, self._states, self._offset, self._prev = \
                0, None, 0, None
        probs, self._states, self._offset = self._run(
            self._prev, self._states, self._offset)
        for q in range(self.n_q):
            self._enc.encode(quantize_cdf(probs[:, q]), int(tokens[q]))
        self._prev = tokens
        self._t += 1
        self.frames += 1
        return self._enc.settled_bytes()

    def finish(self) -> bytes:
        return self._enc.finish_tail()


class LiveTokenDecoder:
    """feed() bytes as they arrive; pull() yields every frame decodable
    within the safety margin (all of them once finished=True)."""

    def __init__(self, lm, lm_params, seg_tokens: int = 150):
        self.n_q, self.card = lm.n_q, lm.card
        self.seg_tokens = seg_tokens
        self._run = lm_stepper(lm, lm_params)
        self._reader = BitReader()
        self._dec: Optional[ArithmeticDecoder] = None
        self._t = 0
        self._states = None
        self._offset = 0
        self._prev: Optional[np.ndarray] = None
        self._finished = False
        self.frames = 0

    def feed(self, data: bytes, finished: bool = False) -> None:
        self._reader.feed(data)
        self._finished = self._finished or finished

    def _decode_one(self) -> np.ndarray:
        if self._dec is None:
            self._dec = ArithmeticDecoder(self._reader)
        if self._t == self.seg_tokens:
            self._t, self._states, self._offset, self._prev = \
                0, None, 0, None
        probs, self._states, self._offset = self._run(
            self._prev, self._states, self._offset)
        frame = np.empty(self.n_q, np.int64)
        for q in range(self.n_q):
            frame[q] = self._dec.decode(quantize_cdf(probs[:, q]))
        self._prev = frame
        self._t += 1
        self.frames += 1
        return frame

    def pull(self, max_frames: Optional[int] = None) -> List[np.ndarray]:
        """Live mode: every frame whose bits are safely settled. The format
        has no in-band terminator (zero padding is valid at the flush), so
        after finish() the caller bounds the count: pull_n with the frame
        count from the container header or the protocol."""
        need = _MARGIN_BITS_PER_SYMBOL * self.n_q + 32
        out: List[np.ndarray] = []
        while max_frames is None or len(out) < max_frames:
            if self._reader.avail_bits() < need and not (
                    self._finished and max_frames is not None):
                break
            if self._finished and self._reader.avail_bits() <= 0 \
                    and max_frames is None:
                break
            out.append(self._decode_one())
        return out

    def pull_n(self, n: int) -> List[np.ndarray]:
        """Decode exactly n more frames; needs finished=True or enough fed
        bytes."""
        out: List[np.ndarray] = []
        while len(out) < n:
            got = self.pull(max_frames=n - len(out))
            if not got:
                raise RuntimeError(
                    f"stream under-run: {len(out)}/{n} frames decoded, "
                    f"{self._reader.avail_bits()} bits available")
            out.extend(got)
        return out
