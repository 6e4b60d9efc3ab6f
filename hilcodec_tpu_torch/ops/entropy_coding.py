"""Arithmetic (range) coding for RVQ token streams (the port's copy of
`hilcodec_tpu/ops/entropy_coding.py`, numpy only).

A binary arithmetic coder (Witten-Neal-Cleary renormalization, 32-bit
registers) plus deterministic probability quantization turn the token
LM's probabilities into a bitstream with an exact decode roundtrip. The
Python classes define the format; `ops/native_coder.py` runs the same
coder in C++ (`csrc/rangecoder.cpp`), bit-identical.

Determinism contract: encoder and decoder must derive IDENTICAL cdfs per
symbol. quantize_cdf is integer-exact given identical float probs, so both
sides must compute probs with the same program on the same device (the
entropy_code CLI steps the LM identically in both directions).

`encode_symbols` / `decode_symbols` take `native`: True (the default)
runs the C++ coder, built on first use, and raises when it cannot be
built or the cdfs are ragged; False runs the Python coder. Neither falls
back to the other.
"""

from __future__ import annotations

from typing import List

import numpy as np

_BITS = 32
_FULL = (1 << _BITS) - 1
_HALF = 1 << (_BITS - 1)
_QUARTER = 1 << (_BITS - 2)


def quantize_cdf(probs: np.ndarray, precision: int = 16) -> np.ndarray:
    """Float probabilities [card] -> integer cdf [card+1] with total
    2**precision; every symbol gets frequency >= 1 (decodability), the
    quantization remainder lands on the most probable symbol."""
    card = len(probs)
    total = 1 << precision
    assert total > 2 * card, "precision too small for the alphabet"
    p = np.asarray(probs, np.float64)
    p = p / max(p.sum(), 1e-30)
    freqs = np.maximum(1, np.floor(p * (total - card)).astype(np.int64))
    freqs[int(np.argmax(freqs))] += total - int(freqs.sum())
    cdf = np.zeros(card + 1, np.int64)
    np.cumsum(freqs, out=cdf[1:])
    return cdf


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0
        self._n = 0

    def write(self, bit: int) -> None:
        self._acc = (self._acc << 1) | bit
        self._n += 1
        if self._n == 8:
            self._bytes.append(self._acc)
            self._acc = 0
            self._n = 0

    def getvalue(self) -> bytes:
        if self._n:
            return bytes(self._bytes) + bytes(
                [self._acc << (8 - self._n)])
        return bytes(self._bytes)

    def __len__(self) -> int:
        return len(self._bytes) * 8 + self._n


class BitReader:
    def __init__(self, data: bytes = b""):
        self._data = bytearray(data)
        self._pos = 0

    def feed(self, data: bytes) -> None:
        """Append bytes (live decoding: the stream grows as the encoder
        settles bits)."""
        self._data.extend(data)

    def avail_bits(self) -> int:
        """Bits not yet consumed. The zero-padding in read() is only valid
        at the encoder's final flush — a live decoder must keep a safety
        margin of available bits before decoding a symbol (see
        serve/entropy_live.py)."""
        return len(self._data) * 8 - self._pos

    def read(self) -> int:
        byte_i, bit_i = divmod(self._pos, 8)
        self._pos += 1
        if byte_i >= len(self._data):
            return 0                      # zero-padding past the end
        return (self._data[byte_i] >> (7 - bit_i)) & 1


class ArithmeticEncoder:
    """Classic arithmetic coder with E1/E2/E3 renormalization."""

    def __init__(self):
        self._low = 0
        self._high = _FULL
        self._pending = 0
        self._out = BitWriter()
        self._taken = 0

    def _emit(self, bit: int) -> None:
        self._out.write(bit)
        inv = 1 - bit
        while self._pending:
            self._out.write(inv)
            self._pending -= 1

    def encode(self, cdf: np.ndarray, symbol: int) -> None:
        total = int(cdf[-1])
        span = self._high - self._low + 1
        self._high = self._low + span * int(cdf[symbol + 1]) // total - 1
        self._low = self._low + span * int(cdf[symbol]) // total
        while True:
            if self._high < _HALF:
                self._emit(0)
            elif self._low >= _HALF:
                self._emit(1)
                self._low -= _HALF
                self._high -= _HALF
            elif self._low >= _QUARTER and self._high < 3 * _QUARTER:
                self._pending += 1
                self._low -= _QUARTER
                self._high -= _QUARTER
            else:
                break
            self._low <<= 1
            self._high = (self._high << 1) | 1

    def settled_bytes(self) -> bytes:
        """Fully-settled output bytes so far, incrementally: returns only
        bytes not handed out by a previous call (live streaming — these
        will never change; the final finish() tail comes separately)."""
        out = bytes(self._out._bytes[self._taken:])
        self._taken += len(out)
        return out

    def finish(self) -> bytes:
        # disambiguate the final interval with two bits
        self._pending += 1
        self._emit(0 if self._low < _QUARTER else 1)
        return self._out.getvalue()

    def finish_tail(self) -> bytes:
        """finish() for the incremental consumer: only the bytes after the
        last settled_bytes() call (incl. the final partial byte)."""
        blob = self.finish()
        return blob[self._taken:]


class ArithmeticDecoder:
    def __init__(self, data):
        """data: bytes, or a BitReader (live decoding — feed() it)."""
        self._in = data if isinstance(data, BitReader) else BitReader(data)
        self._low = 0
        self._high = _FULL
        self._code = 0
        for _ in range(_BITS):
            self._code = (self._code << 1) | self._in.read()

    def decode(self, cdf: np.ndarray) -> int:
        total = int(cdf[-1])
        span = self._high - self._low + 1
        value = ((self._code - self._low + 1) * total - 1) // span
        symbol = int(np.searchsorted(cdf, value, side="right")) - 1
        self._high = self._low + span * int(cdf[symbol + 1]) // total - 1
        self._low = self._low + span * int(cdf[symbol]) // total
        while True:
            if self._high < _HALF:
                pass
            elif self._low >= _HALF:
                self._low -= _HALF
                self._high -= _HALF
                self._code -= _HALF
            elif self._low >= _QUARTER and self._high < 3 * _QUARTER:
                self._low -= _QUARTER
                self._high -= _QUARTER
                self._code -= _QUARTER
            else:
                break
            self._low <<= 1
            self._high = (self._high << 1) | 1
            self._code = (self._code << 1) | self._in.read()
        return symbol


def _stacked(cdfs) -> "np.ndarray | None":
    """cdfs -> [n, card+1] int64 contiguous, or None if ragged.

    Accepts a pre-stacked [n, card+1] array (free passthrough — the LM
    batch path produces one), a list whose rows are all the SAME array
    object (one tile instead of n Python-level copies), or a general list
    of [card+1] rows. The fast paths matter: stacking 3000 rows in Python
    used to cost 10x the native encode itself."""
    if isinstance(cdfs, np.ndarray):
        if cdfs.ndim != 2:
            return None
        return np.ascontiguousarray(cdfs, np.int64)
    if not len(cdfs):
        return None
    first = cdfs[0]
    if all(c is first for c in cdfs):
        row = np.asarray(first, np.int64)
        return np.ascontiguousarray(
            np.broadcast_to(row, (len(cdfs), len(row))))
    k = len(first)
    if any(len(c) != k for c in cdfs):
        return None
    return np.stack([np.asarray(c, np.int64) for c in cdfs])


def _native_cdfs(cdfs) -> np.ndarray:
    stacked = _stacked(cdfs)
    if stacked is None:
        raise ValueError("the native coder takes one alphabet for every "
                         "symbol: ragged cdfs need native=False")
    return stacked


def encode_symbols(symbols: np.ndarray, cdfs: List[np.ndarray],
                   native: bool = True) -> bytes:
    """symbols [n] under cdfs [n, card+1] -> bytes: the C++ coder
    (csrc/rangecoder.cpp, bit-identical; raises if it cannot be built),
    or with native=False the Python coder above."""
    if native:
        from . import native_coder
        return native_coder.encode(np.asarray(symbols).ravel(),
                                   _native_cdfs(cdfs))
    enc = ArithmeticEncoder()
    for s, cdf in zip(np.asarray(symbols).ravel(), cdfs):
        enc.encode(cdf, int(s))
    return enc.finish()


def decode_symbols(data: bytes, cdfs: List[np.ndarray],
                   native: bool = True) -> np.ndarray:
    if native:
        from . import native_coder
        return native_coder.decode(data, _native_cdfs(cdfs))
    dec = ArithmeticDecoder(data)
    return np.array([dec.decode(cdf) for cdf in cdfs], np.int64)
