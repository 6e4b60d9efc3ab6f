"""`.hilstream` container: a self-describing entropy-coded token bitstream
(the port's copy of `hilcodec_tpu/utils/bitstream.py`; the format is the
same, so either package reads the other's files).

The LM-driven arithmetic coder (ops/entropy_coding.py, the entropy_code
CLI) produces compressed bytes; this module gives them a container so
encode and decode can run as separate processes on the same device kind:
decodability requires bit-identical LM probabilities (the determinism
contract in ops/entropy_coding.py). Everything the decoder needs besides
the model weights (token geometry, segment layout, sample rate, and the
LM architecture that defines the shared probability model) rides in a
fixed 28-byte header, with a CRC32 of the token array so that a
probability-model mismatch fails loudly instead of decoding wrong tokens.

Format v2 (little-endian):
    0   4s  magic  b"HILS"
    4   B   version (2)
    5   B   n_q            quantizers per frame
    6   H   card           codebook size (cdf alphabet)
    8   H   seg_tokens     LM segment length S (frames per segment)
    10  I   n_seg          number of segments in the payload
    14  I   sampling_rate  output rate for the decoded wav
    18  H   hop            samples per frame (tokens -> samples)
    20  H   lm_dim         LM width   \\
    22  B   lm_heads       LM heads    } the decoder must rebuild the
    23  B   lm_layers      LM depth   /  exact probability model
    24  I   token_crc      CRC32 of the decoded tokens (token_crc32())
    28  ... payload        arithmetic-coded bytes, time-major (t, seg, q)
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, Tuple

MAGIC = b"HILS"
VERSION = 2
_HEADER = struct.Struct("<4sBBHHIIHHBBI")
HEADER_BYTES = _HEADER.size  # 28

_FIELDS = ("n_q", "card", "seg_tokens", "n_seg", "sampling_rate", "hop",
           "lm_dim", "lm_heads", "lm_layers", "token_crc")


def token_crc32(tokens) -> int:
    """Canonical token checksum: CRC32 over the int32 little-endian bytes
    of the token array in its encoded layout ([n_seg, n_q, S])."""
    import numpy as np
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
    if arr.dtype.byteorder == ">":  # big-endian host: canonicalize
        arr = arr.astype("<i4")
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


def pack_hilstream(payload: bytes, **meta: int) -> bytes:
    """Header + payload. `meta` must supply exactly the fields above."""
    unknown = set(meta) - set(_FIELDS)
    if unknown:
        raise ValueError(f"unknown hilstream fields {sorted(unknown)}")
    missing = set(_FIELDS) - set(meta)
    if missing:
        raise ValueError(f"missing hilstream fields {sorted(missing)}")
    header = _HEADER.pack(MAGIC, VERSION,
                          *(int(meta[k]) for k in _FIELDS))
    return header + payload


def unpack_hilstream(data: bytes) -> Tuple[Dict[str, Any], bytes]:
    """-> (meta dict incl. 'version', payload bytes). Validates magic."""
    if len(data) < HEADER_BYTES:
        raise ValueError(f"hilstream truncated: {len(data)} bytes "
                         f"< {HEADER_BYTES}-byte header")
    magic, version, *vals = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise ValueError(f"not a hilstream (magic {magic!r})")
    if version != VERSION:
        raise ValueError(f"unsupported hilstream version {version}")
    meta = dict(zip(_FIELDS, vals))
    meta["version"] = version
    return meta, data[HEADER_BYTES:]


def write_hilstream(path: str, payload: bytes, **meta: int) -> int:
    """-> total file bytes written."""
    blob = pack_hilstream(payload, **meta)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def read_hilstream(path: str) -> Tuple[Dict[str, Any], bytes]:
    with open(path, "rb") as f:
        return unpack_hilstream(f.read())
