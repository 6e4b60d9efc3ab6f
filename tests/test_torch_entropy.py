"""The port's range coder and `.hilstream` container against the JAX
package's, on the CPU.

The same seeded probabilities go through both packages: `quantize_cdf`
must give identical integer cdfs, and the port's Python coder and its
native coder (the package's own copy of csrc/rangecoder.cpp, built with
g++ into `hilcodec_tpu_torch/_build/`) must write bytes identical to JAX's
Python coder (`native=False`, which needs no compiler and never skips),
and decode them back exactly. The container roundtrips, and a stream JAX
writes reads back in the port. All comparisons are exact.
"""

import os

import numpy as np
import pytest

from hilcodec_tpu.ops import entropy_coding as JE
from hilcodec_tpu.utils import bitstream as JB

from hilcodec_tpu_torch.ops import cuda_build
from hilcodec_tpu_torch.ops import entropy_coding as TE
from hilcodec_tpu_torch.ops import native_coder
from hilcodec_tpu_torch.utils import bitstream as TB


def _cases(rng):
    """(symbols, cdfs) of three kinds: uniform over 1024, a peaky 1024
    alphabet, and a fresh 64-symbol distribution every step (the LM's)."""
    uni = JE.quantize_cdf(np.full(1024, 1.0 / 1024))
    peak = np.full(1024, 0.02 / 1023)
    peak[7] = 0.98
    out = {"uniform": (rng.integers(0, 1024, 400), [uni] * 400),
           "peaky": (rng.choice(1024, 600, p=peak / peak.sum()),
                     [JE.quantize_cdf(peak)] * 600)}
    cdfs, syms = [], []
    for i in range(300):
        p = rng.dirichlet(np.ones(64) * (0.05 + (i % 7) * 0.2))
        cdfs.append(JE.quantize_cdf(p))
        syms.append(rng.choice(64, p=p))
    out["varying"] = (np.asarray(syms), cdfs)
    return out


@pytest.mark.parametrize("card,alpha", [(4, 0.1), (64, 1.0), (1024, 0.1),
                                        (1024, 10.0)])
def test_quantize_cdf_equals_jax(card, alpha, rng):
    for _ in range(5):
        p = rng.dirichlet(np.ones(card) * alpha)
        np.testing.assert_array_equal(TE.quantize_cdf(p),
                                      JE.quantize_cdf(p))
    zero = np.zeros(card)
    zero[card - 1] = 1.0
    np.testing.assert_array_equal(TE.quantize_cdf(zero),
                                  JE.quantize_cdf(zero))


@pytest.mark.parametrize("kind", ["uniform", "peaky", "varying"])
@pytest.mark.parametrize("native", [False, True])
def test_coder_bytes_equal_jax_python_coder(kind, native, rng):
    syms, cdfs = _cases(rng)[kind]
    theirs = JE.encode_symbols(syms, cdfs, native=False)
    ours = TE.encode_symbols(syms, cdfs, native=native)
    assert ours == theirs
    np.testing.assert_array_equal(
        TE.decode_symbols(theirs, cdfs, native=native), syms)


def test_native_coder_is_built_from_the_package_copy():
    """The library comes from hilcodec_tpu_torch/csrc/rangecoder.cpp, a
    byte-identical copy of the root source, into the package's _build/."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "csrc", "rangecoder.cpp"), "rb") as f:
        theirs = f.read()
    with open(cuda_build.CSRC_DIR / "rangecoder.cpp", "rb") as f:
        assert f.read() == theirs
    path, _, _ = cuda_build.build_host("rangecoder")
    assert path.parent == cuda_build.BUILD_DIR and path.exists()
    assert path.name.startswith("librangecoder-")
    assert native_coder.library() is native_coder.library()


def test_no_silent_fallback(rng):
    """Ragged cdfs cannot go through the native coder: it raises instead
    of taking the Python coder; the Python coder takes them."""
    cdfs = [TE.quantize_cdf(np.ones(4) / 4), TE.quantize_cdf(np.ones(8) / 8)]
    with pytest.raises(ValueError, match="native=False"):
        TE.encode_symbols(np.array([1, 5]), cdfs)
    data = TE.encode_symbols(np.array([1, 5]), cdfs, native=False)
    np.testing.assert_array_equal(
        TE.decode_symbols(data, cdfs, native=False), [1, 5])
    assert data == JE.encode_symbols(np.array([1, 5]), cdfs, native=False)


def test_incremental_bytes_equal_the_whole_stream(rng):
    """settled_bytes() after each symbol, then finish_tail(), concatenate
    to JAX's finish() bytes; a live BitReader decodes them back."""
    syms, cdfs = _cases(rng)["varying"]
    enc, parts = TE.ArithmeticEncoder(), []
    for s, c in zip(syms, cdfs):
        enc.encode(c, int(s))
        parts.append(enc.settled_bytes())
    parts.append(enc.finish_tail())
    assert b"".join(parts) == JE.encode_symbols(syms, cdfs, native=False)
    reader = TE.BitReader()
    for part in parts:
        reader.feed(part)
    dec = TE.ArithmeticDecoder(reader)
    np.testing.assert_array_equal([dec.decode(c) for c in cdfs], syms)


def _meta(crc):
    return dict(n_q=8, card=1024, seg_tokens=150, n_seg=3,
                sampling_rate=24000, hop=320, lm_dim=200, lm_heads=8,
                lm_layers=5, token_crc=crc)


def test_hilstream_roundtrip_and_crc(tmp_path, rng):
    tokens = rng.integers(0, 1024, (3, 8, 150))
    crc = TB.token_crc32(tokens)
    assert crc == JB.token_crc32(tokens)
    payload = bytes(rng.integers(0, 256, 77).astype(np.uint8))
    blob = TB.pack_hilstream(payload, **_meta(crc))
    assert len(blob) == TB.HEADER_BYTES + 77 == 28 + 77
    assert blob == JB.pack_hilstream(payload, **_meta(crc))
    meta, data = TB.unpack_hilstream(blob)
    assert data == payload and meta == dict(_meta(crc), version=2)
    path = str(tmp_path / "s.hilstream")
    assert TB.write_hilstream(path, payload, **_meta(crc)) == len(blob)
    assert TB.read_hilstream(path) == (meta, payload)
    with pytest.raises(ValueError, match="magic"):
        TB.unpack_hilstream(b"XXXX" + blob[4:])
    with pytest.raises(ValueError, match="missing"):
        TB.pack_hilstream(payload, n_q=8)


def test_jax_written_stream_reads_in_the_port(tmp_path, rng):
    """JAX writes a coded stream into a container; the port reads the
    header and decodes the payload (native and Python) to the tokens."""
    syms, cdfs = _cases(rng)["uniform"]
    data = JE.encode_symbols(syms, cdfs, native=False)
    path = str(tmp_path / "jax.hilstream")
    JB.write_hilstream(path, data, **_meta(JB.token_crc32(syms)))
    meta, payload = TB.read_hilstream(path)
    assert meta["token_crc"] == TB.token_crc32(syms)
    for native in (True, False):
        got = TE.decode_symbols(payload, cdfs, native=native)
        np.testing.assert_array_equal(got, syms)
        assert TB.token_crc32(got) == meta["token_crc"]
