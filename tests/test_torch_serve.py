"""Port serving on the CPU: SlotEngine slots against solo streams, the int16
wire, and one TCP roundtrip through the port's CodecServer.

A stream multiplexed through the S-slot engine (attaching mid-flight,
skipping ticks, sharing ticks, reusing a dirtied slot) must give exactly
the tokens and the int16 PCM of the same stream run alone through the
port's encode_stream / decode_stream, its float output rounded on the
host. That holds bitwise because on the CPU every layer of the frame step
computes a row the same way whatever the batch (ops/conv.py: pointwise
convs as fixed-size row-block matmuls, the 1-channel conv_post as a tap
sum and one channel reduction; oneDNN's convolution picked its kernel by
batch size there).
The wire conversion itself is exact: it rounds half to even, as np.round
does. Mirrors tests/test_serve.py.

EnCodec's caches put the slot on axis 1 of its LSTM state ([layers, S, H])
and on axis 0 elsewhere; the engine selects each tensor on its own axis.
Its engine streams equal the port's solo streams bitwise and the JAX
package's solo `encode_decode_stream` within 1e-5 (the JAX engine itself
cannot serve EnCodec: it masks axis 0 of every cache).
"""

import asyncio
import json
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.models.encodec import EncodecModel as JaxEncodecModel
from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ

from hilcodec_tpu_torch.models.codec import CodecModel, slot_axes
from hilcodec_tpu_torch.models.encodec import EncodecModel
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.ops import rvq_kernel
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.serve import CodecServer, SlotEngine
from hilcodec_tpu_torch.utils import params as P

from torch_port_common import jax_tree, seeded_flat

CPU = torch.device("cpu")
# a two-stage EnCodec with a 2-layer LSTM of width 32 (reflect padding)
ENCODEC = dict(channels_enc=8, channels_dec=8, strides=(4, 2), lstm=2,
               vq_dim=16, n_residual_layers=1)
ENCODEC_VQ = dict(dim=16, codebook_size=32, num_quantizers=4,
                  kmeans_init=False)
# three streams attach at different ticks, share and skip ticks, and
# detach at different times (at most three at once)
SCHEDULE = [("a",), ("a", "b"), ("a", "b"), ("a", "b", "c"), ("a", "c"),
            ("a", "b", "c"), ("b", "c"), ("b", "c"), ("c",)]


@pytest.fixture(scope="module")
def tiny():
    model = CodecModel(
        HILCodec(channels_enc=8, channels_dec=8, n_residual_enc=1,
                 n_residual_dec=1, strides=(4, 2), n_fft_base=16, vq_dim=16,
                 res_scale_enc=0.577, res_scale_dec=0.577),
        ResidualVQ(dim=16, codebook_size=32, num_quantizers=3,
                   kmeans_init=False), CPU)
    gen = torch.Generator().manual_seed(0)
    params, vq_state = model.init(gen)
    vq_state["embed"] = vq_state["embed"] * 2.0
    return model, params, vq_state


@pytest.fixture(scope="module")
def encodec():
    """A tiny EnCodec on both sides with JAX's seeded params and N(0, 1/4)
    codebooks."""
    jm = JaxCodecModel(JaxEncodecModel(**ENCODEC),
                       JaxResidualVQ(**ENCODEC_VQ))
    model = CodecModel(EncodecModel(**ENCODEC), ResidualVQ(**ENCODEC_VQ),
                       CPU)
    template, _ = jm.init(jax.random.PRNGKey(0))
    flat = seeded_flat(template)
    params = P.from_flat(flat, model.param_template(False))
    books = (np.random.default_rng(1).standard_normal((4, 32, 16)) * 0.5
             ).astype(np.float32)
    return (model, params, {"embed": torch.from_numpy(books)}, jm,
            jax_tree(template, flat))


def _q16(x):
    return np.clip(np.round(np.asarray(x, np.float64) * 32768.0),
                   -32768, 32767).astype(np.int16)


def _dq16(x16):
    return x16.astype(np.float32) / 32768.0


def _assert_pcm(pcm, ref_pcm):
    """Engine int16 PCM equals the solo float output rounded on the host."""
    assert pcm.shape == ref_pcm.shape
    np.testing.assert_array_equal(pcm, _q16(ref_pcm))


def _frames(wav, hop):
    return [wav[i * hop:(i + 1) * hop] for i in range(len(wav) // hop)]


def _stream_ref(model, params, vq_state, wav, mode="roundtrip"):
    """Single-stream oracle through the port's plain drivers (folded
    params, as the engine's fold=True default)."""
    fp = model.fold_params(params)
    ce, cd = model.init_cache(1)
    with torch.no_grad():
        tok, _ = model.encode_stream(fp, vq_state,
                                     torch.from_numpy(wav)[None, None], ce)
        if mode == "encode":
            return tok.numpy()[:, 0, :]
        out, _ = model.decode_stream(fp, vq_state, tok, cd)
    return tok.numpy()[:, 0, :], out.numpy()[0, 0]


def _run_schedule(eng, frames, schedule):
    """Attach each stream at its first tick, detach it after its last
    frame; returns {stream: (tokens [n_q, L], pcm [L*hop])}."""
    got = {k: {"tokens": [], "pcm": []} for k in frames}
    slot_of, cursor = {}, {k: 0 for k in frames}
    for tick_streams in schedule:
        for k in tick_streams:
            if k not in slot_of:
                slot_of[k] = eng.attach()
            eng.submit(slot_of[k], frames[k][cursor[k]])
            cursor[k] += 1
        out = eng.tick()
        for k in tick_streams:
            got[k]["tokens"].append(out[slot_of[k]]["tokens"])
            got[k]["pcm"].append(out[slot_of[k]]["pcm"])
        for k, i in cursor.items():
            if k in slot_of and i == len(frames[k]):
                eng.detach(slot_of.pop(k))
    return {k: (np.stack(v["tokens"], axis=1), np.concatenate(v["pcm"]))
            for k, v in got.items()}


def test_engine_parity_staggered_streams(tiny, rng):
    """Three streams attach at different ticks, skip ticks and detach at
    different times; each one's tokens and int16 PCM equal its solo run."""
    model, params, vq_state = tiny
    hop = model.hop_length
    eng = SlotEngine(model, params, vq_state, slots=4, mode="roundtrip",
                     devices=["cpu"])
    wavs = {k: (rng.standard_normal(hop * 6) * 0.3).astype(np.float32)
            for k in "abc"}
    got = _run_schedule(eng, {k: _frames(w, hop) for k, w in wavs.items()},
                        SCHEDULE)
    for k, w in wavs.items():
        ref_tok, ref_pcm = _stream_ref(model, params, vq_state,
                                       _dq16(_q16(w)))
        np.testing.assert_array_equal(got[k][0], ref_tok)
        _assert_pcm(got[k][1], ref_pcm)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_frame_step_rows_do_not_depend_on_the_batch(tiny, part):
    """A frame step at batch 4 gives each row bitwise what that row gives
    alone, output and every cache tensor, over three frames."""
    model, params, _ = tiny
    fp = model.fold_params(params)[part]
    layer = getattr(model.codec, part)
    rng = np.random.default_rng(7)
    shape = ((4, 1, model.hop_length) if part == "encoder"
             else (4, layer.dimension, 1))
    c4 = layer.init_cache(4)
    c1 = [layer.init_cache(1) for _ in range(4)]
    with torch.no_grad():
        for _ in range(3):
            x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            y4, c4 = layer.step(fp, c4, x)
            for r in range(4):
                y1, c1[r] = layer.step(fp, c1[r], x[r:r + 1])
                assert torch.equal(y4[r:r + 1], y1)
                assert all(torch.equal(a[r:r + 1], b)
                           for a, b in zip(c4, c1[r]))


def test_int16_wire_matches_host_rounding():
    """The device-side conversion equals np.round + clip on the host,
    half-way values and out-of-range values included."""
    from hilcodec_tpu_torch.serve.engine import _dec16, _enc16
    k = np.arange(-40000, 40000, 7, dtype=np.float64)
    x = np.concatenate([k / 32768.0, (k + 0.5) / 32768.0]).astype(np.float32)
    np.testing.assert_array_equal(_enc16(torch.from_numpy(x)).numpy(),
                                  _q16(x))
    pcm = np.arange(-32768, 32768, dtype=np.int16)
    np.testing.assert_array_equal(_dec16(torch.from_numpy(pcm)).numpy(),
                                  _dq16(pcm))


def test_skipped_tick_leaves_state_unchanged(tiny, rng):
    """A tick in which a slot has no frame leaves its cache rows exactly as
    they were; other slots' rows move on."""
    model, params, vq_state = tiny
    hop = model.hop_length
    eng = SlotEngine(model, params, vq_state, slots=2, mode="roundtrip",
                     devices=["cpu"])
    a, b = eng.attach(), eng.attach()
    for _ in range(2):
        eng.submit(a, (rng.standard_normal(hop) * 0.3).astype(np.float32))
        eng.submit(b, (rng.standard_normal(hop) * 0.3).astype(np.float32))
        eng.tick()
    before = [c.clone() for c in eng._cache_enc + eng._cache_dec]
    eng.submit(b, (rng.standard_normal(hop) * 0.3).astype(np.float32))
    eng.tick()
    after = eng._cache_enc + eng._cache_dec
    assert all(torch.equal(x[a], y[a]) for x, y in zip(before, after))
    assert not all(torch.equal(x[b], y[b]) for x, y in zip(before, after))


def test_engine_slot_reuse_is_clean(tiny, rng):
    model, params, vq_state = tiny
    hop = model.hop_length
    eng = SlotEngine(model, params, vq_state, slots=1, mode="roundtrip",
                     devices=["cpu"])
    s = eng.attach()
    for f in _frames((rng.standard_normal(hop * 3) * 0.5
                      ).astype(np.float32), hop):
        eng.submit(s, f)
        eng.tick()
    eng.detach(s)
    fresh = (rng.standard_normal(hop * 4) * 0.3).astype(np.float32)
    ref_tok, ref_pcm = _stream_ref(model, params, vq_state,
                                   _dq16(_q16(fresh)))
    s2 = eng.attach()
    assert s2 == s
    toks, pcms = [], []
    for f in _frames(fresh, hop):
        eng.submit(s2, f)
        res = eng.tick()[s2]
        toks.append(res["tokens"])
        pcms.append(res["pcm"])
    np.testing.assert_array_equal(np.stack(toks, axis=1), ref_tok)
    _assert_pcm(np.concatenate(pcms), ref_pcm)


def test_engine_encode_and_decode_modes(tiny, rng):
    model, params, vq_state = tiny
    hop = model.hop_length
    wav = _dq16(_q16((rng.standard_normal(hop * 5) * 0.3
                      ).astype(np.float32)))
    ref_tok, ref_pcm = _stream_ref(model, params, vq_state, wav)

    enc = SlotEngine(model, params, vq_state, slots=2, mode="encode",
                     devices=["cpu"])
    s = enc.attach()
    toks = []
    for f in _frames(wav, hop):
        enc.submit(s, f)
        toks.append(enc.tick()[s]["tokens"])
    np.testing.assert_array_equal(np.stack(toks, axis=1), ref_tok)

    dec = SlotEngine(model, params, vq_state, slots=2, mode="decode",
                     devices=["cpu"])
    s = dec.attach()
    pcms = []
    for i in range(ref_tok.shape[1]):
        dec.submit(s, ref_tok[:, i])
        pcms.append(dec.tick()[s]["pcm"])
    _assert_pcm(np.concatenate(pcms), ref_pcm)


def test_engine_warmup_recover_stats(tiny, rng):
    model, params, vq_state = tiny
    hop = model.hop_length
    eng = SlotEngine(model, params, vq_state, slots=2, mode="roundtrip",
                     devices=["cpu"])
    assert eng.warmup() >= 0 and eng.stats["ticks"] == 1
    assert not any(c.any() for c in eng._cache_enc + eng._cache_dec)
    s = eng.attach()
    eng.submit(s, (rng.standard_normal(hop) * 0.3).astype(np.float32))
    eng.tick()
    eng.recover()
    assert not any(c.any() for c in eng._cache_enc + eng._cache_dec)
    assert eng.pending()          # the attached slot is marked for reset
    assert eng.stats["frames"] == 1
    eng.attach()                  # the second and last slot
    with pytest.raises(RuntimeError, match="busy"):
        eng.attach()


def test_engine_requires_cuda_unless_cpu_is_named(tiny):
    """No silent CPU fallback: device=None means CUDA and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the engine would use it")
    model, params, vq_state = tiny
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlotEngine(model, params, vq_state, slots=1)


def test_tcp_roundtrip_two_clients(tiny, rng):
    """Two clients over localhost sockets on the port's CodecServer; the
    engine on CPU tensors runs the plain quantizer and launches nothing."""
    model, params, vq_state = tiny
    hop = model.hop_length
    eng = SlotEngine(model, params, vq_state, slots=4, mode="roundtrip",
                     devices=["cpu"])
    wavs = [(rng.standard_normal(hop * 6) * 0.3).astype(np.float32)
            for _ in range(2)]
    lenf = struct.Struct("<I")

    async def client(port, frames):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b'{"mode": "auto"}\n')
        hdr = json.loads((await reader.readline()).decode())
        assert hdr["ok"] and hdr["hop"] == hop and hdr["n_q"] == 3
        toks, pcms = [], []
        for f in frames:
            writer.write(lenf.pack(f.nbytes) + f.tobytes())
            await writer.drain()
            (ln,) = lenf.unpack(await reader.readexactly(4))
            arr = np.frombuffer(await reader.readexactly(ln), np.int16)
            toks.append(arr[:3].copy())
            pcms.append(arr[3:].copy())
        writer.close()
        return np.stack(toks, axis=1), np.concatenate(pcms)

    async def go():
        srv = CodecServer(eng, sr=24000, port=0)
        await srv.start()
        try:
            return await asyncio.wait_for(asyncio.gather(
                *(client(srv.port, [_q16(f) for f in _frames(w, hop)])
                  for w in wavs)), 60)
        finally:
            await srv.stop()

    rvq_kernel.reset_launches()
    results = asyncio.run(go())
    for w, (tok, pcm) in zip(wavs, results):
        ref_tok, ref_pcm = _stream_ref(model, params, vq_state,
                                       _dq16(_q16(w)))
        np.testing.assert_array_equal(tok, ref_tok)
        _assert_pcm(pcm, ref_pcm)
    assert eng.stats["frames"] == 12 and not eng.pending()
    assert rvq_kernel.LAUNCHES[rvq_kernel.KERNEL] == 0


def test_encodec_engine_staggered_streams_at_three_slots(encodec, rng):
    """Three EnCodec streams through a 3-slot engine, attaching, sharing
    and skipping ticks: each equals its solo port stream bitwise (tokens
    and int16 PCM), and its solo JAX encode_decode_stream (tokens, and the
    float output within 1e-5)."""
    model, params, vq_state, jm, jparams = encodec
    hop = model.hop_length
    eng = SlotEngine(model, params, vq_state, slots=3, mode="roundtrip",
                     devices=["cpu"])
    wavs = {k: _dq16(_q16(rng.standard_normal(hop * 6) * 0.3))
            for k in "abc"}
    got = _run_schedule(eng, {k: _frames(w, hop) for k, w in wavs.items()},
                        SCHEDULE)
    jp = jm.fold_params(jparams)
    jv = {"embed": jnp.asarray(vq_state["embed"].numpy())}
    for k, w in wavs.items():
        ref_tok, ref_pcm = _stream_ref(model, params, vq_state, w)
        tok, pcm = got[k]
        np.testing.assert_array_equal(tok, ref_tok)
        _assert_pcm(pcm, ref_pcm)
        jtok, jwav, _, _ = jm.encode_decode_stream(
            jp, jv, jnp.asarray(w)[None, None], *jm.init_cache(1))
        np.testing.assert_array_equal(tok, np.asarray(jtok)[:, 0])
        np.testing.assert_allclose(ref_pcm, np.asarray(jwav)[0, 0], rtol=0,
                                   atol=1e-5)


def test_encodec_engine_lstm_state_rows_and_storage(encodec, rng):
    """The LSTM's h and c are distinct storage in the engine, and a tick
    in which slot 0 skips leaves its rows (axis 1 of h and c) unchanged
    while slot 1's move on."""
    model, params, vq_state, _, _ = encodec
    hop = model.hop_length
    eng = SlotEngine(model, params, vq_state, slots=2, mode="roundtrip",
                     devices=["cpu"])
    enc_axes, dec_axes = model.cache_axes()
    lstm = [c for c, ax in zip(eng._cache_enc + eng._cache_dec,
                               enc_axes + dec_axes) if ax == 1]
    assert len(lstm) == 4
    assert len({c.data_ptr() for c in eng._cache_enc + eng._cache_dec}) == \
        len(eng._cache_enc + eng._cache_dec)
    a, b = eng.attach(), eng.attach()
    for _ in range(2):
        for s in (a, b):
            eng.submit(s, (rng.standard_normal(hop) * 0.3).astype(np.float32))
        eng.tick()
    before = [c.clone() for c in lstm]
    eng.submit(b, (rng.standard_normal(hop) * 0.3).astype(np.float32))
    eng.tick()
    for x, y in zip(before, lstm):
        assert torch.equal(x[:, a], y[:, a]) and x[:, a].any()
        assert not torch.equal(x[:, b], y[:, b])


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_encodec_frame_step_rows_do_not_depend_on_the_batch(encodec, part):
    """EnCodec's dense convs and LSTM cell on the CPU: a frame step at
    batch 3 gives each row bitwise what that row gives alone."""
    model, params, _, _, _ = encodec
    fp = model.fold_params(params)[part]
    layer = getattr(model.codec, part)
    rng = np.random.default_rng(7)
    shape = ((3, 1, model.hop_length) if part == "encoder"
             else (3, layer.dimension, 1))
    c3 = layer.init_cache(3)
    c1 = [layer.init_cache(1) for _ in range(3)]
    axes = slot_axes(c1[0], c3)
    with torch.no_grad():
        for _ in range(3):
            x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            y3, c3 = layer.step(fp, c3, x)
            for r in range(3):
                y1, c1[r] = layer.step(fp, c1[r], x[r:r + 1])
                assert torch.equal(y3[r:r + 1], y1)
                assert all(torch.equal(a.narrow(ax, r, 1), b)
                           for a, b, ax in zip(c3, c1[r], axes))
