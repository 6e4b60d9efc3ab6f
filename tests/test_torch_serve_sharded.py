"""Slot sharding on the CPU: `SlotEngine(devices=[...])` against the
unsharded engine, bitwise, for the flagship family (every mode) and for
EnCodec, whose LSTM state is split on its own batch axis (axis 1); the
flagship's sharded engine against the JAX engine's `mesh=` on two CPU
devices; the divisibility check; and the bench's `--mesh` on the CPU.

Two CPU shards of one engine compute each slot as the unsharded engine
does, because on the CPU every layer of the frame step computes a row the
same way whatever the batch (tests/test_torch_serve.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hilcodec_tpu.serve.engine import SlotEngine as JaxSlotEngine

from hilcodec_tpu_torch import bench
from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.parallel.dist import place_shards
from hilcodec_tpu_torch.serve import SlotEngine

from test_torch_serve import (SCHEDULE, _dq16, _frames, _q16, _run_schedule,
                              encodec, tiny)  # noqa: F401 (fixtures)
from torch_port_common import both_params, codebooks, models

SHARDS = ["cpu", "cpu"]


def _narrow_flagship(device):
    """The flagship's strides (hop 320) at width 4: 0.2 s of audio is 15
    frames."""
    return CodecModel(
        HILCodec(channels_enc=4, channels_dec=4, n_residual_enc=1,
                 n_residual_dec=1, vq_dim=16, res_scale_enc=0.577,
                 res_scale_dec=0.577),
        ResidualVQ(dim=16, codebook_size=32, num_quantizers=3,
                   kmeans_init=False), device)


def _schedule_frames(hop, seed=0):
    rng = np.random.default_rng(seed)
    return {k: _frames(_dq16(_q16(rng.standard_normal(hop * 6) * 0.3)), hop)
            for k in "abc"}


def _engines(model, params, vq_state, slots, **kw):
    return (SlotEngine(model, params, vq_state, slots=slots,
                       devices=["cpu"], **kw),
            SlotEngine(model, params, vq_state, slots=slots,
                       devices=SHARDS, **kw))


def test_roundtrip_sharded_equals_unsharded(tiny):
    """The staggered schedule of tests/test_torch_serve.py (streams on both
    shards: slots 0-1 on the first, 2-3 on the second)."""
    model, params, vq_state = tiny
    plain, sharded = _engines(model, params, vq_state, 4)
    assert sharded.devices == [torch.device("cpu")] * 2
    frames = _schedule_frames(model.hop_length)
    a = _run_schedule(plain, frames, SCHEDULE)
    b = _run_schedule(sharded, frames, SCHEDULE)
    for k in frames:
        np.testing.assert_array_equal(a[k][0], b[k][0])
        np.testing.assert_array_equal(a[k][1], b[k][1])
    assert plain.stats["frames"] == sharded.stats["frames"] == 18


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_encode_and_decode_sharded_equal_unsharded(tiny, mode):
    model, params, vq_state = tiny
    plain, sharded = _engines(model, params, vq_state, 4, mode=mode)
    rng = np.random.default_rng(3)
    slots = [(plain.attach(), sharded.attach()) for _ in range(3)]
    for _ in range(4):
        for sp, ss in slots:
            if mode == "encode":
                frame = rng.standard_normal(model.hop_length) * 0.3
            else:
                frame = rng.integers(0, 32, model.vq.num_quantizers)
            plain.submit(sp, frame)
            sharded.submit(ss, frame)
        a, b = plain.tick(), sharded.tick()
        for sp, ss in slots:
            for k in a[sp]:
                np.testing.assert_array_equal(a[sp][k], b[ss][k])


def test_encodec_sharded_splits_the_lstm_state_on_axis_1(encodec):
    model, params, vq_state, _, _ = encodec
    plain, sharded = _engines(model, params, vq_state, 4)
    enc_axes, dec_axes = model.cache_axes()
    shard = sharded._shards[1]
    lstm = [c for c, ax in zip(shard.cache_enc + shard.cache_dec,
                               enc_axes + dec_axes) if ax == 1]
    assert len(lstm) == 4 and all(c.shape[1] == 2 for c in lstm)
    frames = _schedule_frames(model.hop_length, seed=1)
    a = _run_schedule(plain, frames, SCHEDULE)
    b = _run_schedule(sharded, frames, SCHEDULE)
    for k in frames:
        np.testing.assert_array_equal(a[k][0], b[k][0])
        np.testing.assert_array_equal(a[k][1], b[k][1])


def test_sharded_engine_holds_to_jax_mesh_engine():
    """Eight slots over two CPU shards against the JAX engine with the
    slots sharded over a two-device mesh, on the same weights: five
    streams on both shards, tokens equal and PCM within one int16 step."""
    jm, tm = models()
    jp, tp = both_params(jm, tm)
    books = codebooks()
    jeng = JaxSlotEngine(jm, jp, {"embed": jnp.asarray(books)}, slots=8,
                         mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)))
    teng = SlotEngine(tm, tp, {"embed": torch.from_numpy(books)}, slots=8,
                      devices=SHARDS)
    hop = tm.hop_length
    rng = np.random.default_rng(9)
    pairs = [(jeng.attach(), teng.attach()) for _ in range(5)]
    assert [p[1] for p in pairs][-1] >= 4       # the last on shard 1
    for _ in range(4):
        for js, ts in pairs:
            frame = _q16(rng.standard_normal(hop) * 0.3)
            jeng.submit(js, frame)
            teng.submit(ts, frame)
        a, b = jeng.tick(), teng.tick()
        for js, ts in pairs:
            np.testing.assert_array_equal(np.asarray(a[js]["tokens"]),
                                          b[ts]["tokens"])
            diff = np.abs(np.asarray(a[js]["pcm"], np.int32)
                          - b[ts]["pcm"].astype(np.int32))
            assert diff.max() <= 1


def test_slots_must_divide_over_the_devices(tiny):
    model, params, vq_state = tiny
    with pytest.raises(ValueError, match="3 slots .* 2 devices"):
        SlotEngine(model, params, vq_state, slots=3, devices=SHARDS)


def test_bench_mesh_on_cpu(monkeypatch):
    """--mesh splits the streams over the mesh's devices (two CPU devices
    here), keeps the metric and names the cards; it parses, refuses
    --dispatch, and refuses streams that do not divide."""
    assert bench.parse_args(["8", "--mesh"]) == bench.Args(streams=8,
                                                           mesh=True)
    with pytest.raises(SystemExit, match="takes no --mesh"):
        bench.parse_args(["8", "--mesh", "--dispatch"])
    monkeypatch.setattr(bench, "build_bench_model", _narrow_flagship)
    monkeypatch.setattr(bench, "mesh_devices",
                        lambda d: [torch.device("cpu")] * 2)
    argv = ["4", "--seconds", "0.2", "--device", "cpu"]
    plain = bench.run(argv)
    mesh = bench.run(argv + ["--mesh"])
    assert mesh["metric"] == plain["metric"] == "torch_streaming_encdec_rtf"
    assert "cards=2" in mesh["unit"] and "cards" not in plain["unit"]
    assert mesh["value"] > 0
    model = _narrow_flagship(torch.device("cpu"))
    params, vq_state = bench.bench_params(model)
    devices = bench.bench_devices(model, bench.parse_args(argv + ["--mesh"]))
    shards = place_shards(model, params, vq_state, devices, 4)
    assert [s[3] for s in shards] == [range(0, 2), range(2, 4)]
    # each shard's streams equal those rows of the unsharded run
    args = bench.parse_args(argv)
    wav = bench._noise((4, 1, 2 * model.hop_length), torch.device("cpu"))
    whole = bench.encode_decode(model, params, vq_state, wav,
                                *model.init_cache(4), args)
    for m, p, v, rows in shards:
        r = slice(rows.start, rows.stop)
        part = bench.encode_decode(m, p, v, wav[r], *m.init_cache(len(rows)),
                                   args)
        assert torch.equal(part[0], whole[0][:, r])
        assert torch.equal(part[1], whole[1][r])
    with pytest.raises(SystemExit, match="do not divide"):
        bench.run(["3", "--seconds", "0.2", "--device", "cpu", "--mesh"])
