"""The port's spans and counters (`utils/spans.py`): with no profiler on a
span constructs nothing; under torch.profiler the slot engine's tick,
the codec's frame step and the train step's parts appear once a unit,
nested where they run; the engine's queue-wait and collect counters; the
native libraries' load record."""

import time

import numpy as np
import pytest
import torch

from test_torch_train_step import port_tiny_trainer

from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.ops import cuda_build
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.serve import SlotEngine
from hilcodec_tpu_torch.utils.spans import span

CPU = torch.device("cpu")
ENGINE_SPANS = ("slot_engine.collect", "slot_engine.upload",
                "slot_engine.step", "slot_engine.fetch")


@pytest.fixture(scope="module")
def tiny():
    model = CodecModel(
        HILCodec(channels_enc=8, channels_dec=8, n_residual_enc=1,
                 n_residual_dec=1, strides=(4, 2), n_fft_base=16, vq_dim=16,
                 res_scale_enc=0.577, res_scale_dec=0.577),
        ResidualVQ(dim=16, codebook_size=32, num_quantizers=3,
                   kmeans_init=False), CPU)
    params, vq_state = model.init(torch.Generator().manual_seed(0))
    return model, params, vq_state


def _engine(tiny, mode="decode", slots=3):
    model, params, vq_state = tiny
    return SlotEngine(model, params, vq_state, slots=slots, mode=mode,
                      devices=["cpu"])


def _frame(eng, rng):
    if eng.mode == "decode":
        return rng.integers(0, 32, eng.n_q)
    return rng.integers(-3000, 3000, eng.hop).astype(np.int16)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def _named(events, name):
    return [(s, e) for n, s, e in events if n == name]


def test_span_off_constructs_no_record_function(tiny, monkeypatch):
    """No profiler: neither a bare span nor a tick of the engine builds a
    record_function."""
    def refuse(*a, **k):
        raise AssertionError("record_function constructed")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with span("x"):
        pass
    eng = _engine(tiny, mode="roundtrip")
    slot = eng.attach()
    eng.submit(slot, _frame(eng, np.random.default_rng(0)))
    assert slot in eng.tick()


@pytest.mark.parametrize("mode", ["decode", "roundtrip"])
def test_engine_tick_spans_once_a_tick(tiny, mode):
    """Each tick opens the engine's four spans once; the frame step's
    codec spans nest in `slot_engine.step`."""
    eng = _engine(tiny, mode=mode)
    rng = np.random.default_rng(1)
    slots = [eng.attach() for _ in range(2)]
    ticks = 3

    def go():
        for _ in range(ticks):
            for s in slots:
                eng.submit(s, _frame(eng, rng))
            eng.tick()
    events = _profiled(go)
    for name in ENGINE_SPANS:
        assert len(_named(events, name)) == ticks, name
    steps = _named(events, "slot_engine.step")
    inner = ["codec.dequantize", "codec.decoder_step"]
    if mode == "roundtrip":
        inner += ["codec.encoder_step", "codec.quantize"]
    for name in inner:
        got = _named(events, name)
        assert len(got) == ticks, name
        for s, e in got:
            assert any(a <= s and e <= b for a, b in steps), name


def test_engine_wait_and_collect_counters(tiny):
    """`wait_s_sum` sums each collected frame's time from submit to
    collect, `collect_s_sum` the host's time in collect; both read 0
    after the benchmark driver's reset and grow again."""
    eng = _engine(tiny)
    rng = np.random.default_rng(2)
    slots = [eng.attach() for _ in range(3)]
    for s in slots:
        eng.submit(s, _frame(eng, rng))
    time.sleep(0.02)
    t0 = time.perf_counter()
    eng.run(eng.collect())
    in_collect = time.perf_counter() - t0
    st = eng.stats
    assert st["frames"] == 3
    assert 3 * 0.02 <= st["wait_s_sum"] < 3 * (0.02 + 5.0)
    assert 0.0 < st["collect_s_sum"] <= in_collect
    # a second frame queued behind the first waits one more tick
    for s in slots[:1]:
        eng.submit(s, _frame(eng, rng))
        eng.submit(s, _frame(eng, rng))
    for k in eng.stats:
        eng.stats[k] = 0 if k in ("ticks", "frames") else 0.0
    assert eng.stats["wait_s_sum"] == eng.stats["collect_s_sum"] == 0.0
    eng.tick()
    w1 = eng.stats["wait_s_sum"]
    time.sleep(0.01)
    eng.tick()
    assert eng.stats["frames"] == 2
    assert eng.stats["wait_s_sum"] - w1 >= 0.01
    assert eng.stats["collect_s_sum"] > 0.0
    # an empty collect is counted too, and waits for no frame
    before = dict(eng.stats)
    assert eng.collect() is None
    assert eng.stats["wait_s_sum"] == before["wait_s_sum"]
    assert eng.stats["collect_s_sum"] > before["collect_s_sum"]


TRAIN_SPANS = ("train.draws", "train.generator", "train.mel",
               "train.real_fmaps", "train.balancer",
               "train.generator_backward", "train.discriminator",
               "train.clip", "train.optim_g", "train.optim_d",
               "train.spectral_norm", "train.metrics")


def test_train_step_spans_once_a_step():
    """Every part of the step opens its span once a step (a
    `train.family.<name>` per discriminator family), the parts do not
    overlap, and AdamP's operators run inside `train.optim_g`."""
    tr = port_tiny_trainer()
    state = tr.init_state(torch.Generator().manual_seed(0))
    wav = torch.randn(2, 1, 2400, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    steps = 2

    def go():
        s = state
        for _ in range(steps):
            s, _ = tr.train_step(s, wav, tr.sample_draws(gen, wav.shape))
    events = _profiled(go)
    families = [f"train.family.{n}" for n in tr.disc.discs]
    assert families == ["train.family.mfbd", "train.family.mstftd"]
    parts = []
    for name in TRAIN_SPANS + tuple(families):
        got = _named(events, name)
        assert len(got) == steps, name
        if name != "train.draws":
            parts += got
    parts.sort()
    assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))
    optim_g = _named(events, "train.optim_g")
    sqrt = [(s, e) for n, s, e in events if n == "aten::sqrt"]
    assert any(a <= s and e <= b for s, e in sqrt for a, b in optim_g)


def test_native_library_load_is_recorded():
    cuda_build.load_host("wavio")
    rec = cuda_build.load_record()["wavio"]
    assert set(rec) == {"compile_s", "load_s", "compiled"}
    assert rec["compile_s"] >= 0.0 and rec["load_s"] >= 0.0
    assert isinstance(rec["compiled"], bool)
    # once per process: a second load records nothing new
    cuda_build.load_host("wavio")
    assert cuda_build.load_record()["wavio"] == rec
