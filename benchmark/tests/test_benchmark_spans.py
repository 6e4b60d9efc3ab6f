"""The readers of the program's own spans and counters, on synthetic
traces and hand-made records: device work and idle time put down to
spans, the engine's counters per frame, the native libraries' load; a
trace or a record without them reads as nothing."""

import pytest

from benchmark import harness, spans
from benchmark.trace import TraceData

TRACE_READERS = ("rvq.device_ms_per_frame.stream",
                 "optim.kernels_per_step.train", "optim.idle.train")


def _trace(ops, spans_=(), launch=None, window=(0.0, 1000.0)):
    return TraceData(window, list(ops), list(spans_), dict(launch or {}))


def _read(name, rec):
    return harness.load_reader(name).read(rec)


def test_device_work_launched_inside_the_quantizer_spans():
    # two frame steps; K1 and a gemv launched in codec.quantize, a gather
    # and a copy in codec.dequantize, K3 in codec.decoder_step; k0 was
    # launched before the window, k9 with no launch linked
    sp = [("bench.window", 0.0, 1000.0), ("encode_stream", 0.0, 400.0),
          ("codec.quantize", 50.0, 20.0), ("codec.quantize", 250.0, 20.0),
          ("decode_stream", 500.0, 400.0), ("codec.dequantize", 500.0, 10.0),
          ("codec.dequantize", 700.0, 10.0),
          ("codec.decoder_step", 520.0, 100.0),
          ("codec.quantize", -100.0, 20.0)]
    ops = [("rvq_cluster_kernel", 100.0, 30.0, "kernel", 1),
           ("gemv", 140.0, 20.0, "kernel", 2),
           ("rvq_cluster_kernel", 300.0, 30.0, "kernel", 3),
           ("gather", 530.0, 5.0, "kernel", 4),
           ("memcpy", 540.0, 15.0, "gpu_memcpy", 5),
           ("segment_kernel", 600.0, 200.0, "kernel", 6),
           ("k0", 0.0, 40.0, "kernel", 7),
           ("k9", 800.0, 10.0, "kernel", 8)]
    launch = {1: 55.0, 2: 60.0, 3: 255.0, 4: 502.0, 5: 505.0, 6: 530.0,
              7: -90.0}
    rec = {"trace": _trace(ops, sp, launch), "units_profiled": 2}
    # (30 + 20 + 30 + 5 + 15) us over 2 frame steps
    assert _read("rvq.device_ms_per_frame.stream", rec) == \
        pytest.approx(0.05)
    assert spans.kernels_per_unit(rec, ["codec.quantize"]) == \
        pytest.approx(1.5)


def test_optimizer_kernels_and_idle_time():
    # one step: compute 0-400 us, optim_g 400-600, optim_d 600-700,
    # spectral_norm 700-750, metrics 750-800; the device busy 0-380,
    # 420-450, 480-500 (optim_g), 650-660 (optim_d), 760-780 (metrics)
    sp = [("train_step", 0.0, 800.0), ("train.generator", 0.0, 400.0),
          ("train.optim_g", 400.0, 200.0), ("train.optim_d", 600.0, 100.0),
          ("train.spectral_norm", 700.0, 50.0),
          ("train.metrics", 750.0, 50.0), ("aten::mul", 405.0, 5.0)]
    ops = [("conv", 0.0, 380.0, "kernel", 1),
           ("mul", 420.0, 30.0, "kernel", 2),
           ("sqrt", 480.0, 20.0, "kernel", 3),
           ("copy", 650.0, 10.0, "gpu_memcpy", 4),
           ("add", 760.0, 20.0, "kernel", 5)]
    launch = {1: 1.0, 2: 405.0, 3: 470.0, 4: 640.0, 5: 755.0}
    rec = {"trace": _trace(ops, sp, launch, window=(0.0, 1000.0)),
           "units_profiled": 1}
    # kernels alone: mul and sqrt; the copy is not a kernel
    assert _read("optim.kernels_per_step.train", rec) == pytest.approx(2.0)
    # gaps inside 400-750: 400-420, 450-480, 500-650, 660-750 = 290 us
    assert _read("optim.idle.train", rec) == pytest.approx(29.0)
    # over two steps the count halves
    rec["units_profiled"] = 2
    assert _read("optim.kernels_per_step.train", rec) == pytest.approx(1.0)


def test_spans_are_clipped_to_the_window():
    # an optim_d span straddles the window's start: only its part inside
    # counts, and a launch before the window is not the window's
    sp = [("train.optim_d", -200.0, 300.0)]
    ops = [("a", 50.0, 10.0, "kernel", 1), ("b", -150.0, 10.0, "kernel", 2)]
    rec = {"trace": _trace(ops, sp, {1: 20.0, 2: -180.0}),
           "units_profiled": 1}
    assert _read("optim.kernels_per_step.train", rec) == pytest.approx(1.0)
    # gaps inside 0-100: 0-50 and 60-100 = 90 us of 1000
    assert _read("optim.idle.train", rec) == pytest.approx(9.0)


def test_overlap_of_interval_lists():
    a = [(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)]
    b = [(5.0, 25.0), (45.0, 60.0)]
    assert spans.overlap_us(a, b) == pytest.approx(15.0)
    assert spans.overlap_us(b, a) == pytest.approx(15.0)
    assert spans.overlap_us(a, []) == 0.0


def test_a_trace_without_the_program_spans_reads_nothing():
    # the parent's trace: only the benchmark's own spans
    sp = [("bench.window", 0.0, 1000.0), ("encode_stream", 0.0, 400.0),
          ("train_step", 0.0, 900.0)]
    ops = [("k", 10.0, 100.0, "kernel", 1)]
    rec = {"trace": _trace(ops, sp, {1: 5.0}), "units_profiled": 1}
    for name in TRACE_READERS:
        assert _read(name, rec) is None, name
    # nor without a trace, or without device work (a CPU run)
    for name in TRACE_READERS:
        assert _read(name, {"units_profiled": 1}) is None, name
        cpu = {"trace": _trace([], sp + [("codec.quantize", 1.0, 2.0),
                                         ("train.optim_g", 1.0, 2.0)]),
               "units_profiled": 1}
        assert _read(name, cpu) is None, name


def test_engine_counters_per_frame():
    st = {"ticks": 10, "frames": 400, "tick_s_sum": 0.07,
          "dispatch_s_sum": 0.05, "collect_s_sum": 0.0016,
          "wait_s_sum": 1.2}
    rec = {"engine_stats": st}
    assert _read("engine.wait_ms.live", rec) == pytest.approx(3.0)
    assert _read("engine.collect_us_per_frame.live", rec) == \
        pytest.approx(4.0)
    # the parent's engine has neither counter
    old = {k: v for k, v in st.items()
           if k not in ("collect_s_sum", "wait_s_sum")}
    for name in ("engine.wait_ms.live", "engine.collect_us_per_frame.live"):
        assert _read(name, {"engine_stats": old}) is None
        assert _read(name, {"engine_stats": dict(st, frames=0)}) is None
        assert _read(name, {}) is None


def test_native_libraries_load_seconds(monkeypatch):
    from hilcodec_tpu_torch.ops import cuda_build
    record = {"rvq": {"compile_s": 0.004, "load_s": 0.02,
                      "compiled": False},
              "segment": {"compile_s": 41.0, "load_s": 0.03,
                          "compiled": True}}
    assert spans.native_s(record) == pytest.approx(41.054)
    assert spans.native_s({}) == 0.0
    assert spans.native_s(None) is None
    monkeypatch.setattr(cuda_build, "load_record", lambda: record)
    assert _read("setup.native_s", {}) == pytest.approx(41.054)
    # a port that keeps no record (the parent's)
    monkeypatch.delattr(cuda_build, "load_record")
    assert _read("setup.native_s", {}) is None
