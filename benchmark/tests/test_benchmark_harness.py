"""The harness on the CPU: BENCHMARK.json against the contract and the
files it names, cells found by name, a cell added from new files alone,
the end-to-end arithmetic on synthetic records, the trace reduction, the
JAX guard and the command's refusals."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import common, guard, harness, reading
from benchmark.trace import TraceData
from benchmark.tests import tiny

ROOT = os.path.dirname(common.HERE)
BENCH = common.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200
    assert total <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(x) for x in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mine = harness.cell_metrics(BENCH, w["name"], False)
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layer = harness.cell_metrics(BENCH, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in [x["name"] for x in mine]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_files_are_found_by_name():
    for c in BENCH["configs"]:
        cfg = common.read_json(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/configs/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["precision"] == "f32"
    for w in BENCH["workloads"]:
        cell = common.load_cell(BENCH, w["name"], 1, 1.0, False,
                                torch.device("cpu"))
        harness.load_driver(cell.driver)
        for name in ("setup", "window", "work", "release", "check"):
            assert callable(getattr(harness.load_driver(cell.driver), name))
        assert cell.check.get("limits"), w["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        r = harness.load_reader(m["name"])
        assert r.UNIT == m["unit"] and r.SOURCE == m["source"]
        assert r.BETTER == m["better"]
        if "layer" in m:
            assert r.LAYER == m["layer"] and r.MOVES == m["moves"]


def _tree_hashes(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "out")]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_cell_added_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a check file and a per-layer metric
    added as new files, with entries in BENCHMARK.json, make a cell that
    runs; no file of the benchmark changes."""
    shutil.copytree(common.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    before = _tree_hashes(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    cfg = tiny.tiny_config(common.read_json(
        os.path.join(common.HERE, "configs", "hilcodec_speech.json")))
    cfg["name"] = "hilcodec_tiny"
    (b / "configs" / "hilcodec_tiny.json").write_text(json.dumps(cfg))
    (b / "traffic" / "bulk_plain4.json").write_text(json.dumps(dict(
        tiny.TRAFFIC["bulk_stream"], driver="bulk_stream",
        megakernel=False)))
    (b / "workloads" / "hilcodec_tiny.bulk_plain4.json").write_text(
        json.dumps({"sample_streams": 2,
                    "limits": {"token_gap": 1e-3, "pcm_err_steps": 8.0}}))
    (b / "metrics" / "frames_done.stream.py").write_text(
        'LAYER = "frame step"\nUNIT = "frames"\nBETTER = "higher"\n'
        'SOURCE = "host_clock"\nMOVES = "stream_rtf"\n\n\n'
        'def read(rec):\n    return float(rec["units"])\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "hilcodec_tiny", "source": "test",
                             "file": "benchmark/configs/hilcodec_tiny.json",
                             "reduced": [], "why": "test"})
    cell = "hilcodec_tiny.bulk_plain4"
    bench["workloads"].append({"name": cell, "config": "hilcodec_tiny",
                               "traffic": "bulk_plain4", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "stream_rtf":
            m["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "frames_done.stream", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "frame step",
        "moves": "stream_rtf", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, time, torch\n"
        "from benchmark import common, harness\n"
        "bench = common.benchmark_json()\n"
        f"c = common.load_cell(bench, {cell!r}, 5, 0.3, False,"
        " torch.device('cpu'))\n"
        "res, _ = harness.run_cell(c, bench, time.perf_counter())\n"
        "print(json.dumps(res))\n"
        "print(harness.load_reader('frames_done.stream').read("
        "{'units': 3}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-2])
    assert res["correct"] and set(res["metrics"]) == {"stream_rtf",
                                                      "setup_s"}
    assert lines[-1] == "3.0"
    after = _tree_hashes(b)
    assert {k: v for k, v in after.items() if k in before} == before


def test_rate_is_all_the_work_over_all_the_time():
    rec = {"audio_s": 1280.0, "wall_s": 3.2}
    assert reading.rate(rec, "audio_s") == pytest.approx(400.0)
    assert harness.load_reader("stream_rtf").read(rec) == pytest.approx(400)
    assert harness.load_reader("stream_rtf").read({}) is None


def test_the_tail_is_over_every_frame_with_misses_counted():
    # 100 frames: 90 answered in 10 ms, 10 never answered (the drain gave
    # up 5 s after they were due): the 95th percentile is a miss
    lat = [0.010] * 90 + [5.0] * 10
    p95 = harness.load_reader("frame_p95_ms").read({"latency_s": lat})
    assert p95 == pytest.approx(5000.0)
    lat = [0.010] * 96 + [5.0] * 4
    p95 = harness.load_reader("frame_p95_ms").read({"latency_s": lat})
    assert p95 == pytest.approx(10.0)
    assert reading.percentile(list(range(1, 101)), 95) == 95
    assert reading.percentile([3.0], 95) == 3.0


def _trace(ops, spans=(), launch=None, window=(0.0, 1000.0)):
    return TraceData(window, list(ops), list(spans), dict(launch or {}))


def test_busy_time_is_the_union_of_device_intervals():
    # two overlapping kernels (100-400, 300-500) and a copy (700-800)
    tr = _trace([("k1", 100.0, 300.0, "kernel", 1),
                 ("k2", 300.0, 200.0, "kernel", 2),
                 ("memcpy", 700.0, 100.0, "gpu_memcpy", 3)],
                spans=[("engine.run", 0.0, 650.0), ("aten::add", 520.0, 50.0),
                       ("bench.window", 0.0, 1000.0)])
    assert tr.busy_s() == pytest.approx(500e-6)
    rec = {"trace": tr, "units_profiled": 2}
    assert reading.idle_pct(rec) == pytest.approx(50.0)
    assert reading.kernels_per_unit(rec) == pytest.approx(1.0)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(300e-6)]
    gaps = {name: s for name, s in bd["idle_gaps"]}
    # 0-100 and 500-700 fall in engine.run (500-700's middle, 600, is in
    # engine.run and not in aten::add), 800-1000 outside any span
    assert gaps["host outside any span"] == pytest.approx(200e-6)
    assert len(bd["idle_gaps"]) == 3


def test_work_in_flight_at_the_window_is_busy_but_not_counted():
    # k0 was launched (at -50) before the window opened and runs 0-300;
    # k1 and k2 were launched in it, k2 with no launch linked (placed by
    # its start): the unit's count is theirs alone
    tr = _trace([("k0", 0.0, 300.0, "kernel", 1),
                 ("k1", 300.0, 300.0, "kernel", 2),
                 ("k2", 700.0, 100.0, "kernel", 3)],
                launch={1: -50.0, 2: 10.0})
    rec = {"trace": tr, "units_profiled": 2}
    assert [k[0] for k in tr.window_kernels()] == ["k1", "k2"]
    assert reading.kernels_per_unit(rec) == pytest.approx(1.0)
    assert reading.idle_pct(rec) == pytest.approx(30.0)


def test_a_late_window_opens_where_the_body_says(tmp_path, monkeypatch):
    from benchmark.trace import Profiled
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    x = torch.ones(64)
    with Profiled(torch.device("cpu"), late=True) as p:
        with torch.profiler.record_function("before"):
            x = x + 1
        p.open()
        with torch.profiler.record_function("inside"):
            x = x * 2
    lo, hi = p.data.window
    spans = {name: (ts, ts + dur) for name, ts, dur in p.data.spans}
    assert spans["before"][1] <= lo
    assert lo <= spans["inside"][0] and spans["inside"][1] <= hi


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = {"trace": _trace([]), "units_profiled": 3}
    for name in ("idle.stream", "kernels_per_frame.stream", "k3_roofline",
                 "k4_roofline", "mfu.stream", "mfu.train"):
        assert harness.load_reader(name).read(empty) is None


def test_roofline_of_the_frame_kernels():
    # K4 calls launched in encode_stream, K3 in decode_stream
    ops = [("segment_kernel(Phase const*)", 0.0, 10.0, "kernel", 1),
           ("rvq_cluster_kernel", 10.0, 1.0, "kernel", 2),
           ("segment_kernel(Phase const*)", 20.0, 20.0, "kernel", 3)]
    spans = [("encode_stream", 0.0, 5.0), ("decode_stream", 6.0, 5.0)]
    tr = _trace(ops, spans, {1: 1.0, 2: 2.0, 3: 7.0})
    pk = common.read_json(os.path.join(common.HERE, "peaks.json"))
    rec = {"trace": tr, "peaks": pk["cards"]["h100"],
           "k3_work": (165e12 * 5e-6, 1.0), "k4_work": (165e12 * 5e-6, 1.0)}
    assert reading.roofline_pct(rec, "decode_stream", "k3_work") == \
        pytest.approx(25.0)
    assert reading.roofline_pct(rec, "encode_stream", "k4_work") == \
        pytest.approx(50.0)
    # no launch linked: by order, F encoder calls then F decoder calls
    rec["trace"] = _trace(ops, spans, {})
    rec["chunk_frames"] = 1
    assert reading.roofline_pct(rec, "decode_stream", "k3_work") == \
        pytest.approx(25.0)


def test_mfu_is_the_reference_work_over_wall_over_peak():
    pk = common.read_json(os.path.join(common.HERE, "peaks.json"))
    rec = {"peaks": pk["cards"]["h100"], "flops_per_unit": 16.5e12,
           "units": 10, "wall_s": 10.0, "precision": "f32"}
    assert reading.mfu_pct(rec) == pytest.approx(10.0)


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert "hilcodec_tpu" not in guard.forbidden_modules() or \
        "hilcodec_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "hilcodec_tpu_torch_fake", object())
    assert "hilcodec_tpu_torch_fake" not in guard.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hilcodec_tpu.models", object())
    assert "hilcodec_tpu" in guard.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"hilcodec_tpu", "jax"} <= set(guard.forbidden_modules())


def test_the_command_refuses_without_a_card(tmp_path):
    """No CUDA here: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cmd = BENCH["command"] + ["--workload", BENCH["workloads"][0]["name"],
                              "--seed", str(2 ** 32 + 5), "--seconds", "1",
                              "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # nor where the checkout holds only BENCHMARK.json and the benchmark
    shutil.copytree(common.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_each_cell_runs_on_the_card(card):
    for w in BENCH["workloads"]:
        cmd = BENCH["command"] + ["--workload", w["name"], "--seed",
                                  str(2 ** 31 + 11), "--seconds", "3",
                                  "--trace", "0"]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
