"""The port's bench entry (`python -m hilcodec_tpu_torch.bench`): argument
parsing as in bench.py, the JSON contract on a tiny model on the CPU, and
the refusals (no CUDA without --device, unported options)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from hilcodec_tpu_torch import bench
from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.ops.rvq import ResidualVQ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "hilcodec_tpu_torch.bench",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("argv,expect", [
    ([], bench.Args()),
    (["16"], bench.Args(streams=16)),
    (["8", "--seconds", "0.5"], bench.Args(streams=8, seconds=0.5)),
    (["--megakernel"], bench.Args(megakernel=True)),
    (["--megakernel", "--no-megakernel"], bench.Args()),
    (["4", "--fused", "--device", "cpu"],
     bench.Args(streams=4, fused=True, device="cpu")),
    (["--dispatch", "--model", "hilcodec"], bench.Args(dispatch=True)),
])
def test_parse_args(argv, expect):
    assert bench.parse_args(argv) == expect


@pytest.mark.parametrize("argv,msg", [
    (["--seconds"], "--seconds requires a value"),
    (["--seconds", "x"], "requires a number"),
    (["many"], "streams must be an integer"),
    (["--fused", "--megakernel"], "no frame-kernel path"),
    (["--bogus"], "unknown option"),
])
def test_parse_args_rejects(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        bench.parse_args(argv)


@pytest.mark.parametrize("flag", ["--mesh", "--dtype", "--depthwise",
                                  "--unroll", "--chunks", "--frames"])
def test_unported_options_point_at_roadmap(flag):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        bench.parse_args(["8", flag, "2"])


def test_unported_model_exits_with_roadmap_pointer():
    out = _run(["--model", "encodec"])
    assert out.returncode != 0 and "ROADMAP.md" in out.stderr
    assert out.stdout == ""


def test_no_cuda_without_device_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(["1", "--seconds", "0.02"])
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr and out.stdout == ""


def _tiny_model(device):
    return CodecModel(
        HILCodec(channels_enc=8, channels_dec=8, n_residual_enc=1,
                 n_residual_dec=1, strides=(4, 2), n_fft_base=16, vq_dim=16,
                 res_scale_enc=0.577, res_scale_dec=0.577),
        ResidualVQ(dim=16, codebook_size=32, num_quantizers=3,
                   kmeans_init=False), device)


@pytest.mark.parametrize("extra,metric", [
    ([], "torch_streaming_encdec_rtf"),
    (["--megakernel"], "torch_streaming_encdec_rtf_megakernel"),
    (["--fused"], "torch_streaming_encdec_rtf_fused"),
    (["--dispatch"], "torch_per_dispatch_frame_latency_ms"),
])
def test_tiny_cpu_run_prints_one_json_line(monkeypatch, capsys, extra,
                                           metric):
    monkeypatch.setattr(bench, "build_bench_model", _tiny_model)
    monkeypatch.setattr(bench, "DISPATCH_BLOCKING", 5)
    monkeypatch.setattr(bench, "DISPATCH_PIPELINED", 5)
    bench.main(["2", "--seconds", "0.002", "--device", "cpu", *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    # the value is rounded to 2 decimals, as bench.py's; a tiny CPU run on
    # a loaded host may round to 0
    assert res["metric"] == metric and res["value"] >= 0
    assert "device=cpu" in res["unit"] and "streams=2" in res["unit"]
    if "--dispatch" not in extra:
        # both are rounded from the same unrounded real-time factor
        assert abs(res["vs_baseline"] - res["value"] / 100.0) <= 1e-3
