"""The port's bench entry (`python -m hilcodec_tpu_torch.bench`): argument
parsing as in bench.py, the JSON contract on a tiny model on the CPU, the
--dtype and --depthwise options, and the refusals (no CUDA without
--device, options with no meaning or no port)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from hilcodec_tpu_torch import bench
from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.encodec import EncodecModel
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
    (["8", "--frames", "4", "--megakernel"],
     bench.Args(streams=8, megakernel=True, frames=4)),
])
def test_parse_args(argv, expect):
    assert bench.parse_args(argv) == expect


@pytest.mark.parametrize("argv,msg", [
    (["--seconds"], "--seconds requires a value"),
    (["--seconds", "x"], "requires a number"),
    (["many"], "streams must be an integer"),
    (["--fused", "--megakernel"], "no frame-kernel path"),
    (["--bogus"], "unknown option"),
    (["--frames", "x"], "--frames requires an int"),
    (["--frames", "0"], "--frames must be positive"),
    (["--dispatch", "--frames", "2"], "takes no --frames"),
    (["--dispatch", "--fused"], "takes no --fused"),
])
def test_parse_args_rejects(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        bench.parse_args(argv)


@pytest.mark.parametrize("argv,expect", [
    (["8", "--mesh"], bench.Args(streams=8, mesh=True)),
    (["8", "--unroll", "2"], "XLA scan of the JAX drivers"),
    (["8", "--chunks", "2"], "XLA scan's streams"),
    (["8", "--dtype", "bf16w"], bench.Args(streams=8, dtype="bf16w")),
    (["8", "--dtype", "bf16", "--megakernel"],
     bench.Args(streams=8, dtype="bf16", megakernel=True)),
    (["8", "--depthwise", "shift", "--dtype", "f32"],
     bench.Args(streams=8)),
    (["8", "--dtype", "fp8"], "unknown --dtype"),
    (["8", "--depthwise", "im2col"], "unknown --depthwise"),
])
def test_unported_options_point_at_roadmap(argv, expect):
    """--mesh parses (stream sharding over the cards); --unroll and
    --chunks are XLA scan knobs with no meaning for an eager frame loop;
    --dtype and
    --depthwise take bench.py's values and refuse others (both depthwise
    lowerings are the one convolution, so the parse is the same)."""
    if isinstance(expect, str):
        with pytest.raises(SystemExit, match=expect):
            bench.parse_args(argv)
    else:
        assert bench.parse_args(argv) == expect


def test_depthwise_shift_matches_conv_and_names_its_metric(monkeypatch):
    """--depthwise shift names a lowering of XLA's: the port runs the same
    convolution, so the run has the metric name, tokens and waveform of
    --depthwise conv (the same seeded weights and audio, bitwise)."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(bench, "build_bench_model", _tiny_model)
    res = {}
    for mode in ("conv", "shift"):
        argv = ["2", "--seconds", "0.002", "--device", "cpu",
                "--depthwise", mode, "--dtype", "bf16"]
        res[mode] = bench.run(argv)
        args = bench.parse_args(argv)
        model = _tiny_model(cpu)
        params, vq_state = bench.bench_params(model, args.dtype)
        wav = bench._noise((2, 1, 4 * model.hop_length), cpu,
                           bench.act_dtype(args))
        res[mode, "out"] = bench.encode_decode(
            model, params, vq_state, wav,
            *model.init_cache(2, bench.act_dtype(args)), args)[:2]
    assert (res["shift"]["metric"] == res["conv"]["metric"]
            == "torch_streaming_encdec_rtf_bf16")
    for a, b in zip(res["conv", "out"], res["shift", "out"]):
        assert torch.equal(a, b)


def test_unported_model_exits_with_roadmap_pointer():
    """--model audiodec, the last family ported, parses and names its
    metric with bench.py's `_audiodec` suffix; a model bench.py does not
    have still exits with the roadmap pointer."""
    args = bench.parse_args(["4", "--model", "audiodec"])
    assert args.model == "audiodec"
    res = bench.stream_bench(*_tiny_audiodec(), bench.Args(
        streams=1, seconds=0.002, device="cpu", model="audiodec"))
    assert res["metric"] == "torch_streaming_encdec_rtf_audiodec"
    out = _run(["--model", "bogus"])
    assert out.returncode != 0 and "ROADMAP.md" in out.stderr
    assert out.stdout == ""


def _tiny_audiodec():
    from hilcodec_tpu_torch.models.audiodec import AudioDec
    model = CodecModel(
        AudioDec(encode_channels=4, enc_ratios=(2, 4), enc_strides=(3, 4),
                 code_dim=8, codebook_num=2, codebook_size=16,
                 decode_channels=16, dec_strides=(4, 3),
                 resblock_kernel_size=5, resblock_dilations=(1, 3)),
        ResidualVQ(dim=8, codebook_size=16, num_quantizers=2,
                   kmeans_init=False), torch.device("cpu"))
    return (model,) + bench.bench_params(model)


def test_encodec_model_parses_and_names_its_metric(monkeypatch, capsys):
    """--model encodec is bench.py's EnCodec point (8 quantizers); its
    metric takes bench.py's `_encodec` suffix, and the frame kernels,
    which run HILCodec only, are refused for it."""
    args = bench.parse_args(["4", "--model", "encodec"])
    assert args.model == "encodec" and args.streams == 4
    with pytest.raises(SystemExit, match="HILCodec only"):
        bench.parse_args(["4", "--model", "encodec", "--megakernel"])
    model = bench.build_encodec_bench_model(torch.device("cpu"))
    assert model.hop_length == 320 and model.vq.num_quantizers == 8
    assert model.codec.lstm == 2 and model.codec.channels_enc == 32
    monkeypatch.setattr(bench, "build_encodec_bench_model",
                        lambda device: _tiny_encodec(device))
    bench.main(["2", "--seconds", "0.002", "--device", "cpu", "--model",
                "encodec", "--frames", "2"])
    res = json.loads(capsys.readouterr().out)
    assert res["metric"] == "torch_streaming_encdec_rtf_encodec_f2"
    assert "device=cpu" in res["unit"] and res["value"] >= 0


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


def _tiny_encodec(device):
    return CodecModel(
        EncodecModel(channels_enc=4, channels_dec=4, strides=(4, 2), lstm=1,
                     vq_dim=16),
        ResidualVQ(dim=16, codebook_size=32, num_quantizers=3,
                   kmeans_init=False), device)


@pytest.mark.parametrize("extra,metric", [
    ([], "torch_streaming_encdec_rtf"),
    (["--megakernel"], "torch_streaming_encdec_rtf_megakernel"),
    (["--fused"], "torch_streaming_encdec_rtf_fused"),
    (["--dispatch"], "torch_per_dispatch_frame_latency_ms"),
    (["--frames", "2"], "torch_streaming_encdec_rtf_f2"),
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


@pytest.mark.parametrize("extra", [[], ["--megakernel"], ["--fused"]])
def test_frames_per_step_matches_one_frame_a_step(extra):
    """--frames 4 gives the tokens, wav and caches of --frames 1 on the
    same audio, through each of the bench's drivers."""
    cpu = torch.device("cpu")
    model = _tiny_model(cpu)
    params, vq_state = bench.bench_params(model)
    wav = bench._noise((2, 1, 8 * model.hop_length), cpu)
    outs = [bench.encode_decode(model, params, vq_state, wav,
                                *model.init_cache(2),
                                bench.parse_args(["2", "--frames", f,
                                                  *extra]))
            for f in ("1", "4")]
    tok1, out1, ce1, cd1 = outs[0]
    tok4, out4, ce4, cd4 = outs[1]
    assert torch.equal(tok4, tok1)
    torch.testing.assert_close(out4, out1, rtol=0, atol=1e-5)
    for a, b in zip(ce4 + cd4, ce1 + cd1):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
