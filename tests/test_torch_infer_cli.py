"""`python -m hilcodec_tpu_torch.infer` against the root `infer.py` on one
JAX checkpoint and one wav at a tiny width, on the CPU, at 1 and 2 frames
a step: the int16 tokens [n_q, 1, T] exactly, the written wav within one
PCM step; --profile; and live entropy streaming (--entropy-stream)."""

import os
import runpy
import sys

import numpy as np
import pytest
import yaml

from hilcodec_tpu.utils.hparams import HParams as JaxHParams

from hilcodec_tpu_torch import infer
from hilcodec_tpu_torch.utils.bitstream import read_hilstream, token_crc32
from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

from test_torch_train_loop import ROOT, cut_down
from torch_port_common import write_jax_checkpoint


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("infer")
    cfg = cut_down(str(tmp))
    cfg_path = tmp / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    ckpt = str(tmp / "00001.ckpt.npz")
    write_jax_checkpoint(JaxHParams(**cfg), ckpt)
    rng = np.random.default_rng(0)
    t = np.arange(240) / 24000
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(240)
    inp = str(tmp / "in.wav")
    write_wav(inp, wav, 24000)
    return tmp, str(cfg_path), ckpt, inp


@pytest.mark.parametrize("f", ["1", "2"])
def test_infer_cli_matches_root_infer(setup, f, capsys):
    tmp, cfg, ckpt, inp = setup
    args = ["-c", cfg, "-i", inp, "--ckpt", ckpt, "-f", f]
    old = sys.argv
    try:
        sys.argv = ["infer.py"] + args + ["-o", str(tmp / f"jax{f}")]
        runpy.run_path(os.path.join(ROOT, "infer.py"), run_name="__main__")
    finally:
        sys.argv = old
    infer.main(args + ["-o", str(tmp / f"port{f}"), "--device", "cpu",
                       "--latency"])
    out = capsys.readouterr().out
    assert "encoder RTF:" in out and "decoder RTF:" in out
    assert f"per-step enc+dec latency over {30 // int(f)} steps" in out

    ours = np.load(tmp / f"port{f}_quantized.npy")
    theirs = np.load(tmp / f"jax{f}_quantized.npy")
    assert ours.dtype == np.int16 and ours.shape == (3, 1, 30)
    np.testing.assert_array_equal(ours, theirs)
    a, sr = read_wav(str(tmp / f"port{f}_output.wav"))
    b, _ = read_wav(str(tmp / f"jax{f}_output.wav"))
    assert sr == 24000 and a.shape == b.shape == (240,)
    np.testing.assert_allclose(a, b, rtol=0, atol=1.01 / 32768)


def test_infer_cli_profile_and_refusals(setup, capsys):
    tmp, cfg, _, inp = setup
    infer.main(["-c", cfg, "-i", inp, "-o", str(tmp / "rand"),
                "--device", "cpu", "--profile", str(tmp / "prof")])
    assert os.path.getsize(tmp / "prof" / "trace.json") > 0
    assert np.load(tmp / "rand_quantized.npy").shape == (3, 1, 30)
    # live entropy streaming on the LM's seeded init: the live decoder
    # gives back every frame, and the .hilstream holds the bytes
    capsys.readouterr()
    infer.main(["-c", cfg, "-i", inp, "-o", str(tmp / "live"), "--device",
                "cpu", "--entropy-stream", "random", "--lm-arch",
                "16,4,1,8"])
    out = capsys.readouterr().out
    assert "live entropy stream: roundtrip_exact=True" in out
    assert "per-frame coder latency: p50" in out
    meta, payload = read_hilstream(str(tmp / "live.hilstream"))
    assert (meta["n_q"], meta["card"], meta["seg_tokens"]) == (3, 32, 8)
    tok = np.load(tmp / "live_quantized.npy")[:, 0].T.astype(np.int64)
    assert meta["token_crc"] == token_crc32(tok) and len(payload) > 0
