"""The port's serving and tools on a tiny Avocodo (configs/avocodo_synth.yaml
cut down) on the CPU: a 3-slot SlotEngine whose streams each equal their
solo port stream bitwise and their solo JAX `encode_decode_stream`;
`export` against the root `export.py`; `infer` against the root
`infer.py` at 1 and 2 frames a step; `eval` in model mode against the
root `eval.py` (both through the trainer's facade offline; the port's
--stream through the streaming drivers); `serve --ckpt` against `serve
--params`; and `bench --model avocodo` (bench.py's AvocodoModel point),
its parsing and a CPU run. The checkpoint is JAX's
(`torch_port_common.write_jax_checkpoint`)."""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import avocodo as JA
from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ
from hilcodec_tpu.utils.hparams import HParams as JaxHParams

from hilcodec_tpu_torch import bench
from hilcodec_tpu_torch import eval as port_eval
from hilcodec_tpu_torch import export as port_export
from hilcodec_tpu_torch import infer
from hilcodec_tpu_torch.models import avocodo as TA
from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.serve import SlotEngine
from hilcodec_tpu_torch.serve.__main__ import serving_weights
from hilcodec_tpu_torch.utils import params as P
from hilcodec_tpu_torch.utils.hparams import HParams
from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

from test_torch_avocodo import TINY
from test_torch_avocodo_train import cut_down_avocodo
from test_torch_eval_cli import _means, _root_eval, _wavs
from test_torch_serve import (SCHEDULE, _assert_pcm, _dq16, _frames, _q16,
                              _run_schedule, _stream_ref)
from test_torch_train_loop import ROOT
from torch_port_common import jax_tree, seeded_flat, write_jax_checkpoint

CPU = torch.device("cpu")
VQ = dict(dim=16, codebook_size=32, num_quantizers=4, kmeans_init=False)


def _root_cli(script, argv):
    old = sys.argv
    try:
        sys.argv = [script] + argv
        runpy.run_path(os.path.join(ROOT, script), run_name="__main__")
    finally:
        sys.argv = old


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("avocodo_tools")
    cfg = cut_down_avocodo(str(tmp))
    cfg_path = str(tmp / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    ckpt = str(tmp / "00001.ckpt.npz")
    write_jax_checkpoint(JaxHParams(**cfg), ckpt)
    rng = np.random.default_rng(0)
    t = np.arange(512) / 24000
    write_wav(str(tmp / "in.wav"), 0.3 * np.sin(2 * np.pi * 220 * t)
              + 0.05 * rng.standard_normal(512), 24000)
    return tmp, cfg, cfg_path, ckpt


def test_engine_streams_equal_solo_port_and_jax_streams(rng):
    """Three streams attach at different ticks, share and skip ticks: each
    one's tokens and int16 PCM equal its solo port stream, and its solo
    JAX encode_decode_stream (tokens, the float output within 1e-5)."""
    jm = JaxCodecModel(JA.AvocodoModel(**TINY), JaxResidualVQ(**VQ))
    model = CodecModel(TA.AvocodoModel(**TINY), ResidualVQ(**VQ), CPU)
    template = jm.codec.init(jax.random.PRNGKey(0))
    flat = seeded_flat(template)
    params = P.from_flat(flat, model.param_template(False))
    books = (np.random.default_rng(1).standard_normal((4, 32, 16)) * 0.5
             ).astype(np.float32)
    vq_state = {"embed": torch.from_numpy(books)}
    hop = model.hop_length
    eng = SlotEngine(model, params, vq_state, slots=3, mode="roundtrip",
                     devices=["cpu"])
    wavs = {k: _dq16(_q16(rng.standard_normal(hop * 6) * 0.3))
            for k in "abc"}
    got = _run_schedule(eng, {k: _frames(w, hop) for k, w in wavs.items()},
                        SCHEDULE)
    jp = jm.codec.fold_params(jax_tree(template, flat))
    jv = {"embed": jnp.asarray(books)}
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


def test_export_matches_root_export(setup):
    tmp, _, cfg_path, ckpt = setup
    argv = ["-c", cfg_path, "--ckpt", ckpt]
    _root_cli("export.py", argv + ["-o", str(tmp / "jax" / "avo")])
    port_export.main(argv + ["-o", str(tmp / "port" / "avo"),
                             "--device", "cpu"])
    ours = _load(tmp / "port" / "avo_deploy.npz")
    theirs = _load(tmp / "jax" / "avo_deploy.npz")
    assert set(ours) == set(theirs)
    assert ours["codebooks"].shape == (4, 32, 16)
    assert "decoder/heads/2/w" in ours
    for k, v in theirs.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
    for side in ("enc", "dec"):
        a = np.load(tmp / "port" / f"avo_cache_{side}.npz")
        b = np.load(tmp / "jax" / f"avo_cache_{side}.npz")
        assert list(a.files) == list(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("f", ["1", "2"])
def test_infer_matches_root_infer(setup, f, capsys):
    tmp, _, cfg_path, ckpt = setup
    args = ["-c", cfg_path, "-i", str(tmp / "in.wav"), "--ckpt", ckpt,
            "-f", f]
    _root_cli("infer.py", args + ["-o", str(tmp / f"jax{f}")])
    infer.main(args + ["-o", str(tmp / f"port{f}"), "--device", "cpu"])
    assert "encoder RTF:" in capsys.readouterr().out
    ours = np.load(tmp / f"port{f}_quantized.npy")
    theirs = np.load(tmp / f"jax{f}_quantized.npy")
    assert ours.dtype == np.int16 and ours.shape == (4, 1, 8)
    np.testing.assert_array_equal(ours, theirs)
    a, sr = read_wav(str(tmp / f"port{f}_output.wav"))
    b, _ = read_wav(str(tmp / f"jax{f}_output.wav"))
    assert sr == 24000 and a.shape == b.shape == (512,)
    np.testing.assert_allclose(a, b, rtol=0, atol=1.01 / 32768)


@pytest.mark.parametrize("stream", [False, True])
def test_eval_scores_the_jax_reconstruction(setup, tmp_path, capsys,
                                            stream):
    """The root eval codes Avocodo offline through its trainer's facade
    (its --stream has no Avocodo path); the port's offline run takes the
    facade too, its --stream the full-rate head's streaming drivers."""
    _, _, cfg_path, ckpt = setup
    ref, _ = _wavs(tmp_path, n=2, seconds=0.02)
    args = ["-i", str(ref), "-c", cfg_path, "--ckpt", ckpt, "-m",
            "sisdr,mcd", "-n", "2"]
    theirs = _means(_root_eval(args, capsys))
    port_eval.main(args + ["--device", "cpu"]
                   + (["--stream"] if stream else []))
    ours = _means(capsys.readouterr().out)
    assert set(ours) == set(theirs) == {"sisdr", "mcd"}
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=2e-4,
                                   err_msg=k)


def test_serve_ckpt_equals_params_and_serves(setup):
    tmp, cfg, cfg_path, ckpt = setup
    port_export.main(["-c", cfg_path, "--ckpt", ckpt, "-o",
                      str(tmp / "srv" / "avo"), "--device", "cpu"])
    hps = HParams(**cfg)
    model, p_ckpt, vq_ckpt = serving_weights(hps, ckpt_path=ckpt,
                                             device="cpu")
    assert isinstance(model.codec, TA.AvocodoModel)
    _, p_npz, vq_npz = serving_weights(
        hps, params_path=str(tmp / "srv" / "avo_deploy.npz"), device="cpu")
    a, b = P.flatten(p_ckpt), P.flatten(p_npz)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(vq_ckpt["embed"].numpy(),
                                  vq_npz["embed"].numpy())
    eng = SlotEngine(model, p_ckpt, vq_ckpt, slots=2, fold=False,
                     devices=["cpu"])
    s = eng.attach()
    eng.submit(s, np.zeros(model.hop_length, np.int16))
    out = eng.tick()[s]
    assert out["tokens"].shape == (4,) and out["pcm"].shape == (64,)


def test_bench_avocodo_parses_and_runs(monkeypatch, capsys):
    """--model avocodo is bench.py's AvocodoModel point (8 quantizers); its
    metric takes the `_avocodo` suffix and the frame kernels are refused
    for it."""
    args = bench.parse_args(["4", "--model", "avocodo"])
    assert args.model == "avocodo" and args.streams == 4
    with pytest.raises(SystemExit, match="HILCodec only"):
        bench.parse_args(["4", "--model", "avocodo", "--megakernel"])
    model = bench.build_avocodo_bench_model(CPU)
    assert isinstance(model.codec, TA.AvocodoModel)
    assert model.hop_length == 320 and model.vq.num_quantizers == 8
    assert model.codec.channels_dec == 96 and not model.vq.kmeans_init
    monkeypatch.setattr(bench, "build_avocodo_bench_model",
                        lambda device: CodecModel(
                            TA.AvocodoModel(**TINY),
                            ResidualVQ(dim=16, codebook_size=32,
                                       num_quantizers=8,
                                       kmeans_init=False), device))
    bench.main(["2", "--seconds", "0.01", "--device", "cpu", "--model",
                "avocodo"])
    res = json.loads(capsys.readouterr().out)
    assert res["metric"] == "torch_streaming_encdec_rtf_avocodo"
    assert "device=cpu" in res["unit"] and res["value"] >= 0
