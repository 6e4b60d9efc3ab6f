"""The port's tools on a tiny configs/encodec_24khz.yaml and one JAX
checkpoint, on the CPU: `python -m hilcodec_tpu_torch.export` against the
root `export.py` (deploy npz, LSTM leaves included, and the cache npz
files in JAX's order), `infer` against the root `infer.py` at 1 and 2
frames a step (int16 tokens [n_q, 1, T] exactly, the wav within one PCM
step), `eval` in model mode (offline and --stream) against the root
`eval.py`, and `serve --ckpt` against `serve --params` with one engine
tick on the result."""

import os
import runpy
import sys

import numpy as np
import pytest
import yaml

from hilcodec_tpu.utils.hparams import HParams as JaxHParams

from hilcodec_tpu_torch import eval as port_eval
from hilcodec_tpu_torch import export as port_export
from hilcodec_tpu_torch import infer
from hilcodec_tpu_torch.serve import SlotEngine
from hilcodec_tpu_torch.serve.__main__ import serving_weights
from hilcodec_tpu_torch.utils import params as P
from hilcodec_tpu_torch.utils.hparams import HParams
from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

from test_torch_eval_cli import _means, _root_eval, _wavs
from test_torch_train_loop import ROOT, cut_down_encodec
from torch_port_common import write_jax_checkpoint


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
    tmp = tmp_path_factory.mktemp("encodec_tools")
    cfg = cut_down_encodec(str(tmp))
    cfg_path = str(tmp / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    ckpt = str(tmp / "00001.ckpt.npz")
    write_jax_checkpoint(JaxHParams(**cfg), ckpt)
    rng = np.random.default_rng(0)
    t = np.arange(240) / 24000
    write_wav(str(tmp / "in.wav"), 0.3 * np.sin(2 * np.pi * 220 * t)
              + 0.05 * rng.standard_normal(240), 24000)
    return tmp, cfg, cfg_path, ckpt


def test_export_matches_root_export(setup):
    tmp, _, cfg_path, ckpt = setup
    argv = ["-c", cfg_path, "--ckpt", ckpt]
    _root_cli("export.py", argv + ["-o", str(tmp / "jax" / "enc")])
    port_export.main(argv + ["-o", str(tmp / "port" / "enc"),
                             "--device", "cpu"])
    ours = _load(tmp / "port" / "enc_deploy.npz")
    theirs = _load(tmp / "jax" / "enc_deploy.npz")
    assert set(ours) == set(theirs)
    assert ours["codebooks"].shape == (4, 32, 16)
    assert "encoder/lstm/layers/1/w_ih" in ours
    for k, v in theirs.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
    for side in ("enc", "dec"):
        a = np.load(tmp / "port" / f"enc_cache_{side}.npz")
        b = np.load(tmp / "jax" / f"enc_cache_{side}.npz")
        assert list(a.files) == list(b.files) and len(a.files) == 8
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
    assert ours.dtype == np.int16 and ours.shape == (4, 1, 30)
    np.testing.assert_array_equal(ours, theirs)
    a, sr = read_wav(str(tmp / f"port{f}_output.wav"))
    b, _ = read_wav(str(tmp / f"jax{f}_output.wav"))
    assert sr == 24000 and a.shape == b.shape == (240,)
    np.testing.assert_allclose(a, b, rtol=0, atol=1.01 / 32768)


@pytest.mark.parametrize("stream", [False, True])
def test_eval_scores_the_jax_reconstruction(setup, tmp_path, capsys,
                                            stream):
    _, _, cfg_path, ckpt = setup
    ref, _ = _wavs(tmp_path, n=2, seconds=0.02)
    args = ["-i", str(ref), "-c", cfg_path, "--ckpt", ckpt, "-m",
            "sisdr,mcd", "-n", "4"] + (["--stream"] if stream else [])
    theirs = _means(_root_eval(args, capsys))
    port_eval.main(args + ["--device", "cpu"])
    ours = _means(capsys.readouterr().out)
    assert set(ours) == set(theirs) == {"sisdr", "mcd"}
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=2e-4,
                                   err_msg=k)


def test_serve_ckpt_equals_params_and_serves(setup):
    tmp, cfg, cfg_path, ckpt = setup
    port_export.main(["-c", cfg_path, "--ckpt", ckpt, "-o",
                      str(tmp / "srv" / "enc"), "--device", "cpu"])
    hps = HParams(**cfg)
    model, p_ckpt, vq_ckpt = serving_weights(hps, ckpt_path=ckpt,
                                             device="cpu")
    _, p_npz, vq_npz = serving_weights(
        hps, params_path=str(tmp / "srv" / "enc_deploy.npz"), device="cpu")
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
    assert out["tokens"].shape == (4,) and out["pcm"].shape == (8,)
