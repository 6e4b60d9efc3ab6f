"""`python -m hilcodec_tpu_torch.eval` against the root `eval.py` on the
CPU: degraded mode prints the same means and intervals, model mode on a
tiny JAX checkpoint (offline and --stream) scores what the JAX codec's
reconstruction scores, and bad arguments exit non-zero."""

import os
import re
import runpy
import sys

import numpy as np
import pytest
import yaml

from hilcodec_tpu.utils.hparams import HParams as JaxHParams

from hilcodec_tpu_torch import eval as port_eval
from hilcodec_tpu_torch.utils.wavio import write_wav

from test_torch_train_loop import ROOT, cut_down
from torch_port_common import write_jax_checkpoint


def _wavs(root, n=3, sr=24000, seconds=0.5):
    """Amplitude-modulated noise (a speech proxy STOI can score) and a
    lightly noised copy of each."""
    ref, deg = root / "ref", root / "deg"
    ref.mkdir()
    deg.mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    for i in range(n):
        clean = 0.3 * rng.standard_normal(len(t)) * (
            0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))
        write_wav(str(ref / f"f{i}.wav"), clean, sr)
        write_wav(str(deg / f"f{i}.wav"),
                  clean + 0.02 * rng.standard_normal(len(t)), sr)
    return ref, deg


def _root_eval(args, capsys):
    old = sys.argv
    try:
        sys.argv = ["eval.py"] + args
        runpy.run_path(os.path.join(ROOT, "eval.py"), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _means(out):
    return {m: float(v) for m, v in re.findall(r"^(\w+): ([-\d.]+) \+/-",
                                               out, re.M)}


def test_degraded_mode_prints_what_root_eval_prints(tmp_path, capsys):
    ref, deg = _wavs(tmp_path)
    args = ["-i", str(ref), "-d", str(deg), "-v",
            "-m", "pesq,stoi,sisdr,mcd,visqol,visqol_audio"]
    theirs = _root_eval(args, capsys)
    port_eval.main(args)
    ours = capsys.readouterr().out
    assert ours == theirs
    assert "== 3 files ==" in ours and len(_means(ours)) == 6


@pytest.mark.parametrize("stream", [False, True])
def test_model_mode_scores_the_jax_reconstruction(tmp_path, capsys,
                                                   stream):
    cfg = cut_down(str(tmp_path))
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    ckpt = str(tmp_path / "00001.ckpt.npz")
    write_jax_checkpoint(JaxHParams(**cfg), ckpt)
    ref, _ = _wavs(tmp_path, n=2, seconds=0.02)
    args = ["-i", str(ref), "-c", str(cfg_path), "--ckpt", ckpt,
            "-m", "sisdr,mcd", "-n", "2"] + (["--stream"] if stream else [])
    theirs = _means(_root_eval(args, capsys))
    port_eval.main(args + ["--device", "cpu"])
    ours = _means(capsys.readouterr().out)
    assert set(ours) == set(theirs) == {"sisdr", "mcd"}
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=2e-4,
                                   err_msg=k)


def test_bad_arguments_exit_non_zero(tmp_path, capsys):
    ref, deg = _wavs(tmp_path, n=1)
    for args, msg in (
            (["-i", str(ref), "-d", str(deg), "-m", "stoi,bogus"],
             "unknown metric"),
            (["-i", str(ref), "-d", str(tmp_path / "nowhere")],
             "does not exist"),
            (["-i", str(tmp_path / "empty.txt"), "-d", str(deg)],
             "no wav files"),
            (["-i", str(ref)], "need -c CONFIG")):
        (tmp_path / "empty.txt").write_text("")
        with pytest.raises(SystemExit, match=msg):
            port_eval.main(args)
    audiodec = tmp_path / "audiodec.yaml"
    audiodec.write_text(yaml.safe_dump({"model": "audiodec",
                                        "model_kwargs": {},
                                        "data": {"sampling_rate": 24000}}))
    # JAX's eval cannot run AudioDec either (its bare generator has no
    # token coding); the port says so
    with pytest.raises(SystemExit, match="model: audiodec"):
        port_eval.main(["-i", str(ref), "-c", str(audiodec), "--device",
                        "cpu"])
