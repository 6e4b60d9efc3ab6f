"""The port's training entry points on a cut-down flagship config, on the
CPU: `build_trainer`, a `TrainLoop` epoch on a seeded corpus, the CLI
(`python -m hilcodec_tpu_torch.train`) with resume, its refusal to train
on the CPU unasked, and checkpoints crossing between the two packages in
both directions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from hilcodec_tpu.models import discriminators as jax_discs
from hilcodec_tpu.train.loop import build_trainer as jax_build_trainer
from hilcodec_tpu.utils import checkpoint as jax_ckpt
from hilcodec_tpu.utils.hparams import HParams as JaxHParams

from hilcodec_tpu_torch.train.loop import TrainLoop, build_trainer
from hilcodec_tpu_torch.utils import checkpoint as ckpt
from hilcodec_tpu_torch.utils import params as P
from hilcodec_tpu_torch.utils.hparams import HParams, load_config
from hilcodec_tpu_torch.utils.wavio import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(ROOT, "configs", "hilcodec_speech_synth.yaml")
SEGMENT = 2048          # >= the mel loss's largest n_fft (1024)


def cut_down(corpus: str) -> dict:
    """configs/hilcodec_speech_synth.yaml at a tiny width on `corpus`:
    2 steps of batch 2 per epoch, a 2-item valid filelist."""
    with open(SYNTH) as f:
        cfg = yaml.safe_load(f)
    cfg["model_kwargs"].update(
        channels_enc=8, channels_dec=8, n_residual_enc=1, n_residual_dec=1,
        strides=[4, 2], n_fft_base=16)
    cfg["model_kwargs"]["vq_kwargs"].update(
        dim=16, codebook_size=32, num_quantizers=3, dropout_index=[1, 2, 3])
    cfg["disc_kwargs"]["mfbd_kwargs"].update(
        periods=[1, 2], taps=16, cutoff_freqs=[0.0, 0.25], channels=[4, 8],
        kernel_sizes=[5, 5], strides=[3, 1])
    cfg["disc_kwargs"]["mstftd_kwargs"].update(
        n_ffts=[64], hop_lengths=[16], win_lengths=[64], filters=4)
    data = cfg["data"]
    data["classes"]["clean"]["directories_to_include"] = [
        os.path.join(corpus, "train")]
    data.update(length=4, segment_size=SEGMENT, wav_dir=corpus,
                filelists={"valid": os.path.join(corpus, "valid.txt")})
    cfg["train"].update(batch_size=2, max_epochs=1, save_interval=1,
                        num_workers=0, n_mels_max=16)
    cfg["valid"] = {"batch_size": 2}
    return cfg


def make_corpus(root: str) -> None:
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    t = np.arange(3 * SEGMENT) / 24000
    for i in range(4):
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) \
            + 0.05 * rng.standard_normal(t.shape)
        write_wav(os.path.join(root, "train", f"{i}.wav"), wav, 24000)
    for i in range(2):
        write_wav(os.path.join(root, f"v{i}.wav"),
                  0.1 * rng.standard_normal(SEGMENT), 24000)
    with open(os.path.join(root, "valid.txt"), "w") as f:
        f.write("v0.wav\nv1.wav\n")


@pytest.fixture
def setup(tmp_path):
    make_corpus(str(tmp_path))
    cfg = cut_down(str(tmp_path))
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return tmp_path, cfg, str(path)


def test_build_trainer_from_cut_down_config(setup):
    _, cfg, _ = setup
    tr = build_trainer(HParams(**cfg), "cpu")
    assert tr.model.vq.dropout_index == (1, 2, 3)
    assert tr.model.vq.ema_num_threshold == 0.5
    assert list(tr.disc.discs) == ["mfbd", "mstftd"]
    assert tr.optim_g.betas == (0.5, 0.9) and tr.lr_g == 5e-4
    assert tr.sched_g.warmup_iterations == 500
    assert tr.mel_loss.transforms[-1] == (1024, 256, 16)
    for key, value, err in (
            (("disc_kwargs", "mpd_kwargs"), {"use": True},
             NotImplementedError),
            (("train", "optimizer"), "SGDP", NotImplementedError),
            (("train", "compute_dtype"), "bfloat16", NotImplementedError),
            (("train", "remat"), "all", NotImplementedError),
            (("train", "fbd_lowering"), "conv3d", ValueError)):
        bad = HParams(**cfg)
        bad[key[0]][key[1]] = value
        with pytest.raises(err):
            build_trainer(bad, "cpu")


def test_train_loop_epoch_and_checkpoint(setup):
    tmp, cfg, _ = setup
    loop = TrainLoop(HParams(**cfg), run_dir=str(tmp / "run"), device="cpu")
    loop.init_or_resume()
    embed0 = loop.state.vq_state["embed"].clone()
    loop.run()
    assert loop.iteration == 2 and int(loop.state.iteration) == 2
    assert int(loop.state.epoch) == 1
    assert bool(loop.state.vq_state["initted"])
    assert not torch.equal(embed0, loop.state.vq_state["embed"])
    assert ckpt.latest_checkpoint(str(tmp / "run"))[0] == 1
    valid = loop.valid_epoch()
    assert valid and all(np.isfinite(v) for v in valid.values())

    # a fresh loop resumes where this one stopped
    again = TrainLoop(HParams(**cfg), run_dir=str(tmp / "run"), device="cpu")
    again.init_or_resume()
    assert again.epoch == 1 and again.iteration == 2
    for a, b in zip(P.flatten(loop.state.params_g).values(),
                    P.flatten(again.state.params_g).values()):
        assert torch.equal(a, b)


def _cli(args, tmp):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "hilcodec_tpu_torch.train",
                           "-n", "t", "-b", str(tmp / "logs")] + args,
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_trains_then_resumes(setup):
    tmp, _, path = setup
    out = _cli(["-c", path, "--device", "cpu"], tmp)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp / "logs" / "t" / "00001.ckpt.npz").exists()
    out = _cli(["--device", "cpu", "-p", "train.max_epochs=2"], tmp)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resumed from" in out.stdout
    assert (tmp / "logs" / "t" / "00002.ckpt.npz").exists()


def test_cli_refuses_cpu_without_device(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, _, path = setup
    out = _cli(["-c", path], tmp)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp / "logs" / "t" / "00001.ckpt.npz").exists()


def _jax_trainer(cfg):
    try:
        return jax_build_trainer(JaxHParams(**cfg))
    finally:
        jax_discs.set_fbd_lowering("conv2d")


def test_checkpoints_cross_both_ways(setup):
    """JAX's load_checkpoint reads the port's .ckpt.npz leaf for leaf, and
    the port resumes from one that JAX wrote."""
    tmp, cfg, _ = setup
    loop = TrainLoop(HParams(**cfg), run_dir=str(tmp / "port"),
                     device="cpu")
    loop.run()
    path = ckpt.latest_checkpoint(str(tmp / "port"))[1]

    jtr = _jax_trainer(cfg)
    template = jtr.init_state(jax.random.PRNGKey(3))
    jstate, extras = jax_ckpt.load_checkpoint(path, template)
    assert int(extras["epoch"]) == 1
    ours = P.tree_to_flat(loop.state)
    theirs = jax_ckpt._flatten(jstate)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)

    # and back: a JAX-written checkpoint resumes the port's loop
    jax_ckpt.save_checkpoint(str(tmp / "jax"), 1, template, {"epoch": 1})
    back = TrainLoop(HParams(**cfg), run_dir=str(tmp / "jax"), device="cpu")
    back.init_or_resume()
    assert back.epoch == 1
    resumed = P.tree_to_flat(back.state)
    for k, v in jax_ckpt._flatten(template).items():
        np.testing.assert_array_equal(resumed[k], np.asarray(v), err_msg=k)
    back.run(max_epochs=2)
    assert ckpt.latest_checkpoint(str(tmp / "jax"))[0] == 2
