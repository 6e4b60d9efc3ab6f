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
from hilcodec_tpu_torch.utils import summarize as S
from hilcodec_tpu_torch.utils.hparams import HParams, load_config
from hilcodec_tpu_torch.utils.wavio import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(ROOT, "configs", "hilcodec_speech_synth.yaml")
ENCODEC = os.path.join(ROOT, "configs", "encodec_24khz.yaml")
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


def cut_down_encodec(corpus: str) -> dict:
    """configs/encodec_24khz.yaml at a tiny width on `corpus` (a two-stage
    EnCodec with a 2-layer LSTM of width 32, 4 quantizers with dropout,
    one MSTFTD on complex spectra): 2 steps of batch 2 per epoch, a 2-item
    valid filelist."""
    with open(ENCODEC) as f:
        cfg = yaml.safe_load(f)
    cfg["model_kwargs"].update(channels_enc=8, channels_dec=8,
                               strides=[4, 2])
    cfg["model_kwargs"]["vq_kwargs"].update(dim=16, codebook_size=32,
                                            num_quantizers=4)
    cfg["disc_kwargs"]["mstftd_kwargs"].update(
        n_ffts=[64], hop_lengths=[16], win_lengths=[64], filters=4)
    data = cfg["data"]
    data["classes"]["clean"]["directories_to_include"] = [
        os.path.join(corpus, "train")]
    data.update(length=4, segment_size=SEGMENT, wav_dir=corpus,
                filelists={"valid": os.path.join(corpus, "valid.txt")})
    cfg["train"].update(batch_size=2, max_epochs=1, save_interval=1,
                        num_workers=0, n_mels_max=16,
                        plot_param_and_grad=False)
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
    sgdp = {"optimizer": "SGDP",
            "optimizer_kwargs": {"lr": 5e-4, "momentum": 0.9}}
    for section, values, check in (
            ("disc_kwargs", {"mpd_kwargs": {"use": True}},
             lambda tr: list(tr.disc.discs) == ["mfbd", "mpd", "mstftd"]),
            ("train", sgdp, lambda tr: type(tr.optim_g).__name__ == "SGDP"),
            ("train", {"compute_dtype": "bfloat16"},
             lambda tr: tr.compute_dtype == torch.bfloat16),
            ("train", {"remat": "all"}, lambda tr: tr.remat == "all")):
        ok = HParams(**cfg)
        for k, v in values.items():
            ok[section][k] = v
        assert check(build_trainer(ok, "cpu")), values
    for key, value, match in (
            (("train", "optimizer"), "SAM", "cannot drive SAM"),
            (("train", "compute_dtype"), "float8", "compute_dtype"),
            (("train", "depthwise_lowering"), "im2col",
             "depthwise lowering"),
            (("train", "fbd_lowering"), "conv3d", "fbd lowering")):
        bad = HParams(**cfg)
        bad[key[0]][key[1]] = value
        with pytest.raises(ValueError, match=match):
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


@pytest.mark.parametrize("absent,infer,line", [
    ([], True, None),
    (["matplotlib"], True, "TrainLoop: not writing the infer epoch's log-mel "
                           "images (matplotlib is not installed)"),
    (["tensorboard", "matplotlib"], True,
     "TrainLoop: not writing the train and valid scalars, metric/*, the "
     "parameter and gradient histograms (plot_param_and_grad), the infer "
     "epoch's audio and log-mel images (tensorboard is not installed)"),
    ([], False, "TrainLoop: not writing the infer epoch (no infer data: "
                "KeyError 'infer')"),
])
def test_loop_names_what_it_cannot_write(setup, monkeypatch, capsys, absent,
                                         infer, line):
    """The flagship's summary keys are never dropped silently: with a
    package or an epoch's filelist missing the loop says in one line what
    it will not write and trains on; with the flagship's metrics all off,
    the pesq epoch is a no-op."""
    tmp, cfg, _ = setup
    cfg["train"]["plot_param_and_grad"] = True
    if infer:
        cfg["data"]["filelists"]["infer"] = str(tmp / "valid.txt")
    cfg["pesq"] = {"interval": 1, "metrics_to_calculate": {
        "pesq": False, "stoi": False, "visqol": False,
        "visqol_audio": False}}
    loop = TrainLoop(HParams(**cfg), run_dir=str(tmp / "run"), device="cpu")
    monkeypatch.setattr(S, "missing", lambda: list(absent))
    loop._open_writers()
    try:
        out = capsys.readouterr().out.splitlines()
        assert out == ([line] if line else [])
        assert (loop.writer_train is None) == ("tensorboard" in absent)
        assert loop.plot_param_and_grad == ("tensorboard" not in absent)
        assert loop._images == (not absent)
        assert (loop.infer_loader is None) == (not infer)
        assert loop.pesq_epoch() == {} and loop.metrics._executor is None
    finally:
        loop._close()


@pytest.fixture
def setup_encodec(tmp_path):
    make_corpus(str(tmp_path))
    return tmp_path, cut_down_encodec(str(tmp_path))


def test_build_trainer_from_encodec_config(setup_encodec):
    """configs/encodec_24khz.yaml selects the shared balancer trainer: its
    MSTFTD-only discriminators on complex spectra, its balancer keys, the
    EnCodec codec and 32 quantizers with dropout (cut to 4 here)."""
    from hilcodec_tpu_torch.models.encodec import EncodecModel
    _, cfg = setup_encodec
    tr = build_trainer(HParams(**cfg), "cpu")
    assert isinstance(tr.model.codec, EncodecModel)
    assert tr.model.codec.lstm == 2 and tr.model.hop_length == 8
    assert tr.model.vq.dropout and tr.model.vq.kmeans_init
    assert list(tr.disc.discs) == ["mstftd"]
    assert not tr.disc.discs["mstftd"].magnitude
    assert dict(tr.balancer.weights) == {"freq": 1.0, "mstftd_g": 3.0,
                                         "mstftd_fm": 3.0}
    assert tr.optim_g.betas == (0.5, 0.9) and tr.lr_g == 5e-4
    full = build_trainer(load_config(ENCODEC), "cpu")
    assert full.model.vq.num_quantizers == 32
    assert full.mel_loss.transforms[-1][0] == 1024


def test_train_loop_encodec_epoch_and_checkpoint(setup_encodec):
    """`model: encodec` trains an epoch through the shared trainer, writes
    its checkpoint, and a fresh loop resumes from it (the port's side of
    tests/test_train_loop.py::test_train_loop_encodec_family)."""
    from hilcodec_tpu_torch.models.encodec import EncodecModel
    tmp, cfg = setup_encodec
    loop = TrainLoop(HParams(**cfg), run_dir=str(tmp / "enc"), device="cpu")
    assert isinstance(loop.trainer.model.codec, EncodecModel)
    loop.init_or_resume()
    embed0 = loop.state.vq_state["embed"].clone()
    lstm0 = loop.state.params_g["encoder"]["lstm"]["layers"][0]["w_hh"]
    lstm0 = lstm0.clone()
    loop.run(max_epochs=1)
    assert loop.epoch == 1 and loop.iteration == 2
    assert bool(loop.state.vq_state["initted"])
    assert not torch.equal(embed0, loop.state.vq_state["embed"])
    assert not torch.equal(
        lstm0, loop.state.params_g["encoder"]["lstm"]["layers"][0]["w_hh"])
    assert ckpt.latest_checkpoint(str(tmp / "enc"))[0] == 1
    again = TrainLoop(HParams(**cfg), run_dir=str(tmp / "enc"), device="cpu")
    again.init_or_resume()
    assert again.epoch == 1 and again.iteration == 2
    for a, b in zip(P.flatten(loop.state.params_g).values(),
                    P.flatten(again.state.params_g).values()):
        assert torch.equal(a, b)


def test_encodec_checkpoints_cross_both_ways(setup_encodec):
    """An EnCodec run's .ckpt.npz, LSTM leaves included, loads in the JAX
    package leaf for leaf, and one that JAX wrote resumes the port."""
    tmp, cfg = setup_encodec
    loop = TrainLoop(HParams(**cfg), run_dir=str(tmp / "port"),
                     device="cpu")
    loop.run()
    path = ckpt.latest_checkpoint(str(tmp / "port"))[1]
    template = _jax_trainer(cfg).init_state(jax.random.PRNGKey(3))
    jstate, extras = jax_ckpt.load_checkpoint(path, template)
    assert int(extras["epoch"]) == 1
    ours, theirs = P.tree_to_flat(loop.state), jax_ckpt._flatten(jstate)
    assert set(ours) == set(theirs)
    assert ".params_g/decoder/lstm/layers/1/b_ih" in ours
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)
    jax_ckpt.save_checkpoint(str(tmp / "jax"), 1, template, {"epoch": 1})
    back = TrainLoop(HParams(**cfg), run_dir=str(tmp / "jax"), device="cpu")
    back.init_or_resume()
    assert back.epoch == 1
    resumed = P.tree_to_flat(back.state)
    for k, v in jax_ckpt._flatten(template).items():
        np.testing.assert_array_equal(resumed[k], np.asarray(v), err_msg=k)
