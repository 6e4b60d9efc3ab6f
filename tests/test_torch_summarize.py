"""The port's TensorBoard summaries (utils/summarize.py) and the parts of
`TrainLoop` that write them, against the JAX package on the CPU: the
histogram names and their NaN/Inf guard, and one epoch of a tiny loop with
the infer and pesq epochs and the histograms on, whose event files carry
JAX's tags and whose infer epoch reconstructs what JAX's does."""

import io
import os

import numpy as np
import pytest
import torch

import jax

from hilcodec_tpu.models import discriminators as jax_discs
from hilcodec_tpu.train.loop import TrainLoop as JaxTrainLoop
from hilcodec_tpu.utils import summarize as JS
from hilcodec_tpu.utils.hparams import HParams as JaxHParams

from hilcodec_tpu_torch.train.loop import TrainLoop
from hilcodec_tpu_torch.utils import summarize as S
from hilcodec_tpu_torch.utils.hparams import HParams

from test_torch_train_loop import cut_down, make_corpus
from torch_port_common import both_params, models, n


def test_plot_param_and_grad_names_and_guard_match_jax():
    """Every leaf under its JAX path, the same leaves dropped for a NaN, an
    Inf or no elements, the same values kept."""
    jm, tm = models()
    pj, pt = both_params(jm, tm)
    gj = jax.tree.map(lambda x: x * 2.0, pj)
    gt = _tmap(lambda x: x * 2.0, pt)
    for tree in (pj, pt):
        tree["encoder"]["conv_pre"]["v"] = _poison(tree, np.nan)
    for tree in (gj, gt):
        tree["decoder"]["pre_pw"]["g"] = _poison(tree, np.inf, "decoder",
                                                 "pre_pw", "g")
    ours, theirs = {}, {}
    S.plot_param_and_grad(ours, pt, gt, "model")
    JS.plot_param_and_grad(theirs, pj, gj, "model")
    assert set(ours) == set(theirs)
    assert "model/encoder/conv_pre/v" not in ours
    assert "model_grad/decoder/pre_pw/g" not in ours
    assert "model_grad/encoder/conv_pre/v" in ours
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    empty = {}
    S.plot_param_and_grad(empty, {"e": torch.zeros(0)}, None, "m")
    assert empty == {}


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tmap(fn, v) for v in tree]
    return fn(tree)


def _poison(tree, value, *path):
    path = path or ("encoder", "conv_pre", "v")
    leaf = tree
    for p in path:
        leaf = leaf[p]
    arr = np.array(n(leaf))
    arr.reshape(-1)[0] = value
    return torch.from_numpy(arr) if isinstance(leaf, torch.Tensor) \
        else jax.numpy.asarray(arr)


def test_summarize_and_progress_line(tmp_path, capsys):
    writer = S.get_writer(str(tmp_path))
    S.summarize(writer, 3, scalars={"loss/freq": 1.25},
                scalars_not_to_print={"lr": 5e-4},
                specs={"valid/spec": np.random.default_rng(0).random(
                    (16, 40))},
                audios={"valid/audio": np.sin(np.linspace(0, 50, 2400))},
                hists={"g/w": np.random.default_rng(1).standard_normal(64)})
    writer.close()
    out = capsys.readouterr().out
    assert "loss/freq: 1.2500" in out and "lr" not in out
    tags = _tags(str(tmp_path))
    assert tags["scalars"] == ["loss/freq", "lr"]
    assert (tags["images"], tags["audio"], tags["histograms"]) == (
        ["valid/spec"], ["valid/audio"], ["g/w"])
    buf = io.StringIO()
    S.progress_line("step 1/10", file=buf)
    assert buf.getvalue() == "\r\033[Kstep 1/10"


def _tags(log_dir):
    """The tags of an event directory (read after S.get_writer has made
    tensorboard take its TensorFlow stub)."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    ea = EventAccumulator(log_dir, size_guidance={
        "scalars": 0, "histograms": 0, "images": 0, "audio": 0})
    ea.Reload()
    return {k: sorted(v) for k, v in ea.Tags().items()
            if k in ("scalars", "histograms", "images", "audio")}


def loop_config(root) -> dict:
    """cut_down with the flagship's summaries on at interval 1: the
    histograms, the infer epoch at 2 quantizers and SI-SDR on the pesq
    filelist."""
    make_corpus(root)
    cfg = cut_down(root)
    valid = os.path.join(root, "valid.txt")
    cfg["data"]["filelists"].update(infer=valid, pesq=valid)
    cfg["data"]["num_infer"] = 2
    cfg["train"].update(plot_param_and_grad=True, infer_n=2)
    cfg["infer"] = {"interval": 1, "batch_size": 1}
    cfg["pesq"] = {"interval": 1, "batch_size": 2, "num_workers": 0,
                   "metrics_to_calculate": {"pesq": False, "stoi": False,
                                            "sisdr": True}}
    return cfg


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    cfg = loop_config(str(tmp))
    loop = TrainLoop(HParams(**cfg), run_dir=str(tmp / "port"),
                     device="cpu")
    loop.run()
    try:
        jloop = JaxTrainLoop(JaxHParams(**cfg), run_dir=str(tmp / "jax"))
        jloop.run()
        jloop.writer_train.close()     # JAX's loop leaves them open
        jloop.writer_valid.close()
        # JAX's loop on the port's final state, read from its checkpoint
        jresumed = JaxTrainLoop(JaxHParams(**cfg),
                                run_dir=str(tmp / "port"))
        jresumed.init_or_resume()
    finally:
        jax_discs.set_fbd_lowering("conv2d")
    return tmp, loop, jresumed


@pytest.mark.parametrize("part", ["train", "valid"])
def test_loop_writes_the_tags_jax_writes(both_runs, part):
    tmp, _, _ = both_runs
    ours = _tags(str(tmp / "port" / part))
    theirs = _tags(str(tmp / "jax" / part))
    assert ours == theirs
    if part == "train":
        assert any(t.startswith("model_grad/") for t in ours["histograms"])
        assert any(t.startswith("disc/") for t in ours["histograms"])
    else:
        assert "metric/sisdr" in ours["scalars"]
        assert ours["audio"] == ["gen/wav_0", "gen/wav_1", "gt/wav_0",
                                 "gt/wav_1"]


def test_infer_epoch_matches_jax_on_the_same_state(both_runs):
    _, loop, jloop = both_runs
    audios, specs = loop.infer_epoch()
    jaudios, jspecs = jloop.infer_epoch()
    assert set(audios) == set(jaudios) and len(audios) == 4
    for k in jaudios:
        np.testing.assert_allclose(audios[k], np.asarray(jaudios[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert set(specs) == set(jspecs)
    for k in jspecs:
        np.testing.assert_allclose(specs[k], np.asarray(jspecs[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert loop.pesq_epoch().keys() == {"sisdr"}
    # the best metric crossed in the checkpoint's extras
    assert jloop.metrics.state_dict().keys() == {"sisdr"}
    np.testing.assert_allclose(jloop.metrics.state_dict()["sisdr"],
                               loop.metrics.best["sisdr"], rtol=1e-6)
