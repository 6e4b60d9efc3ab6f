"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to fall back to the CPU, and every family builds
(AudioDec, the last one ported, deploy-only as in JAX)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "hilcodec_speech.yaml")


def _run(code, cwd=ROOT, **kw):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_and_chip_smoke_import_no_jax():
    """Every module of hilcodec_tpu_torch, and chip_smoke.py, imported in a
    fresh interpreter: neither `jax` nor `hilcodec_tpu` gets loaded, and
    the package import registers the RVQ operator that exported programs
    call."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hilcodec_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'hilcodec_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'hilcodec_tpu' or "
        "m.startswith('hilcodec_tpu.'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
        "assert len(names) >= 60, names\n"
        "assert {'hilcodec_tpu_torch.models.avocodo', "
        "'hilcodec_tpu_torch.train.step_avocodo', "
        "'hilcodec_tpu_torch.ops.shape_gain', "
        "'hilcodec_tpu_torch.models.audiodec', "
        "'hilcodec_tpu_torch.ops.entropy_coding', "
        "'hilcodec_tpu_torch.ops.native_coder', "
        "'hilcodec_tpu_torch.utils.bitstream', "
        "'hilcodec_tpu_torch.serve.entropy_live', "
        "'hilcodec_tpu_torch.train.lm', "
        "'hilcodec_tpu_torch.train_lm', "
        "'hilcodec_tpu_torch.entropy_code', "
        "'hilcodec_tpu_torch.utils.debug', "
        "'hilcodec_tpu_torch.ops.mdct', "
        "'hilcodec_tpu_torch.parallel.dist', "
        "'hilcodec_tpu_torch.data.native', "
        "'hilcodec_tpu_torch.data.pitch_np', "
        "'hilcodec_tpu_torch.utils.onnx_reader', "
        "'hilcodec_tpu_torch.utils.spans', "
        "'hilcodec_tpu_torch.ops.adamp_kernel', "
        "'hilcodec_tpu_torch.scripts.flops_analysis', "
        "'hilcodec_tpu_torch.scripts.streaming_roofline', "
        "'hilcodec_tpu_torch.scripts.bench_train_step', "
        "'hilcodec_tpu_torch.scripts.serve_device_floor', "
        "'hilcodec_tpu_torch.scripts.serve_load', "
        "'hilcodec_tpu_torch.scripts.bench_dwconv', "
        "'hilcodec_tpu_torch.scripts.make_synth_corpus'} <= set(names)\n"
        "import torch\n"
        "assert torch.ops.hilcodec.rvq_cascade.default is not None\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr[-2000:]


def test_no_jax_import_statements():
    """No source line of the port or of chip_smoke.py imports JAX or the
    JAX package."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "hilcodec_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            for ln in f:
                s = ln.strip()
                assert not s.startswith(("import jax", "from jax",
                                         "import hilcodec_tpu ",
                                         "from hilcodec_tpu.",
                                         "from hilcodec_tpu ")), (path, s)


def test_entry_points_refuse_cpu_fallback(tmp_path):
    """device=None means CUDA: without it the model, the engine and the
    CLIs raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hilcodec_tpu_torch import resolve_device
    from hilcodec_tpu_torch.models.registry import build_codec_model
    from hilcodec_tpu_torch.utils.hparams import load_config
    kw = load_config(CONFIG).model_kwargs.to_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_codec_model("hilcodec", kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    out = _run(["-m", "hilcodec_tpu_torch.serve", "-c", CONFIG])
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    from hilcodec_tpu_torch import eval as tools_eval
    from hilcodec_tpu_torch import export, infer
    from hilcodec_tpu_torch.utils.wavio import write_wav
    wav = str(tmp_path / "a.wav")
    write_wav(wav, np.zeros(960), 24000)
    for main, argv in (
            (export.main, ["-c", CONFIG, "-o", str(tmp_path / "x")]),
            (infer.main, ["-c", CONFIG, "-i", wav, "-o",
                          str(tmp_path / "y")]),
            (tools_eval.main, ["-c", CONFIG, "-i", wav])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert os.listdir(tmp_path) == ["a.wav"]


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when CUDA is
    unavailable, and in a directory that holds only chip_smoke.py."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0 and '"ok": true' not in out.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0 and '"ok": true' not in out.stdout


def test_config_builds_flagship_shapes():
    """configs/hilcodec_speech.yaml, unmodified, builds the flagship."""
    from hilcodec_tpu_torch.models.registry import build_codec_model
    from hilcodec_tpu_torch.utils.hparams import load_config
    hp = load_config(CONFIG)
    assert hp.model == "hilcodec" and hp.data.sampling_rate == 24000
    m = build_codec_model(hp.model, hp.model_kwargs.to_dict(), device="cpu")
    assert m.hop_length == 320 and m.codec.encoder.n_filters == 64
    assert m.codec.decoder.n_filters == 96
    assert (m.vq.num_quantizers, m.vq.codebook_size, m.vq.dim) == (8, 1024,
                                                                   128)


@pytest.mark.parametrize("entry", ["registry", "trainer"])
def test_unported_families_point_at_roadmap(entry):
    """audiodec, the last family ported, through the registry (the
    full-width AudioDec with RVQ 8 x 1024 x 64) and `build_trainer`
    (deploy-only: the JAX loop's own ValueError)."""
    from hilcodec_tpu_torch.models.audiodec import AudioDec
    from hilcodec_tpu_torch.models.registry import build_codec_model
    from hilcodec_tpu_torch.train.loop import build_trainer
    from hilcodec_tpu_torch.utils.hparams import HParams
    if entry == "registry":
        m = build_codec_model("audiodec", {}, device="cpu")
        assert isinstance(m.codec, AudioDec) and m.hop_length == 300
        assert (m.vq.num_quantizers, m.vq.codebook_size, m.vq.dim) == (
            8, 1024, 64)
    else:
        with pytest.raises(ValueError, match="deploy-only"):
            build_trainer(HParams(model="audiodec", model_kwargs={},
                                  train={}), "cpu")
