"""The reference against the port at tiny widths on the CPU, its imports,
and its FLOP count against the port's own counter
(`hilcodec_tpu_torch/scripts/flops_analysis.py`)."""

import ast
import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.reference import codec_ref, train_ref
from benchmark.tests import tiny

REF_DIR = os.path.join(common.HERE, "reference")
CONFIGS = {n: tiny.tiny_config(common.read_json(
    os.path.join(common.HERE, "configs", n + ".json")))
    for n in ("hilcodec_speech", "audiodec_24k")}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port_or_jax():
    for dirpath, _, files in os.walk(REF_DIR):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    top = mod.split(".")[0]
                    assert top not in ("hilcodec_tpu_torch", "hilcodec_tpu",
                                       "jax", "jaxlib", "flax"), (f, mod)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_drivers_build_what_the_registry_builds(name):
    from benchmark.drivers import port
    from hilcodec_tpu_torch.models.registry import build_codec_model
    cfg, cpu = CONFIGS[name], torch.device("cpu")
    assert port.codec_model(cfg, cpu) == build_codec_model(
        cfg["model"], dict(cfg["model_kwargs"]), device=cpu)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_codec_against_the_port_streaming(name):
    """The port's streaming drivers against the reference's offline
    passes on the same weights: tokens within the teacher-forced gap of
    rounding, PCM within one int16 step."""
    from benchmark.drivers import port
    cfg = CONFIGS[name]
    cpu = torch.device("cpu")
    ref = codec_ref.build(cfg, cpu)
    model = port.codec_model(cfg, cpu)
    params, books = codec_ref.make_weights(ref, 11)
    p_port, vq, dtype = port.stream_params(model, params, books, "f32", cpu)
    gen = common.device_generator(cpu, 3)
    hop = model.hop_length
    wav = common.speech_band(gen, 2, 12 * hop, cpu)
    ce, cd = model.init_cache(2, dtype)
    tok, _ = model.encode_stream(p_port, vq, wav, ce)
    out, _ = model.decode_stream(p_port, vq, tok, cd)
    p_ref, b_ref = codec_ref.folded_weights(ref, 11, cpu)
    for i in range(2):
        gap, err = codec_ref.check_stream(
            ref, p_ref, b_ref, wav[i, 0], tok[:, i],
            common.to_int16(out[i, 0]))
        assert gap <= 1e-5 and err <= 1.0


def test_reference_offline_codec_equals_the_ports():
    cfg = CONFIGS["hilcodec_speech"]
    from benchmark.drivers import port
    cpu = torch.device("cpu")
    ref = codec_ref.build(cfg, cpu)
    model = port.codec_model(cfg, cpu)
    params, _ = codec_ref.make_weights(ref, 5)
    wav = common.speech_band(common.device_generator(cpu, 1), 2, 640, cpu)
    z_port = model.codec.encoder.apply(model.fold_params(params)["encoder"],
                                       wav)
    z_ref = ref.encode_latent(ref.fold_params(params), wav)
    assert torch.allclose(z_port, z_ref, atol=1e-6)


def _tiny_train_config():
    return CONFIGS["hilcodec_speech"]


def test_reference_train_step_against_the_port():
    """Two steps of the port's trainer and the reference's from the same
    state, batches and draws, on the CPU: equal losses and updates."""
    from benchmark.drivers import port, train_steps
    from hilcodec_tpu_torch.train.loop import build_trainer
    cfg = _tiny_train_config()
    cpu = torch.device("cpu")
    prog = build_trainer(port.hparams(cfg), cpu)
    ref = train_ref.build(cfg, cpu)
    w = train_ref.make_weights(ref, 9)
    it = train_ref.start_iteration(cfg)
    sp = train_steps._program_state(prog, copy.deepcopy(w), it)
    sr = train_ref.init_state(ref, copy.deepcopy(w), it)
    for k in range(2):
        wav = common.speech_band(common.device_generator(cpu, 40 + k), 2,
                                 4800, cpu)
        sp, mp = prog.train_step(sp, wav, prog.sample_draws(
            torch.Generator().manual_seed(k), wav.shape))
        sr, mr = ref.train_step(sr, wav, ref.sample_draws(
            torch.Generator().manual_seed(k), wav.shape))
        for key in mr:
            if key.startswith("loss/"):
                assert float(mp[key]) == pytest.approx(float(mr[key]),
                                                       rel=1e-5, abs=1e-7)
    lp, lr = train_ref.leaves(sp.params_g), train_ref.leaves(sr.params_g)
    for key in lr:
        assert torch.allclose(lp[key], lr[key], rtol=1e-5, atol=1e-7), key


def test_norm_gap_leaves_out_leaves_the_reference_does_not_move():
    ref = {"a": torch.ones(4), "b": torch.ones(4) * 2, "c": torch.zeros(4)}
    prog = {"a": torch.ones(4), "b": torch.ones(4) * 2.2,
            "c": torch.ones(4)}
    gap, at, out = train_ref.norm_gap(prog, ref, ref)
    assert at == "b" and gap == pytest.approx(0.1) and out == 1


def test_frame_step_count_equals_the_ports_counter():
    """The reference's frame-step FLOPs equal the port's counter run on
    the port's own frame step (the encoder step, the RVQ kernel, the
    decoder step) at tiny widths."""
    from benchmark.drivers import port
    from hilcodec_tpu_torch.ops import rvq_kernel
    from hilcodec_tpu_torch.scripts import flops_analysis as fa
    cfg = CONFIGS["hilcodec_speech"]
    meta = torch.device("meta")
    ref = codec_ref.build(cfg, "cpu")
    w = codec_ref.frame_step_work(ref, 4)
    model = port.codec_model(cfg, torch.device("cpu"))
    params = fa.to_meta(model.fold_params(
        model.codec.init(torch.Generator().manual_seed(0))))
    ce, cd = fa.to_meta(model.init_cache(4))
    hop, vq = model.hop_length, model.vq
    wav = torch.zeros((4, 1, hop), device=meta)
    enc = fa.totals(fa.analyze(model.codec.encoder.step, params["encoder"],
                               ce, wav))
    books = torch.zeros((vq.num_quantizers, vq.codebook_size, vq.dim),
                        device=meta)
    z = torch.zeros((4, 1, vq.dim), device=meta)
    q = fa.totals(fa.analyze(rvq_kernel.quantize, z, books))
    dec = fa.totals(fa.analyze(model.codec.decoder.step, params["decoder"],
                               cd, z.transpose(1, 2)))
    assert w["enc_flops"] == enc["conv"] + enc["dot"]
    assert w["rvq_flops"] == q["conv"] + q["dot"]
    assert w["dec_flops"] == dec["conv"] + dec["dot"]


def test_train_step_count_equals_the_ports_counter(tmp_path):
    from hilcodec_tpu_torch.scripts import flops_analysis as fa
    cfg = _tiny_train_config()
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({k: cfg[k] for k in (
        "model", "model_kwargs", "disc_kwargs", "train", "data")}))
    data = dict(cfg["data"], segment_size=4800)
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "data": data}))
    rows = fa.train_step_rows(str(path), "f32", 2)
    t = fa.totals(rows)
    ref = train_ref.build(cfg, "cpu")
    assert train_ref.step_flops(ref, 2, 4800) == \
        pytest.approx(t["conv"] + t["dot"], rel=1e-12)
