"""The Mimi cell on the CPU at tiny widths: a sound run reads correct and
covers the rings after they wrap; the control (the port's bf16 path) and
the faults (the LayerScale branch dropped, the ring position not
advanced, a token altered) read not correct. Also the reference copy
against the port's own, and the work counts."""

import copy
import time

import pytest
import torch

from benchmark import common, harness
from benchmark.reference import mimi_ref

CELL = "mimi_24k.bulk1024"
TINY = dict(n_filters=4, ratios=[4, 2], dimension=16,
            transformer=dict(d_model=16, num_heads=2, num_layers=2,
                             dim_feedforward=32, context=5,
                             max_period=10000.0, layer_scale=0.01,
                             norm_eps=1e-5),
            vq_kwargs=dict(input_dim=16, dim=8, codebook_size=32,
                           num_quantizers=4, n_semantic=1))
# 6 chunks of 3 frames: 36 positions a transformer, past its context of 5
TRAFFIC = {"streams": 4, "chunk_frames": 3, "pool_chunks": 3,
           "profile_chunks": 1}


def tiny_cell(seed=2 ** 33 + 19, precision="f32", trace=False):
    bench = common.benchmark_json()
    c = common.load_cell(bench, CELL, seed, 0.4, trace, torch.device("cpu"),
                         precision)
    c.traffic.update(TRAFFIC)
    c.config = copy.deepcopy(c.config)
    c.config["model_kwargs"].update(copy.deepcopy(TINY))
    c.config["codebook_init"] = {"rows": 2, "seconds": 0.2, "jitter": 0.25}
    return c


def run(c):
    return harness.run_cell(c, common.benchmark_json(), time.perf_counter())


def test_a_sound_run_is_correct_past_the_wrap():
    c = tiny_cell()
    res, lines = run(c)
    assert res["correct"], lines
    ctx = c.config["model_kwargs"]["transformer"]["context"]
    # positions a transformer saw in the window (2 a frame step)
    assert res["attempted"] // c.traffic["streams"] * 2 > 2 * ctx
    assert set(res["checks"]) == {"token_gap", "pcm_err_steps"}


def test_the_control_is_not_correct():
    res, lines = run(tiny_cell(precision="bf16"))
    assert not res["correct"], lines


def test_the_layerscale_branch_dropped(monkeypatch):
    from hilcodec_tpu_torch.models import transformer as T
    real = T.StreamingTransformer._rest

    def dropped(self, p, x, attn):
        return real(self, p, x, torch.zeros_like(attn))
    monkeypatch.setattr(T.StreamingTransformer, "_rest", dropped)
    res, lines = run(tiny_cell())
    assert not res["correct"], lines


def test_the_ring_position_not_advanced(monkeypatch):
    from hilcodec_tpu_torch.models import transformer as T
    real = T.StreamingTransformer.step

    def stuck(self, params, cache, x):
        y, new = real(self, params, cache, x)
        return y, [cache[0]] + new[1:]
    monkeypatch.setattr(T.StreamingTransformer, "step", stuck)
    res, lines = run(tiny_cell())
    assert not res["correct"], lines


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from hilcodec_tpu_torch.models import mimi
    quantize = mimi.rvq_kernel.quantize

    def altered(x, books, n=None):
        idx = quantize(x, books, n).clone()
        idx[-1, 0, 0] = (idx[-1, 0, 0] + 1) % books.shape[1]
        return idx
    monkeypatch.setattr(mimi.rvq_kernel, "quantize", altered)
    res, lines = run(tiny_cell())
    assert not res["correct"], lines


def test_the_reference_copy_is_the_ports():
    from hilcodec_tpu_torch.reference import mimi_ref as port_ref
    c = tiny_cell()
    cfg = c.config["model_kwargs"]
    params, state = mimi_ref.make_weights(c.config, 5, "cpu")
    wav = common.speech_band(torch.Generator().manual_seed(3), 2, 16 * 6,
                             torch.device("cpu"))
    a = mimi_ref.encode(params, state, cfg, wav)
    b = port_ref.encode(params, state, cfg, wav)
    assert torch.equal(a, b)
    assert torch.equal(mimi_ref.decode(params, state, cfg, a),
                       port_ref.decode(params, state, cfg, b))


def test_the_work_counts():
    cfg = common.read_json(f"{common.HERE}/configs/mimi_24k.json")
    mk = cfg["model_kwargs"]
    flops, nbytes = mimi_ref.attention_call_work(mk, 1024)
    # K and V of 250 slots x 512 f32 a stream dominate: ~1.05 GB a call
    assert nbytes == pytest.approx(1024 * 4 * (2 * 250 * 512 + 4 * 2 * 512))
    assert flops == pytest.approx(1024 * 4 * 2 * 252 * 512)
    # ~2.7 GFLOP a second of audio for the two transformers
    t = 2 * mimi_ref.transformer_step_flops(mk, 1) * 12.5
    assert 2.3e9 < t < 3.0e9
    # ~11 GFLOP in all: the SEANet halves ~4 each, the decoder's
    # transposed convolutions at their multiply-adds (~2.6 of its ~4)
    total = mimi_ref.frame_step_flops(mk, 1) * 12.5
    assert 10e9 < total < 12e9


@pytest.mark.card
def test_the_cell_runs_on_the_card(card):
    import json
    import subprocess
    bench = common.benchmark_json()
    cmd = bench["command"] + ["--workload", CELL, "--seed",
                              str(2 ** 31 + 23), "--seconds", "3",
                              "--trace", "1"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert {"mimi.attn_roofline", "mimi.transformer_ms_per_frame.stream"} \
        <= set(res["metrics"])
