"""The port's measurement and corpus tools (`hilcodec_tpu_torch/scripts/`)
against the JAX package's scripts (`scripts/`, imported from that
directory as `tests/test_roofline_cli.py` does), on the CPU at small
sizes: the analytic counter against `analyze_jaxpr`, the frame program's
convolution census against `collect_conv_signatures`, the roofline's and
the train-step bench's JSON contracts, the load generator against the
port's server, the synthetic corpus byte for byte, and the two depthwise
forms of the micro-bench."""

import asyncio
import collections
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import discriminators as jax_discs
from hilcodec_tpu.train.loop import build_trainer as jax_build_trainer
from hilcodec_tpu.utils.hparams import HParams as JaxHParams

import torch_port_common as C
from test_torch_train_loop import cut_down

from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.scripts import bench_dwconv, bench_train_step
from hilcodec_tpu_torch.scripts import flops_analysis as FA
from hilcodec_tpu_torch.scripts import make_synth_corpus
from hilcodec_tpu_torch.scripts import serve_load
from hilcodec_tpu_torch.scripts import streaming_roofline as SR
from hilcodec_tpu_torch.serve import CodecServer, SlotEngine
from hilcodec_tpu_torch.utils.hparams import HParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "scripts")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
import flops_analysis as jax_fa  # noqa: E402  (scripts/flops_analysis.py)
import make_synth_corpus as jax_corpus  # noqa: E402
import serve_load as jax_serve_load  # noqa: E402
import streaming_roofline as jax_roofline  # noqa: E402

CONV, DOT = "conv_general_dilated", "dot_general"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this module: the test runs share the host's
    cores between several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_totals(jaxpr):
    rows = []
    jax_fa.analyze_jaxpr(jaxpr, rows)
    return rows, {"conv": sum(r[1] for r in rows if r[0] == CONV),
                  "dot": sum(r[1] for r in rows if r[0] == DOT),
                  "n_conv": sum(1 for r in rows if r[0] == CONV)}


@pytest.fixture(scope="module")
def tiny():
    """The tiny codec of both packages with equal params and codebooks,
    and the port's model on meta tensors."""
    jm, tm = C.models()
    jp, tp = C.both_params(jm, tm)
    _, jv = jm.init(jax.random.PRNGKey(0))
    jv = dict(jv)
    jv["embed"] = jnp.asarray(C.codebooks())
    tv = {k: C.t(v) for k, v in jv.items()}
    return jm, jp, jv, CodecModel(tm.codec, tm.vq, FA.META), tp, tv


@pytest.mark.parametrize("fn", ["forward", "frame_step"])
def test_counter_equals_jax(tiny, fn):
    """(1) The convolution and product FLOPs, and the number of
    convolutions, of the tiny generator's forward and of one streaming
    frame step equal JAX's `analyze_jaxpr` on the same program."""
    jm, jp, jv, mm, tp, tv = tiny
    B, hop = 2, mm.hop_length
    if fn == "forward":
        wav = jnp.zeros((B, 1, 8 * hop), jnp.float32)
        jaxpr = jax.make_jaxpr(lambda p, w: jm.forward(
            p, jv, w, jax.random.PRNGKey(0), training=False))(jp, wav)
        rows = FA.analyze(mm.forward, FA.to_meta(tp), FA.to_meta(tv),
                          torch.zeros((B, 1, 8 * hop), device=FA.META),
                          None, training=False)
    else:
        fp = jm.fold_params(jp)
        ce, cd = jm.init_cache(B)
        jaxpr = jax.make_jaxpr(lambda w, a, b: jm.encode_decode_stream(
            fp, jv, w, a, b))(jnp.zeros((B, 1, hop), jnp.float32), ce, cd)
        tfp = FA.to_meta(mm.fold_params(tp))
        with torch.no_grad():
            rows = FA.analyze(mm.encode_decode_stream, tfp, FA.to_meta(tv),
                              torch.zeros((B, 1, hop), device=FA.META),
                              *mm.init_cache(B))
    _, ref = jax_totals(jaxpr.jaxpr)
    got = FA.totals(rows)
    assert ref["conv"] > 0 and ref["dot"] > 0
    assert (got["conv"], got["dot"], got["n_conv"]) == (
        ref["conv"], ref["dot"], ref["n_conv"])


def tiny_config() -> dict:
    return cut_down(os.path.join(ROOT, "data", "unused"))


def test_train_step_count_within_tenth_of_jax():
    """(1) The train step of the cut-down synth config at batch 2: the
    port's count is within 10% of JAX's, and the gap is these instances:
      * products: JAX's quantizer runs all n_q stages under dropout masks,
        the port the draw's n, so JAX counts (n_q - n) stages more (the
        distance and EMA products, 2 * 2MKC a stage);
      * convolutions: the port's gradients of a padded convolution are
        counted at the padded input, and of a transposed one at its whole
        output (the port pads, and cuts the transposed convolution's
        window, outside the convolution; JAX inside it), and JAX counts
        one convolution more: its feature-
        matching pullback of the fake branch runs the last layer's input
        gradient on a zero cotangent (JAX's vjp of (g, fm) is one
        function; autograd skips a gradient nothing reaches)."""
    cfg = tiny_config()
    jtr = jax_build_trainer(JaxHParams(**cfg))
    jax_discs.set_fbd_lowering("conv2d")
    st = jax.eval_shape(jtr.init_state, jax.random.PRNGKey(0))
    wav = jax.ShapeDtypeStruct((2, 1, cfg["data"]["segment_size"]),
                               jnp.float32)
    jrows, ref = jax_totals(jax.make_jaxpr(jtr.train_step)(
        st, wav, jax.random.PRNGKey(1)).jaxpr)

    from hilcodec_tpu_torch.train.loop import build_trainer
    tr = build_trainer(HParams(**cfg), FA.META)
    state = tr.init_state(torch.Generator().manual_seed(0))
    w = torch.zeros(tuple(wav.shape), device=FA.META)
    draws = tr.sample_draws(torch.Generator().manual_seed(1), w.shape)
    rows = FA.analyze(tr.train_step, state, w, draws)
    got = FA.totals(rows)

    total, ref_total = got["conv"] + got["dot"], ref["conv"] + ref["dot"]
    assert abs(total - ref_total) <= 0.10 * ref_total, (total, ref_total)
    vq = tr.model.vq
    M = 2 * cfg["data"]["segment_size"] // tr.model.hop_length
    stage = 2 * 2 * M * vq.codebook_size * vq.dim
    assert draws.n < vq.num_quantizers
    assert ref["dot"] - got["dot"] == (vq.num_quantizers - draws.n) * stage

    jc = collections.Counter(r[1] for r in jrows if r[0] == CONV)
    pc = collections.Counter(r.flops for r in rows if r.prim == FA.CONV)
    jax_only, port_only = jc - pc, pc - jc
    bwd = collections.Counter(r.flops for r in rows if r.prim == FA.CONV
                              and r.desc.startswith("backward"))
    assert port_only and all(bwd[v] >= c for v, c in port_only.items())
    assert sum(jax_only.values()) == sum(port_only.values()) + 1
    assert ref["n_conv"] == got["n_conv"] + 1
    assert abs(got["conv"] - ref["conv"]) < 0.01 * ref["conv"]


def _jax_frame_census(streams):
    """JAX's single-frame program of `scripts/streaming_roofline.py`'s
    build (plain drivers, f32) traced on abstract params, so no JAX init
    runs: {signature: count} from its `collect_conv_signatures` and
    `analyze_jaxpr`'s totals."""
    from bench import build_bench_model
    model = build_bench_model("hilcodec")
    params, vq = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    params = jax.eval_shape(model.fold_params, params)
    hop = model.hop_length
    ce, cd = jax.eval_shape(lambda: model.init_cache(streams))

    def enc_dec(p, v, wav, ce, cd):
        tokens, ce = model.encode_stream(p, v, wav, ce, megakernel=False,
                                         stream_chunks=1)
        out, cd = model.decode_stream(p, v, tokens, cd, megakernel=False,
                                      stream_chunks=1)
        return tokens, out, ce, cd

    jaxpr = jax.make_jaxpr(enc_dec)(
        params, vq, jax.ShapeDtypeStruct((streams, 1, hop), jnp.float32),
        ce, cd).jaxpr
    sigs = {}
    jax_roofline.collect_conv_signatures(jaxpr, sigs)
    return sigs, jax_totals(jaxpr)[1]


def test_frame_census_matches_jax():
    """(2) The full-width bench model's frame step at 4 streams: 107
    convolution instances over the same signatures as JAX's census, and
    the same convolution FLOPs. The one product the port computes another
    way is the transposed convolution: JAX's is a convolution of the
    lhs-dilated input with the flipped, transposed weight, the port's
    `conv_transpose1d` of the torch-layout weight, cut to the window its
    caller keeps (the count takes the window)."""
    streams = 4
    jsigs, ref = _jax_frame_census(streams)
    prog = SR.build(streams, 0.0134, "f32", False, FA.META)
    assert prog.n_frames == 1
    rows = SR.frame_rows(prog)
    psigs = FA.conv_signatures(rows)
    assert sum(jsigs.values()) == 107
    assert sum(c for c, _ in psigs.values()) == 107

    def jax_key(sig):
        lhs, _, rhs, _, ws, pad, ldil, rdil, _, g = sig
        if ldil != (1,):            # transposed: [Cout, Cin/g, k], flipped
            return ("T", lhs, (rhs[1] * g, rhs[0] // g, rhs[2]), ldil,
                    rdil, g)
        length = lhs[2] + sum(pad[0])
        return ("C", (lhs[0], lhs[1], length), rhs, ws, rdil, g)

    def port_key(sig):
        xs, _, ws, _, stride, pad, dil, transposed, _, g = sig
        assert pad == (0,)          # the step's caches are its padding
        return ("T" if transposed else "C", xs, ws, stride, dil, g)

    jc, pc = collections.Counter(), collections.Counter()
    for s, c in jsigs.items():
        jc[jax_key(s)] += c
    for s, (c, _) in psigs.items():
        pc[port_key(s)] += c
    assert jc == pc
    assert sum(c for k, c in pc.items() if k[0] == "T") == 4
    for k in pc:
        assert k[1][0] == streams   # the stream dim reaches every conv
    assert FA.totals(rows)["conv"] == ref["conv"]
    assert FA.totals(rows)["n_conv"] == ref["n_conv"] == 107


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def test_roofline_analytic_contract(capsys):
    """(3) `--analytic-only --device cpu` prints one JSON line that holds
    JAX's assertions (tests/test_roofline_cli.py)."""
    SR.main(["8", "--seconds", "0.0134", "--analytic-only",
             "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1
    row = lines[0]
    assert row["n_frames"] == 1
    assert row["mxu_flops_per_frame"] > 1e9
    assert 0 < row["hbm_floor_us"] < row["frame_budget_us"]
    assert 0 < row["mxu_floor_us"] < row["frame_budget_us"]
    assert row["elem_flops_per_frame"] < 0.1 * row["mxu_flops_per_frame"]


def test_bench_train_step_contract(tmp_path, capsys):
    """(4) The train-step bench on the tiny config, on the CPU: JAX's JSON
    line (no peak-dependent fields: the CPU has no peak), and one
    --breakdown rep of JAX's seven parts, none under its floor."""
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(tiny_config()))
    line, parts = bench_train_step.run(
        ["f32", "2", "--breakdown", f"--config={path}", "--device", "cpu"],
        reps=1)
    assert _json_lines(capsys.readouterr().out) == [line, parts]
    assert set(line) == {
        "config", "dtype", "batch", "dw", "fbd", "fam", "ms_per_step",
        "audio_s_per_s", "finite", "freq", "flops_per_step_g",
        "achieved_tflops", "hbm_gb_per_step", "hbm_gb_per_s"}
    assert line["finite"] == 1.0 and line["flops_per_step_g"] > 0
    assert set(parts) == {"gen_fwd", "gen_fwd_bwd", "disc_fwd_1x",
                          "mel_fwd_pullback", "fam_pullbacks", "d_loss_bwd",
                          "compute_grads", "full_step_ms"}
    for name, p in parts.items():
        if name != "full_step_ms":
            assert p["ms"] > 0 and not p["impossible"], (name, p)


def test_serve_load_against_port_server(capsys):
    """(5) The port's load generator and the JAX script's, 2 clients x 5
    frames unpaced, against the port's CodecServer on the CPU: the same
    keys, every frame answered."""
    model, params, vq_state = C.models()[1], *_tiny_weights()
    eng = SlotEngine(model, params, vq_state, slots=4, mode="roundtrip",
                     devices=["cpu"])
    argv = ["--port", "0", "--clients", "2", "--frames", "5", "--rate",
            "0", "--hop", str(model.hop_length)]

    async def go():
        srv = CodecServer(eng, sr=24000, port=0)
        await srv.start()
        try:
            argv[1] = str(srv.port)
            ours = await asyncio.wait_for(
                serve_load.run(serve_load.parse_args(argv)), 120)
            ns = jax_serve_load.argparse.Namespace(
                **vars(serve_load.parse_args(argv)))
            await asyncio.wait_for(jax_serve_load.run(ns), 120)
            return ours
        finally:
            await srv.stop()

    ours = asyncio.run(go())
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 2 and lines[0] == ours
    assert set(lines[0]) == set(lines[1])
    assert ours["metric"] == "serving_latency_ms"
    assert ours["clients"] == 2 and ours["frames_per_client"] == 5
    assert 0 < ours["p50_ms"] <= ours["max_ms"]
    assert eng.stats["frames"] == 20


def _tiny_weights():
    jm, tm = C.models()
    _, tp = C.both_params(jm, tm)
    return tp, {k: C.t(v) for k, v in dict(
        jm.init(jax.random.PRNGKey(0))[1],
        embed=C.codebooks()).items()}


def test_synth_corpus_bytes_match_jax(tmp_path, monkeypatch, capsys):
    """(6) The same files, filelists and bytes as JAX's script for the same
    arguments (its seed is fixed)."""
    ref, ours = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["make_synth_corpus.py", str(ref),
                                      "2", "2"])
    jax_corpus.main()
    make_synth_corpus.main([str(ours), "2", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(ref), "") == out[1].replace(str(ours), "")

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    names = files(ref)
    assert names == files(ours)
    assert len(names) == 2 + 1 + 1 + 2 + 4 + 5
    for n in names:
        assert (ref / n).read_bytes() == (ours / n).read_bytes(), n


def test_dwconv_forms_agree():
    """(7) The micro-bench's two depthwise forms, a strided and a plain
    shape: equal outputs and gradients."""
    rng = np.random.default_rng(0)
    for C_, T, k, s, d in ((8, 96, 5, 1, 1), (6, 64, 16, 8, 1)):
        x = torch.from_numpy(rng.standard_normal((3, C_, T))
                             .astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((C_, 1, k))
                             .astype(np.float32))
        y = bench_dwconv.conv_dw(x, w, s, d)
        assert y.shape == (3, C_, T // s)
        torch.testing.assert_close(bench_dwconv.shift_dw(x, w, s, d), y,
                                   rtol=1e-5, atol=1e-5)
        for g, h in zip(bench_dwconv.grad_sum(bench_dwconv.conv_dw, x, w,
                                              s, d),
                        bench_dwconv.grad_sum(bench_dwconv.shift_dw, x, w,
                                              s, d)):
            torch.testing.assert_close(g, h, rtol=1e-5, atol=1e-4)
