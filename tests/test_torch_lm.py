"""The port's token LM and the tools around it against the JAX package's,
on the CPU.

Both LMs get the same parameters (JAX's init, through the port's bridge)
and the same seeded tokens. Covered: `sin_embedding`; the LM's
probabilities, batched and stepped frame by frame through its states,
within PROB_ATOL of JAX's; causal bitwise independence (what lets the
offline decoder re-apply on its prefix); the live encoder -> decoder
roundtrip and the live stepper against the batched LM; the LM inputs, one
`lm_train_step` against JAX's (loss <= LOSS_RTOL relative, every param
<= PARAM_RTOL relative L2); LM checkpoints crossing both ways; and the
`train_lm` and `entropy_code` CLIs in-process with `--device cpu` on a
tiny codec checkpoint.
"""

import json
import math
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import encodec as JE
from hilcodec_tpu.train import lm as JL
from hilcodec_tpu.train.optim import make_optimizer as jax_make_optimizer
from hilcodec_tpu.utils import checkpoint as JC
from hilcodec_tpu.utils.checkpoint import _flatten
from hilcodec_tpu.utils.hparams import HParams as JaxHParams
from hilcodec_tpu.utils.pytree import leaf_paths

from hilcodec_tpu_torch import entropy_code, train_lm
from hilcodec_tpu_torch.models import encodec as TE
from hilcodec_tpu_torch.serve.entropy_live import (LiveTokenDecoder,
                                                   LiveTokenEncoder,
                                                   lm_stepper)
from hilcodec_tpu_torch.train import lm as TL
from hilcodec_tpu_torch.train.optim import make_optimizer
from hilcodec_tpu_torch.utils import checkpoint as TC
from hilcodec_tpu_torch.utils import params as P
from hilcodec_tpu_torch.utils.bitstream import read_hilstream, token_crc32
from hilcodec_tpu_torch.utils.wavio import read_wav, write_wav

from test_torch_train_loop import ROOT, cut_down
from torch_port_common import jax_tree, n, write_jax_checkpoint

PROB_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
KEY_BIAS_MOVE = 1e-4       # a tenth of the train-step test's lr
ARCH = dict(n_q=3, card=32, dim=16, num_heads=4, num_layers=2,
            past_context=8)


@pytest.fixture(scope="module")
def lms():
    """(jax LM, jax params, port LM, port params), equal leaf for leaf;
    the layer norms' gains and biases made nontrivial."""
    jlm, tlm = JE.LMModel(**ARCH), TE.LMModel(**ARCH)
    template = jlm.init(jax.random.PRNGKey(0))
    flat = _flatten(template)
    rng = np.random.default_rng(5)
    for k in flat:
        if "norm" in k or k.endswith("_b"):
            flat[k] = (flat[k] + rng.uniform(-0.3, 0.3, flat[k].shape)
                       ).astype(np.float32)
    tp = P.from_flat(flat, tlm.init(torch.Generator().manual_seed(0)))
    return jlm, jax_tree(template, flat), tlm, tp


def _indices(rng, B=2, T=12):
    return rng.integers(0, ARCH["card"] + 1, (B, ARCH["n_q"], T))


def test_sin_embedding_matches_jax():
    pos = np.arange(40)[None, :] + 7
    np.testing.assert_allclose(
        n(TE.sin_embedding(torch.from_numpy(pos), 16)),
        np.asarray(JE.sin_embedding(jnp.asarray(pos), 16)), rtol=0,
        atol=1e-5)


def test_batched_probabilities_match_jax(lms, rng):
    jlm, jp, tlm, tp = lms
    idx = _indices(rng)
    ours, st, off = tlm.apply(tp, torch.from_numpy(idx))
    theirs, jst, joff = jax.jit(lambda x: jlm.apply(jp, x))(
        jnp.asarray(idx))
    assert tuple(ours.shape) == (2, 32, 3, 12) and off == int(joff) == 12
    np.testing.assert_allclose(n(ours), np.asarray(theirs), rtol=0,
                               atol=PROB_ATOL)
    np.testing.assert_allclose(n(ours).sum(1), 1.0, atol=1e-5)
    for a, b in zip(st, jst):
        assert tuple(a.shape) == b.shape == (2, 8, 16)
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=1e-5)


def test_stepped_probabilities_match_jax(lms, rng):
    """One frame a call through the states, past the past_context of 8
    frames: each step's probabilities against JAX's stepped LM and
    against the batched LM's at that position."""
    jlm, jp, tlm, tp = lms
    idx = _indices(rng, B=1, T=12)
    batched = n(tlm.apply(tp, torch.from_numpy(idx))[0])
    first = jax.jit(lambda x: jlm.apply(jp, x))
    nxt = jax.jit(lambda x, st, off: jlm.apply(jp, x, st, off))
    st = jst = None
    off = joff = 0
    for i in range(12):
        x = idx[:, :, i:i + 1]
        ours, st, off = tlm.apply(tp, torch.from_numpy(x), st, off)
        theirs, jst, joff = (first(jnp.asarray(x)) if jst is None else
                             nxt(jnp.asarray(x), jst, jnp.asarray(joff)))
        np.testing.assert_allclose(n(ours)[..., 0],
                                   np.asarray(theirs)[..., 0], rtol=0,
                                   atol=PROB_ATOL)
        np.testing.assert_allclose(n(ours)[..., 0], batched[..., i],
                                   rtol=0, atol=PROB_ATOL)


def test_lm_causal_bitwise_independence(lms, rng):
    """Position t's probabilities are bitwise independent of positions
    > t: the offline decoder sees 0s past t and must get the encoder's
    cdfs."""
    _, _, tlm, tp = lms
    full = _indices(rng, B=1, T=6)
    a_all = n(tlm.apply(tp, torch.from_numpy(full))[0])
    for i in range(6):
        trunc = full.copy()
        trunc[:, :, i + 1:] = 0
        b = n(tlm.apply(tp, torch.from_numpy(trunc))[0])
        np.testing.assert_array_equal(a_all[..., i], b[..., i])


def test_live_roundtrip_exact_and_stepper_matches_batched(lms, rng):
    """The live encoder's settled bytes fed to the live decoder as they
    come give back every frame over two LM segments; the live stepper's
    probabilities equal the batched LM's teacher-forced ones within
    PROB_ATOL."""
    _, _, tlm, tp = lms
    frames = rng.integers(0, ARCH["card"], (14, ARCH["n_q"]))
    enc = LiveTokenEncoder(tlm, tp, seg_tokens=8)
    dec = LiveTokenDecoder(tlm, tp, seg_tokens=8)
    got = []
    for f in frames:
        settled = enc.push(f)
        if settled:
            dec.feed(settled)
            got.extend(dec.pull())
    dec.feed(enc.finish(), finished=True)
    got.extend(dec.pull_n(len(frames) - len(got)))
    np.testing.assert_array_equal(np.stack(got), frames)
    run = lm_stepper(tlm, tp)
    inputs = TL.lm_inputs_from_tokens(
        torch.from_numpy(frames[:8].T[:, None]))
    batched = n(tlm.apply(tp, inputs)[0])[0]            # [card, n_q, 8]
    st, off, prev = None, 0, None
    for i in range(8):
        probs, st, off = run(prev, st, off)
        np.testing.assert_allclose(probs, batched[..., i], rtol=0,
                                   atol=PROB_ATOL)
        prev = frames[i]


def test_lm_inputs_and_cross_entropy_match_jax(lms, rng):
    jlm, jp, tlm, tp = lms
    toks = rng.integers(0, 32, (3, 2, 10)).astype(np.int32)
    np.testing.assert_array_equal(
        n(TL.lm_inputs_from_tokens(torch.from_numpy(toks))),
        np.asarray(JL.lm_inputs_from_tokens(jnp.asarray(toks))))
    ours = float(TL.lm_cross_entropy(tlm, tp, torch.from_numpy(toks)))
    theirs = float(jax.jit(lambda tk: JL.lm_cross_entropy(jlm, jp, tk))(
        jnp.asarray(toks)))
    assert abs(ours - theirs) <= LOSS_RTOL * abs(theirs)


def test_lm_train_step_matches_jax(lms, rng):
    """One Adam step (betas 0.9 / 0.98, as train_lm) from the same params
    on the same tokens: the loss and every updated param.

    One slice is held to another bar: the key projection's bias. Adding
    a constant to every key shifts a query's scores by a constant, which
    the softmax cancels, so its gradient is zero up to rounding, and Adam
    scales that noise up (by up to lr / eps). There both sides must move
    by less than KEY_BIAS_MOVE, a tenth of the step's learning rate."""
    jlm, jp, tlm, tp = lms
    p0 = P.to_flat(tp)
    jopt, _ = jax_make_optimizer("Adam", {"lr": 3e-4, "betas": [0.9, 0.98]})
    topt, _ = make_optimizer("Adam", {"lr": 3e-4, "betas": [0.9, 0.98]})
    jst, tst = jopt.init(jp), topt.init(tp)
    toks = rng.integers(0, 32, (3, 2, 10)).astype(np.int32)
    jstep = jax.jit(lambda p, st, tk, lr: JL.lm_train_step(jlm, jopt, p, st,
                                                           tk, lr))
    jp, jst, jloss = jstep(jp, jst, jnp.asarray(toks),
                           jnp.asarray(1e-3, jnp.float32))
    tp, tst, tloss = TL.lm_train_step(tlm, topt, tp, tst,
                                      torch.from_numpy(toks),
                                      torch.tensor(1e-3))
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * float(jloss)
    assert int(tst.step) == int(jst.step) == 1
    ours, theirs = P.to_flat(tp), _flatten(jp)
    assert set(ours) == set(theirs)
    C = ARCH["dim"]
    for k, v in theirs.items():
        a = ours[k]
        if k.endswith("in_proj_b"):
            for side in (a, v):
                assert np.abs(side[C:2 * C] - p0[k][C:2 * C]).max() \
                    < KEY_BIAS_MOVE, k
            a, v = np.delete(a, np.s_[C:2 * C]), np.delete(v, np.s_[C:2 * C])
        err = np.linalg.norm(a - v) / max(np.linalg.norm(v), 1e-12)
        assert err <= PARAM_RTOL, (k, err)


def test_lm_checkpoints_cross_both_ways(lms, tmp_path, rng):
    jlm, jp, tlm, tp = lms
    idx = _indices(rng)
    ref = n(tlm.apply(tp, torch.from_numpy(idx))[0])
    # JAX writes, the port reads
    path = JC.save_checkpoint(str(tmp_path / "jax"), 3, jp)
    got, _ = TC.load_checkpoint(path, tlm.init(torch.Generator()))
    np.testing.assert_array_equal(
        n(tlm.apply(got, torch.from_numpy(idx))[0]), ref)
    # the port writes, JAX reads
    path = TC.save_checkpoint(str(tmp_path / "port"), 3, tp)
    back, _ = JC.load_checkpoint(path, jlm.init(jax.random.PRNGKey(9)))
    for a, b in zip(leaf_paths(back), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), P.to_flat(tp)[a])


# --------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def codec(tmp_path_factory):
    """A tiny flagship config (hop 8, RVQ 3 x 32) with a JAX checkpoint,
    a corpus of train/ and eval/ wavs and one input wav."""
    tmp = tmp_path_factory.mktemp("lm_cli")
    cfg = cut_down(str(tmp))
    cfg_path = tmp / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    ckpt = str(tmp / "00001.ckpt.npz")
    write_jax_checkpoint(JaxHParams(**cfg), ckpt)
    rng = np.random.default_rng(3)
    for split, count in (("train", 3), ("eval", 2)):
        os.makedirs(tmp / "corpus" / split)
        for i in range(count):
            write_wav(str(tmp / "corpus" / split / f"{i}.wav"),
                      rng.standard_normal(1024) * 0.2, 24000)
    write_wav(str(tmp / "in.wav"), rng.standard_normal(2048) * 0.2, 24000)
    return tmp, str(cfg_path), ckpt


def test_train_lm_cli(codec, capsys):
    tmp, cfg, ckpt = codec
    out_dir = str(tmp / "lm")
    train_lm.main(["-c", cfg, "--ckpt", ckpt, "--data",
                   str(tmp / "corpus"), "--steps", "6", "--batch", "2",
                   "--seg-tokens", "16", "--dim", "16", "--heads", "4",
                   "--layers", "1", "--out", out_dir, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "train segments: (45, 3, 16), eval: (16, 3, 16)" in out
    final = [ln for ln in out.splitlines() if ln.startswith("FINAL:")][0]
    assert "raw 5.0" in final and "n_q=3" in final
    bits = float(final.split("held-out ")[1].split(" bits")[0])
    assert np.isfinite(bits) and 0.0 < bits < 16.0
    # the LM checkpoint loads in JAX
    path = os.path.join(out_dir, "00006.ckpt.npz")
    jlm = JE.LMModel(n_q=3, card=32, dim=16, num_heads=4, num_layers=1,
                     past_context=16)
    JC.load_checkpoint(path, jlm.init(jax.random.PRNGKey(0)))


def test_entropy_code_cli_roundtrip(codec, capsys):
    """Encode with the batched time-major coder (16 segments), check the
    container, then decode it in a separate invocation: the tokens' CRC
    holds and the wav has n_seg * S * hop samples."""
    tmp, cfg, ckpt = codec
    lm = TE.LMModel(n_q=3, card=32, dim=16, num_heads=4, num_layers=1,
                    past_context=16)
    lm_ckpt = TC.save_checkpoint(str(tmp / "lm_enc"), 1,
                                 lm.init(torch.Generator().manual_seed(1)))
    stream = str(tmp / "out.hilstream")
    base = ["-c", cfg, "--ckpt", ckpt, "--lm", lm_ckpt, "--device", "cpu"]
    entropy_code.main(base + ["-i", str(tmp / "in.wav"), "--seg-tokens",
                              "16", "--dim", "16", "--heads", "4",
                              "--layers", "1", "--out", stream])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["roundtrip_exact"] is True
    assert out["tokens"] == 16 * 3 * 16 and out["raw_bits_per_token"] == 5.0
    assert 0.0 < out["bits_per_token"] < 8.0
    meta, payload = read_hilstream(stream)
    assert (meta["n_q"], meta["card"], meta["seg_tokens"],
            meta["n_seg"]) == (3, 32, 16, 16)
    assert len(payload) == out["stream_bytes"]
    out_wav = str(tmp / "decoded.wav")
    entropy_code.main(base + ["--decode", stream, "--out-wav", out_wav])
    dec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert dec["tokens"] == out["tokens"]
    wav, sr = read_wav(out_wav)
    assert sr == 24000 and len(wav) == 2048
    assert math.isfinite(float(np.abs(wav).max()))


# ------------------------------------------- the CLIs beside the root ones

LM_CLI = ["--seg-tokens", "16", "--dim", "16", "--heads", "4", "--layers",
          "1"]
BITS_ATOL = 1e-3           # bits a token as printed, to 3 decimals
BITS_PER_TOKEN_RTOL = 1e-2


def _jax_script(script):
    """The root script's globals, its `main` not yet run."""
    return runpy.run_path(os.path.join(ROOT, "scripts", script))


def _run_jax_main(g, script, argv):
    old = sys.argv
    try:
        sys.argv = [script] + argv
        g["main"]()
    finally:
        sys.argv = old


def _held_out(out):
    """{step: held-out bits} of a train_lm log; the final one as -1."""
    got = {int(s): float(b) for s, b in re.findall(
        r"^step (\d+): .*held-out ([\d.]+)", out, re.M)}
    got[-1] = float(re.search(r"^FINAL: held-out ([\d.]+)", out,
                              re.M).group(1))
    return got


def test_train_lm_cli_matches_script(codec, capsys, monkeypatch):
    """`train_lm` beside `scripts/train_lm.py` on one codec checkpoint and
    corpus, the LM starting from JAX's init in both: the tokenized train
    (half-segment overlap) and eval arrays exactly, the learning rate of
    every step (warm-up and cosine) exactly, the held-out bits at step 0,
    at the last step and at the end within BITS_ATOL (the eval averaging),
    and the trained LM's params within PARAM_RTOL relative L2 (the batch
    draws, the schedule and the steps; the key bias, whose gradient is
    rounding noise, moves less than KEY_BIAS_MOVE on both sides)."""
    tmp, cfg, ckpt = codec
    steps = 20                            # warm-up of 2 steps, then cosine
    argv = ["-c", cfg, "--ckpt", ckpt, "--data", str(tmp / "corpus"),
            "--steps", str(steps), "--batch", "2"] + LM_CLI
    arch = dict(n_q=3, card=32, dim=16, num_heads=4, num_layers=1,
                past_context=16)
    init = _flatten(JE.LMModel(**arch).init(jax.random.PRNGKey(0)))
    port_init = TE.LMModel.init
    monkeypatch.setattr(TE.LMModel, "init", lambda self, gen, device="cpu":
                        P.from_flat(init, port_init(self, gen), device))

    tokens, lrs = {"jax": [], "port": []}, {"jax": [], "port": []}
    g = _jax_script("train_lm.py")
    jax_tokenize = g["tokenize_dir"]
    g["tokenize_dir"] = lambda *a, **k: tokens["jax"].append(
        jax_tokenize(*a, **k)) or tokens["jax"][-1]
    # the script's jitted train step is its one function of four
    # arguments, (params, opt_state, tokens, lr)
    jit = jax.jit

    def recording_jit(fn, *a, **k):
        jitted = jit(fn, *a, **k)

        def call(*args):
            if len(args) == 4:
                lrs["jax"].append(np.float32(args[3]))
            return jitted(*args)
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    _run_jax_main(g, "train_lm.py", argv + ["--out", str(tmp / "lm_jax")])
    monkeypatch.setattr(jax, "jit", jit)
    theirs = capsys.readouterr().out

    port_tokenize, port_lr = train_lm.tokenize_dir, train_lm.lr_at
    monkeypatch.setattr(train_lm, "tokenize_dir", lambda *a, **k: tokens[
        "port"].append(port_tokenize(*a, **k)) or tokens["port"][-1])
    monkeypatch.setattr(train_lm, "lr_at", lambda *a: lrs["port"].append(
        np.float32(port_lr(*a))) or port_lr(*a))
    train_lm.main(argv + ["--out", str(tmp / "lm_port"), "--device", "cpu"])
    ours = capsys.readouterr().out

    assert [t.shape for t in tokens["port"]] == [(45, 3, 16), (16, 3, 16)]
    for a, b in zip(tokens["port"], tokens["jax"]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert len(lrs["port"]) == steps and lrs["port"] == lrs["jax"]
    assert lrs["port"][0] < lrs["port"][1] == 3e-4 > lrs["port"][-1]
    bits_ours, bits_theirs = _held_out(ours), _held_out(theirs)
    assert set(bits_ours) == set(bits_theirs) == {0, steps, -1}
    for k, v in bits_theirs.items():
        assert abs(bits_ours[k] - v) <= BITS_ATOL, (k, bits_ours[k], v)
    ours_p = P.to_flat(TC.load_checkpoint(
        str(tmp / "lm_port" / f"{steps:05d}.ckpt.npz"),
        P.from_flat(init, port_init(TE.LMModel(**arch),
                                    torch.Generator())))[0])
    with np.load(tmp / "lm_jax" / f"{steps:05d}.ckpt.npz") as z:
        theirs_p = {k: z[k] for k in z.files}
    C = arch["dim"]
    for k, v in init.items():
        a, b = ours_p[k], theirs_p[k]
        if k.endswith("in_proj_b"):   # the key bias: see the step test
            for side in (a, b):
                assert np.abs(side[C:2 * C] - v[C:2 * C]).max() \
                    < KEY_BIAS_MOVE, k
            a, b = np.delete(a, np.s_[C:2 * C]), np.delete(b, np.s_[C:2 * C])
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        assert err <= PARAM_RTOL, (k, err)


def test_entropy_code_cli_matches_script(codec, capsys):
    """`entropy_code` beside `scripts/entropy_code.py` on one codec
    checkpoint, one JAX-written LM checkpoint and one wav: the same
    segments and container header (geometry, LM architecture and the
    tokens' CRC), the same JSON report but for bits a token, which agree
    within BITS_PER_TOKEN_RTOL (the two LMs' cdfs may round apart at a
    few symbols). Then the coding loops alone: the script's encoder and
    decoder, given the port's probability model, write the port's bytes
    exactly and read them back to the segments (the time-major symbol
    order and the batching)."""
    tmp, cfg, ckpt = codec
    jlm = JE.LMModel(n_q=3, card=32, dim=16, num_heads=4, num_layers=1,
                     past_context=16)
    lm_ckpt = JC.save_checkpoint(str(tmp / "lm_jax_init"), 1,
                                 jlm.init(jax.random.PRNGKey(1)))
    base = ["-c", cfg, "--ckpt", ckpt, "--lm", lm_ckpt, "-i",
            str(tmp / "in.wav")] + LM_CLI
    g = _jax_script("entropy_code.py")
    streams = {k: str(tmp / f"{k}.hilstream") for k in ("jax", "port")}
    _run_jax_main(g, "entropy_code.py", base + ["--out", streams["jax"]])
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    entropy_code.main(base + ["--out", streams["port"], "--device", "cpu"])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["roundtrip_exact"] is theirs["roundtrip_exact"] is True
    assert abs(ours["bits_per_token"] - theirs["bits_per_token"]) \
        <= BITS_PER_TOKEN_RTOL * theirs["bits_per_token"]
    for k in ("input_seconds", "n_q", "tokens", "raw_bits_per_token",
              "kbps_fixed_rate"):
        assert ours[k] == theirs[k], k
    (meta, payload), (jax_meta, _) = (read_hilstream(streams["port"]),
                                      read_hilstream(streams["jax"]))
    assert meta == jax_meta and meta["n_seg"] == 16

    lm, params = entropy_code.load_lm(lm_ckpt, 3, 32, 16, 4, 1, 16, "cpu")
    probs = entropy_code.batched_prob_fn(lm, params)
    segs = entropy_code.entropy_decode_segments(probs, payload, 16, 3, 16)
    assert token_crc32(segs) == meta["token_crc"]
    assert entropy_code.entropy_encode_segments(probs, segs) == payload

    def probs_of_jax_inputs(inputs, t):
        return probs(np.array(inputs), t)
    assert g["entropy_encode_segments"](probs_of_jax_inputs, segs) \
        == payload
    np.testing.assert_array_equal(g["entropy_decode_segments"](
        probs_of_jax_inputs, payload, 16, 3, 16), segs)
