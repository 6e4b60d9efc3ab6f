"""The port's deployment tools on a JAX checkpoint at a tiny width, on the
CPU: `python -m hilcodec_tpu_torch.export` against the root `export.py`
(deploy and cache npz files), the port's deploy npz in the JAX package,
`serve --ckpt` against `serve --params`, `clean_checkpoints` against
the JAX package's, and the port's `--program` export against its eager
streaming step."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from hilcodec_tpu.models.registry import build_codec_model as jax_build
from hilcodec_tpu.utils import checkpoint as jax_ckpt
from hilcodec_tpu.utils.hparams import HParams as JaxHParams
from hilcodec_tpu.utils.pytree import leaf_paths

from hilcodec_tpu_torch import export as port_export
from hilcodec_tpu_torch import clean_checkpoint as port_clean
from hilcodec_tpu_torch.serve.__main__ import serving_weights
from hilcodec_tpu_torch.utils import checkpoint as ckpt
from hilcodec_tpu_torch.utils import params as P
from hilcodec_tpu_torch.utils.hparams import HParams

from test_torch_train_loop import ROOT, cut_down
from torch_port_common import write_jax_checkpoint


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A tiny config and a JAX checkpoint, exported by both CLIs."""
    tmp = tmp_path_factory.mktemp("export")
    cfg = cut_down(str(tmp))
    cfg_path = tmp / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    path = str(tmp / "00001.ckpt.npz")
    write_jax_checkpoint(JaxHParams(**cfg), path)
    argv = ["-c", str(cfg_path), "--ckpt", path]
    old = sys.argv
    try:
        sys.argv = ["export.py"] + argv + ["-o", str(tmp / "jax" / "hil")]
        runpy.run_path(os.path.join(ROOT, "export.py"), run_name="__main__")
    finally:
        sys.argv = old
    port_export.main(argv + ["-o", str(tmp / "port" / "hil"),
                             "--device", "cpu"])
    return tmp, cfg, path


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_deploy_and_cache_npz_match_jax_export(exported):
    tmp, _, _ = exported
    ours = _load(tmp / "port" / "hil_deploy.npz")
    theirs = _load(tmp / "jax" / "hil_deploy.npz")
    assert set(ours) == set(theirs) and "codebooks" in ours
    for k, v in theirs.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
    for side in ("enc", "dec"):
        a = np.load(tmp / "port" / f"hil_cache_{side}.npz")
        b = np.load(tmp / "jax" / f"hil_cache_{side}.npz")
        assert list(a.files) == list(b.files)
        assert list(a.files) == [f"{side[0]}_in{i}"
                                 for i in range(len(a.files))]
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_port_deploy_npz_decodes_in_jax(exported):
    """The port's deploy npz, read into a JAX param tree by its leaf paths,
    decodes what the port decodes from it."""
    tmp, cfg, _ = exported
    hps = HParams(**cfg)
    model, params, vq = serving_weights(
        hps, params_path=str(tmp / "port" / "hil_deploy.npz"), device="cpu")
    flat = _load(tmp / "port" / "hil_deploy.npz")
    books = flat.pop("codebooks")
    jm = jax_build("hilcodec", JaxHParams(**cfg).model_kwargs.to_dict())
    template = jm.fold_params(jm.init(jax.random.PRNGKey(0))[0])
    jparams = jax.tree.unflatten(
        jax.tree.structure(template),
        [jnp.asarray(flat[p]) for p in leaf_paths(template)])
    tokens = np.random.default_rng(3).integers(
        0, books.shape[1], (books.shape[0], 2, 6)).astype(np.int32)
    want = np.asarray(jm.decode(jparams, {"embed": jnp.asarray(books)},
                                jnp.asarray(tokens)))
    got = model.decode(params, vq, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_serve_ckpt_and_params_give_the_same_folded_tree(exported):
    tmp, cfg, path = exported
    hps = HParams(**cfg)
    _, p_ckpt, vq_ckpt = serving_weights(hps, ckpt_path=path, device="cpu")
    _, p_npz, vq_npz = serving_weights(
        hps, params_path=str(tmp / "port" / "hil_deploy.npz"), device="cpu")
    a, b = P.flatten(p_ckpt), P.flatten(p_npz)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(vq_ckpt["embed"], vq_npz["embed"])


def test_serve_refuses_params_with_ckpt(exported, capsys):
    from hilcodec_tpu_torch.serve.__main__ import main
    _, _, path = exported
    with pytest.raises(SystemExit):
        main(["-c", "x.yaml", "--params", "a.npz", "--ckpt", path])
    assert "not allowed with" in capsys.readouterr().err


def test_export_without_ckpt_and_stablehlo(tmp_path, capsys):
    cfg = cut_down(str(tmp_path))
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    port_export.main(["-c", str(cfg_path), "-o", str(tmp_path / "s"),
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"wrote {tmp_path / 's'}_deploy.npz (")
    assert "cache_enc (" in out and "cache_dec (" in out
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        port_export.main(["-c", str(cfg_path), "--stablehlo",
                          "--device", "cpu"])


def _ckpt_tree(root):
    for run, epochs in (("a", (1, 2, 10)), ("b/c", (3,)), ("d", (5, 7))):
        os.makedirs(root / run, exist_ok=True)
        for e in epochs:
            (root / run / f"{e:05d}.ckpt.npz").write_bytes(b"x" * e)
    (root / "a" / "notes.txt").write_text("kept")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_clean_checkpoints_removes_what_jax_removes(tmp_path, capsys):
    for side in ("port", "jax", "dry"):
        _ckpt_tree(tmp_path / side)
    ours = ckpt.clean_checkpoints(str(tmp_path / "port"))
    theirs = jax_ckpt.clean_checkpoints(str(tmp_path / "jax"))
    rel = lambda side, rm: sorted(
        (os.path.relpath(p, tmp_path / side), n) for p, n in rm)
    assert rel("port", ours) == rel("jax", theirs)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert "a/00010.ckpt.npz" in _files(tmp_path / "port")

    before = _files(tmp_path / "dry")
    port_clean.main([str(tmp_path / "dry"), "--dry-run"])
    out = capsys.readouterr().out.splitlines()
    assert _files(tmp_path / "dry") == before
    assert sorted(out[:-1]) == sorted(
        f"would remove {tmp_path / 'dry' / p}" for p, _ in rel("jax", theirs))
    assert out[-1] == "freed 0.0 MB (dry run)"


def test_export_program_equals_eager_step(exported, capsys):
    """`--program` (the counterpart of the JAX `--stablehlo`): the encode
    and decode dispatches at --streams 2 / --frames 2, saved as
    torch.export programs, loaded back and stepped three times, give the
    eager drivers' tokens, waveform and caches bitwise on the CPU; the RVQ
    cascade is one `hilcodec::rvq_cascade` node of the encode program."""
    tmp, cfg, path = exported
    cfg_path = str(tmp / "config.yaml")
    out = str(tmp / "prog" / "hil")
    port_export.main(["-c", cfg_path, "--ckpt", path, "-o", out,
                      "--device", "cpu", "--program", "--streams", "2",
                      "--frames", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert any(f"{out}_enc.pt2" in ln and "streams=2, frames=2" in ln
               for ln in lines)
    enc = torch.export.load(f"{out}_enc.pt2").module()
    dec = torch.export.load(f"{out}_dec.pt2").module()
    ops = [str(nd.target) for nd in enc.graph.nodes
           if "hilcodec" in str(nd.target)]
    assert ops == ["hilcodec.rvq_cascade.default"]
    model, params, vq_state = ckpt.load_codec(HParams(**cfg), path, "cpu",
                                              random_books=False)
    params = model.fold_params(params)
    ce, cd = model.init_cache(2)
    pe, pd = list(ce), list(cd)
    wav = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (2, 1, 6 * model.hop_length)) * 0.3).astype(np.float32))
    n2 = 2 * model.hop_length
    with torch.no_grad():
        for i in range(3):
            x = wav[:, :, i * n2:(i + 1) * n2]
            tok, ce = model.encode_stream(params, vq_state, x, ce,
                                          frames_per_step=2)
            got = enc(x, *pe)
            tok_p, pe = got[0], list(got[1:])
            assert torch.equal(tok_p, tok)
            y, cd = model.decode_stream(params, vq_state, tok, cd,
                                        frames_per_step=2)
            got = dec(tok_p, *pd)
            y_p, pd = got[0], list(got[1:])
            assert torch.equal(y_p, y)
            for a, b in zip(pe + pd, ce + cd):
                assert torch.equal(a, b)


def test_rvq_operator_fake_gives_the_kernel_shapes():
    """The operator's fake implementation (what tracing sees): the kernel's
    [n, B, T] int32 output, and its refusal of anything but f32."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(3, 5, 16)
        books = torch.empty(4, 32, 16)
        out = torch.ops.hilcodec.rvq_cascade(x, books, 2)
        assert out.shape == (2, 3, 5) and out.dtype == torch.int32
        with pytest.raises(TypeError, match="float32"):
            torch.ops.hilcodec.rvq_cascade(x.bfloat16(), books, 2)
