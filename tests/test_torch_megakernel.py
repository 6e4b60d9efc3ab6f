"""The port's decoder and encoder frame kernels (ops/decoder_kernel.py,
ops/encoder_kernel.py) against the JAX package's Pallas megakernels, on the
CPU at the tiny config.

On CPU tensors the step classes run the plain version of csrc/segment.cu,
which is held here against JAX's `DecoderMegakernel` / `EncoderMegakernel`
in interpret mode at the JAX tests' tolerances (rtol 1e-5 / atol 1e-6 for
the decoder, 1e-4 / 1e-5 for the encoder). The kernel itself runs only on the
card (chip_smoke.py); what it is driven by, the phase table, is checked
here by an emulator of its phase semantics against the plain version.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from hilcodec_tpu.models.hilcodec import HILCodec as JaxHILCodec
from hilcodec_tpu.ops.pallas_decoder import DecoderMegakernel as JaxDecMK
from hilcodec_tpu.ops.pallas_decoder import _decoder_ops
from hilcodec_tpu.ops.pallas_encoder import EncoderMegakernel as JaxEncMK
from hilcodec_tpu.ops.pallas_encoder import _encoder_ops

from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.ops import decoder_kernel as DK
from hilcodec_tpu_torch.ops import encoder_kernel as EK

from torch_port_common import both_params, codebooks, models, n, t

FRAMES = 4
B = 3


@pytest.fixture(scope="module")
def setup():
    jm, tm = models()
    pj, pt = both_params(jm, tm)
    return jm, tm, jm.fold_params(pj), tm.fold_params(pt)


def _same_ops(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert (a.kind, a.attrs, a.cache_slot, a.atomic_group) == (
            b.kind, b.attrs, b.cache_slot, b.atomic_group)


FLAGSHIP = dict(res_scale_enc=0.5773502691896258,
                res_scale_dec=0.5773502691896258)


@pytest.mark.parametrize("cfg", ["tiny", "flagship"])
def test_decoder_ops_match_jax(setup, cfg):
    jm, tm, _, _ = setup
    jd, td = jm.codec.decoder, tm.codec.decoder
    if cfg == "flagship":
        jd, td = JaxHILCodec(**FLAGSHIP).decoder, HILCodec(**FLAGSHIP).decoder
    ops, shapes, dim = DK.decoder_ops(td)
    rops, rshapes, rdim = _decoder_ops(jd)
    _same_ops(ops, rops)
    assert (shapes, dim) == (rshapes, rdim)


@pytest.mark.parametrize("cfg", ["tiny", "flagship"])
def test_encoder_ops_match_jax(setup, cfg):
    jm, tm, _, _ = setup
    je, te = jm.codec.encoder, tm.codec.encoder
    if cfg == "flagship":
        je, te = JaxHILCodec(**FLAGSHIP).encoder, HILCodec(**FLAGSHIP).encoder
    ops, shapes, specs = EK.encoder_ops(te)
    rops, rshapes, rspecs = _encoder_ops(je)
    _same_ops(ops, rops)
    assert shapes == rshapes and specs == rspecs


def _close_tm(port_caches, jax_caches, rtol, atol):
    assert len(port_caches) == len(jax_caches)
    for a, b in zip(port_caches, jax_caches):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(n(a), n(b), rtol=rtol, atol=atol)


def test_decoder_step_matches_jax_interpret(setup):
    jm, tm, fj, ft = setup
    jmk = JaxDecMK(jm.codec.decoder, block_streams=B, interpret=True)
    jstep = jax.jit(jmk.step)
    tmk = DK.DecoderMegakernel(tm.codec.decoder)
    cj, ct = jmk.init_cache(B), tmk.init_cache(B)
    rng = np.random.default_rng(0)
    for _ in range(FRAMES):
        q = (rng.standard_normal((B, 16, 1)) * 0.5).astype(np.float32)
        yj, cj = jstep(fj["decoder"], cj, jnp.asarray(q))
        yt, ct = tmk.step(ft["decoder"], ct, t(q))
        assert yt.shape == (B, 1, 8)
        np.testing.assert_allclose(n(yt), n(yj), rtol=1e-5, atol=1e-6)
        _close_tm(ct, cj, rtol=1e-5, atol=1e-6)


def test_encoder_step_matches_jax_interpret(setup):
    jm, tm, fj, ft = setup
    jmk = JaxEncMK(jm.codec.encoder, block_streams=B, interpret=True)
    jstep = jax.jit(jmk.step)
    tmk = EK.EncoderMegakernel(tm.codec.encoder)
    cj = jmk.cache_to_time_major(jm.codec.encoder.init_cache(B))
    ct = tmk.cache_to_time_major(tm.codec.encoder.init_cache(B))
    rng = np.random.default_rng(1)
    for _ in range(FRAMES):
        x = (rng.standard_normal((B, 1, 8)) * 0.3).astype(np.float32)
        zj, cj = jstep(fj["encoder"], cj, jnp.asarray(x))
        zt, ct = tmk.step(ft["encoder"], ct, t(x))
        assert zt.shape == (B, 16, 1)
        np.testing.assert_allclose(n(zt), n(zj), rtol=1e-4, atol=1e-5)
        _close_tm(ct, cj, rtol=1e-4, atol=1e-5)


def test_codec_streams_with_frame_kernels_match_jax(setup):
    """encode_stream(megakernel=True) tokens equal JAX's (interpret mode);
    decode_stream(megakernel=True) wav and caches match JAX's, and the
    cache lists come back in the public [B, C, L] layout and order."""
    jm, tm, fj, ft = setup
    books = codebooks()
    wav = (np.random.default_rng(2).standard_normal((2, 1, FRAMES * 8))
           * 0.3).astype(np.float32)
    cej, cdj = jm.init_cache(2)
    cet, cdt = tm.init_cache(2)
    vj, vt = {"embed": jnp.asarray(books)}, {"embed": t(books)}
    tokj, cej = jm.encode_stream(fj, vj, jnp.asarray(wav), cej,
                                 megakernel=True, megakernel_interpret=True)
    tokt, cet = tm.encode_stream(ft, vt, t(wav), cet, megakernel=True)
    np.testing.assert_array_equal(n(tokt), n(tokj))
    _close_tm(cet, cej, rtol=1e-4, atol=1e-5)
    outj, cdj = jm.decode_stream(fj, vj, tokj, cdj, megakernel=True,
                                 megakernel_interpret=True)
    outt, cdt = tm.decode_stream(ft, vt, tokt, cdt, megakernel=True)
    np.testing.assert_allclose(n(outt), n(outj), rtol=1e-5, atol=1e-6)
    _close_tm(cdt, cdj, rtol=1e-5, atol=1e-6)


def test_frame_kernel_streams_equal_plain_streams(setup):
    """Inside the port: megakernel=True and the plain frame step give the
    same tokens and, within f32 reassociation, the same wav and caches."""
    _, tm, _, ft = setup
    vq = {"embed": t(codebooks())}
    wav = t((np.random.default_rng(3).standard_normal((2, 1, 6 * 8))
             * 0.3).astype(np.float32))
    ce, cd = tm.init_cache(2)
    tok_p, ce_p = tm.encode_stream(ft, vq, wav, ce)
    tok_k, ce_k = tm.encode_stream(ft, vq, wav, ce, megakernel=True)
    assert torch.equal(tok_k, tok_p)
    out_p, cd_p = tm.decode_stream(ft, vq, tok_p, cd)
    out_k, cd_k = tm.decode_stream(ft, vq, tok_p, cd, megakernel=True)
    np.testing.assert_allclose(n(out_k), n(out_p), rtol=1e-5, atol=1e-6)
    for a, b in zip(ce_k + cd_k, ce_p + cd_p):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- phases

def _pre(p, v):
    for j in range(int(p["n_pre"])):
        kind = int(p["pre_kind"][j])
        if kind == 1:
            v = F.elu(v)
        elif kind == 2:
            v = torch.relu(v)
        elif kind == 3:
            v = torch.tanh(v)
        else:
            v = v * torch.tensor(p["pre_scale"][j], dtype=torch.float32)
    return v


def _emulate(table, B, x, aux, cache_in, weights):
    """The phase semantics of csrc/segment.cu, phase by phase, with the
    buffer rules the kernel relies on asserted."""
    bufs, y = {}, None
    cache_out = torch.full_like(cache_in, float("nan"))
    for p in table:
        kind = int(p["kind"])
        src, dst, res = int(p["src"]), int(p["dst"]), int(p["res"])
        ti, to, ci, co = (int(p[f]) for f in ("t_in", "t_out", "c_in",
                                              "c_out"))
        k, d = int(p["k"]), int(p["d"])
        if kind in (DK.PW, DK.DW, DK.CONVT, DK.POST, DK.DWS, DK.L2NORM):
            # reads neighbours of its source: never in place
            assert src < 0 or src != dst, p
            assert res < 0 or res != src, p
        data = x.reshape(-1) if src < 0 else bufs[src]

        def wt(name, rows, cols):
            off = int(p[name])
            return weights[off:off + rows * cols].view(rows, cols)

        bias = (weights[int(p["bias"]):int(p["bias"]) + co]
                if int(p["bias"]) >= 0 else 0.0)
        if kind in (DK.DW, DK.CONVT, DK.POST, DK.DWS):
            clen, off = int(p["cache_len"]), int(p["cache"])
            cache = cache_in[off:off + B * clen * ci].view(B, clen, ci)
            xc = torch.cat([cache, _pre(p, data[:B * ti * ci]
                                        .view(B, ti, ci))], 1)
            cache_out[off:off + B * clen * ci] = xc[:, ti:].reshape(-1)
        if kind == DK.EWISE:
            out = _pre(p, data[:B * ti * ci])
        elif kind in (DK.PW, DK.MIX):
            a = (aux[int(p["aux"])].reshape(-1, ci) if kind == DK.MIX
                 else _pre(p, data[:B * ti * ci].view(-1, ci)))
            w = wt("w", ci, co)
            splits, ks = int(p["splits"]), int(p["kslice"])
            assert (int(p["bm"]), int(p["bn"])) in DK.TILES, p
            assert splits >= 1 and (splits - 1) * ks < ci <= splits * ks, p
            out = None
            for s in range(splits):    # partial products, in slice order
                part = a[:, s * ks:(s + 1) * ks] @ w[s * ks:(s + 1) * ks]
                out = part if out is None else out + part
            out = out + bias
        elif kind == DK.DW:
            w = wt("w", k, ci)
            out = sum(xc[:, j * d:j * d + to] * w[j] for j in range(k)) + bias
        elif kind == DK.CONVT:
            wa, wb = wt("w", d, ci), wt("w2", d, ci)
            out = (xc[:, :ti, None] * wa + xc[:, 1:, None] * wb
                   ).reshape(B, to, ci) + bias
        elif kind == DK.POST:
            w = wt("w", k, ci)
            out = sum((xc[:, j:j + to] * w[j]).sum(-1) for j in range(k))
            out = out + bias
        elif kind == DK.DENSE1CH:
            wav, w = data[:B * ti].view(B, ti), wt("w", k, co)
            out = sum(wav[:, j:j + to, None] * w[j] for j in range(k)) + bias
        elif kind == DK.DWS:
            w = wt("w", k, ci)
            out = sum(xc[:, j:j + d * to:d] * w[j]
                      + xc[:, d + j:d + j + d * to:d] * w[d + j]
                      for j in range(d)) + bias
        else:
            assert kind == DK.L2NORM
            v = _pre(p, data[:B * ti * ci].view(-1, ci))
            out = v / torch.clamp(v.norm(dim=-1, keepdim=True),
                                  min=float(p["eps"])) * float(p["gain"])
        out = out.reshape(-1)
        if res >= 0:
            out = out + bufs[res][:out.numel()]
        if dst < 0:
            y = out
        else:
            bufs[dst] = out
    assert not torch.isnan(cache_out).any(), "a cache region was not written"
    return y, cache_out


GRID = 264   # an H100's persistent grid: 132 SMs x 2 blocks


@pytest.mark.parametrize("part,batch", [("decoder", 1), ("decoder", 3),
                                        ("encoder", 1), ("encoder", 3)])
def test_phase_table_computes_the_op_list(setup, part, batch):
    """The kernel's phase table (transforms folded into loads, residuals
    into epilogues, three scratch buffers) computes what the plain version
    computes, frame after frame, every cache region written."""
    _check_phase_table(setup, part, batch)


@pytest.mark.parametrize("part", ["decoder", "encoder"])
def test_phase_table_with_split_k_computes_the_op_list(setup, part):
    """The same with every GEMM phase split into K-slices of 8 (the tiny
    config's K fits one k-block, so the lowering itself never splits it):
    the partial products summed in slice order, as the kernel's reducer
    sums them, still give the plain version's step."""
    _check_phase_table(setup, part, 3, kslice=8)


def _check_phase_table(setup, part, batch, kslice=None):
    _, tm, _, ft = setup
    layer = getattr(tm.codec, part)
    mk = (DK.DecoderMegakernel(layer) if part == "decoder"
          else EK.EncoderMegakernel(layer))
    w = mk.weights(ft[part])
    rng = np.random.default_rng(4)
    caches = mk.init_cache(batch)
    for _ in range(3):
        if part == "decoder":
            x = torch.from_numpy(rng.standard_normal((batch, 1, 16))
                                 .astype(np.float32))
            aux = []
            cin = caches
        else:
            wav = torch.from_numpy(rng.standard_normal((batch, 12))
                                   .astype(np.float32))
            x = wav
            aux = [torch.from_numpy(rng.standard_normal((batch, tt, f))
                                    .astype(np.float32))
                   for tt, f in ((8, 9), (4, 17), (1, 33))]
            cin = caches[1:]
        table, _ = DK.build_phases(mk.ops, w.offsets, mk.cache_shapes, batch,
                                   x.shape[1], 1 if x.ndim == 2 else 16,
                                   GRID)
        if kslice is not None:
            gemm = np.isin(table["kind"], (DK.PW, DK.MIX))
            table["kslice"][gemm] = kslice
            table["splits"][gemm] = -(-table["c_in"][gemm] // kslice)
            assert (table["splits"][gemm] > 1).any()
        y_ref, c_ref = DK.run_plain(mk.ops, w.per_op, x, aux, cin)
        y, c_flat = _emulate(table, batch, x, aux, mk.pack(cin, batch),
                             w.flat)
        np.testing.assert_allclose(n(y), n(y_ref.reshape(-1)), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(n(c_flat), n(mk.pack(c_ref, batch)),
                                   rtol=1e-5, atol=1e-6)
        caches = (mk.unpack(c_flat, batch) if part == "decoder"
                  else [caches[0]] + mk.unpack(c_flat, batch))


def test_time_major_caches_are_one_packed_buffer(setup):
    """init_cache, cache_to_time_major and a step's caches are views of one
    buffer, which `pack` hands back without a copy; other lists are packed
    into a copy."""
    _, tm, _, ft = setup
    mk = DK.DecoderMegakernel(tm.codec.decoder)
    caches = mk.cache_to_time_major(tm.codec.decoder.init_cache(2))
    flat = mk.pack(caches, 2)
    assert flat.data_ptr() == caches[0].data_ptr()
    assert flat.numel() == sum(c.numel() for c in caches)
    copies = [c.clone() for c in caches]
    assert mk.pack(copies, 2).data_ptr() != copies[0].data_ptr()
    assert torch.equal(mk.pack(copies, 2), flat)
    back = mk.cache_from_time_major(caches)
    assert [tuple(c.shape) for c in back] == [
        tuple(c.shape) for c in tm.codec.decoder.init_cache(2)]


def test_unfolded_params_raise(setup):
    jm, tm, _, _ = setup
    _, pt = both_params(jm, tm)
    with pytest.raises(ValueError, match="folded"):
        DK.DecoderMegakernel(tm.codec.decoder).weights(pt["decoder"])
    with pytest.raises(ValueError, match="folded"):
        EK.EncoderMegakernel(tm.codec.encoder).weights(pt["encoder"])


def test_weights_are_prepared_once_per_tree(setup):
    _, tm, _, ft = setup
    mk = DK.DecoderMegakernel(tm.codec.decoder)
    w = mk.weights(ft["decoder"])
    assert mk.weights(ft["decoder"]) is w
    ft["decoder"]["pre_pw"]["w"].mul_(1.0)     # an in-place change
    assert mk.weights(ft["decoder"]) is not w


def test_kernel_path_raises_without_a_card(setup):
    """A non-CPU tensor never takes the plain version: here, with no card
    and no nvcc, the kernel's build raises."""
    if torch.cuda.is_available() or shutil.which("nvcc"):
        pytest.skip("a CUDA toolkit is present; chip_smoke.py runs the "
                    "kernel")
    with pytest.raises(RuntimeError, match="nvcc"):
        DK._library(torch.device("cuda", 0))


def test_unsupported_specs_raise():
    from hilcodec_tpu_torch.models.hilcodec import Decoder
    with pytest.raises(ValueError, match="ELU alpha 1"):
        DK.decoder_ops(Decoder(dimension=16, n_filters=8, ratios=(4, 2),
                               activation_params={"alpha": 0.5}))
