"""The port's spectral norm and HiFi-GAN discriminators (MPD, MSD) and the
flagship trainer's `Discriminators` aggregate with mpd / msd / sbd against
the JAX package on the CPU, on params bridged from JAX's init.

Tolerances: spectral norm's weight and power iteration 1e-6 relative to
the reference's largest magnitude (f32 matrix-vector products), its
weight from bf16 inputs one bf16 rounding (2^-8) of it; logits
and feature maps 1e-5 of the reference's largest magnitude (f32 convs
through different libraries). Init leaf paths and shapes are compared
exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models import discriminators as JD
from hilcodec_tpu.ops import reparam as JR
from hilcodec_tpu.utils.pytree import leaf_paths

from hilcodec_tpu_torch.models import discriminators as TD
from hilcodec_tpu_torch.ops import reparam as TR
from hilcodec_tpu_torch.utils import params as P

SN_TOL = 1e-6
FWD_TOL = 1e-5
T = 1000                # not a multiple of 3, 7 or 11: MPD's reflect pad
SBD_TINY = dict(
    use=True, channels=[[4, 8], [4, 8]], strides=[[1, 3], [1, 3]],
    kernel_sizes=[[[7, 7], [7, 7]], [[3, 3], [3, 3]]],
    dilations=[[[1, 2], [1, 2]], [[1, 2], [2, 3]]],
    band_ranges=[[0, 2], [0, 8]], transpose=[False, True],
    pqmf_kwargs={"subbands": 4, "taps": 32, "cutoff_freq": 0.1,
                 "beta": 10.0},
    f_pqmf_kwargs={"subbands": 8, "taps": 32, "cutoff_freq": 0.1,
                   "beta": 9.0},
    segment_size=T)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this module: the test runs share the host's
    cores between several worker processes, and a full complement of
    threads in each makes the full-width CPU convs here slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err)


def wav(seed, shape=(2, 1, T)):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.3).astype(np.float32)


def port_params(jparams):
    return P.unflatten({p.replace("/", "."): t(x) for p, x in zip(
        leaf_paths(jparams), jax.tree.leaves(jparams))})


def both(jmod, tmod, x, seed=0):
    """(JAX outputs, port outputs) of one module on the same params."""
    jparams = jmod.init(jax.random.PRNGKey(seed))
    jout = jax.jit(jmod.apply)(jparams, jnp.asarray(x))
    return jout, tmod.apply(port_params(jparams), t(x))


def cmp_out(jout, tout, what):
    (jl, jf), (tl, tf) = jout, tout
    if isinstance(jl, dict):
        assert list(jl) == list(tl), what
        for k in jl:
            cmp_out((jl[k], jf[k]), (tl[k], tf[k]), f"{what}/{k}")
        return
    jl = jl if isinstance(jl, list) else [jl]
    tl = tl if isinstance(tl, list) else [tl]
    assert len(jl) == len(tl) and len(jf) == len(tf), what
    for i, (a, b) in enumerate(zip(tl, jl)):
        close(a.detach().numpy(), b, FWD_TOL, f"{what} logits {i}")
    for i, (a, b) in enumerate(zip(tf, jf)):
        close(a.detach().numpy(), b, FWD_TOL, f"{what} fmap {i}")


def same_tree_shapes(jtree, ttree):
    want = {p: np.shape(x) for p, x in zip(leaf_paths(jtree),
                                           jax.tree.leaves(jtree))}
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in P.flatten(ttree).items()}
    assert got == want


# ------------------------------------------------------------ spectral norm

@pytest.mark.parametrize("shape", [(8, 4, 5), (1, 16, 3), (6, 3, 5, 1)])
def test_spectral_norm_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    v = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal(shape[0]).astype(np.float32)
    u /= np.linalg.norm(u)
    close(TR.spectral_norm_compute(t(v), t(u)).numpy(),
          JR.spectral_norm_compute(jnp.asarray(v), jnp.asarray(u)),
          SN_TOL, "compute")
    ju, tu = jnp.asarray(u), t(u)
    for i in range(3):      # the iteration converges on the same vector
        ju = JR.spectral_norm_power_iter(jnp.asarray(v), ju)
        tu = TR.spectral_norm_power_iter(t(v), tu)
        close(tu.numpy(), ju, SN_TOL, f"power iteration {i}")
    # compute takes no gradient through u
    vt, ut = t(v).requires_grad_(True), t(u).requires_grad_(True)
    TR.spectral_norm_compute(vt, ut).sum().backward()
    assert ut.grad is None and vt.grad is not None


def test_spectral_norm_in_bf16_matches_jax():
    """In the bf16 step the cast params reach spectral norm as bf16: sigma
    comes out of f32 products on both sides, the weight back in bf16,
    within one bf16 rounding of JAX's."""
    rng = np.random.default_rng(7)
    v = rng.standard_normal((16, 8, 5)).astype(np.float32)
    u = rng.standard_normal(16).astype(np.float32)
    u /= np.linalg.norm(u)
    ref = JR.spectral_norm_compute(jnp.asarray(v, jnp.bfloat16),
                                   jnp.asarray(u, jnp.bfloat16))
    got = TR.spectral_norm_compute(t(v).bfloat16(), t(u).bfloat16())
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    close(got.float().numpy(), np.asarray(ref, np.float32), 2.0 ** -8,
          "bf16 compute")


def test_spectral_norm_init_and_fold():
    gen = torch.Generator().manual_seed(0)
    w, b = TR.torch_default_conv_init(gen, (8, 4, 5))
    p = TR.init_reparam(w, TR.SPECTRAL_NORM, bias=b, gen=gen)
    assert set(p) == {"v", "u", "b"} and p["u"].shape == (8,)
    assert abs(float(torch.linalg.vector_norm(p["u"])) - 1.0) < 1e-6
    folded = TR.fold_tree({"conv": p, "other": {"w": w}})
    assert set(folded["conv"]) == {"w", "b"}
    assert torch.equal(folded["conv"]["w"],
                       TR.spectral_norm_compute(p["v"], p["u"]))
    # weight standardization (ported since): JAX's {v, g} init, its
    # weight in the fold
    ws = TR.init_reparam(w, "weight_standardization", bias=b)
    ref = JR.init_reparam(jnp.asarray(w.numpy()), "weight_standardization",
                          bias=jnp.asarray(b.numpy()))
    assert set(ws) == set(ref) == {"v", "g", "b"}
    for k in ref:
        np.testing.assert_array_equal(ws[k].numpy(), np.asarray(ref[k]))
    folded = TR.fold(ws, TR.WEIGHT_STANDARDIZATION)
    close(folded["w"].numpy(), JR.fold(ref, JR.WEIGHT_STANDARDIZATION)["w"],
          SN_TOL, "standardized fold")


# -------------------------------------------------------------------- MPD

@pytest.mark.parametrize("kernel_size", [5, 3])
def test_mpd_matches_jax(kernel_size):
    """Periods 2-11 on 1000 samples (3, 7 and 11 pad by reflection); a
    kernel of 3 keeps the strided convs' padding of get_padding(5)."""
    kw = dict(kernel_size=kernel_size)
    cmp_out(*both(JD.MultiPeriodDiscriminator(**kw),
                  TD.MultiPeriodDiscriminator(**kw), wav(1)),
            f"mpd k={kernel_size}")


# -------------------------------------------------------------------- MSD

@pytest.mark.parametrize("use_pqmf", [False, True])
def test_msd_matches_jax(use_pqmf):
    """The three scales with norms [spectral, weight, weight], pooled by
    AvgPool1d(4, 2, 1) or by the first PQMF band."""
    jm = JD.MultiScaleDiscriminator(use_pqmf=use_pqmf)
    tm = TD.MultiScaleDiscriminator(use_pqmf=use_pqmf)
    assert [d.norm for d in tm.discs] == [d.norm for d in jm.discs] == [
        "spectral_norm", "weight_norm", "weight_norm"]
    cmp_out(*both(jm, tm, wav(2)), f"msd use_pqmf={use_pqmf}")


def test_avg_pool_counts_the_pads():
    x = wav(3, (2, 3, 17))
    ref = jax.jit(JD._avg_pool1d)(jnp.asarray(x))
    close(TD._avg_pool1d(t(x)).numpy(), ref, 1e-7, "avg pool")


# -------------------------------------------------------------- aggregate

AGG = dict(mpd_kwargs=dict(use=True, periods=[2, 3]),
           msd_kwargs=dict(use=True),
           mfbd_kwargs=dict(use=False), sbd_kwargs=SBD_TINY)


def test_discriminators_with_mpd_msd_sbd_match_jax():
    """mpd, msd and sbd in JAX's key order, each family's logits and
    feature maps against JAX."""
    jm, tm = JD.Discriminators(**AGG), TD.Discriminators(**AGG)
    assert list(tm.discs) == list(jm.discs) == ["mpd", "msd", "sbd"]
    cmp_out(*both(jm, tm, wav(4)), "discriminators")


def test_discriminator_init_paths_and_shapes_match_jax():
    """The port's own init has JAX's leaf paths and shapes (the `u`
    buffers of MSD's first scale included), so checkpoints cross."""
    jparams = JD.Discriminators(**AGG).init(jax.random.PRNGKey(0))
    tparams = TD.Discriminators(**AGG).init(torch.Generator().manual_seed(0))
    same_tree_shapes(jparams, tparams)
    u = tparams["msd"]["discs"][0]["convs"][0]["u"]
    assert u.shape == (128,) and "u" not in tparams["msd"]["discs"][1][
        "convs"][0]
