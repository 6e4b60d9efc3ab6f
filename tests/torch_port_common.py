"""Shared fixtures for the tests of the PyTorch port against the JAX package.

Both sides get the same inputs and parameters, made with numpy from a seed:
the JAX tree is initialized, flattened to its leaf paths, its zero-init
scales (`res_scale_param`, `scale_param`) are set to seeded nonzero values
so every residual and spec branch carries signal, and the same flat arrays
build the JAX tree and (through the port's bridge) the port's tree.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from hilcodec_tpu.models.codec import CodecModel as JaxCodecModel
from hilcodec_tpu.models.hilcodec import HILCodec as JaxHILCodec
from hilcodec_tpu.ops.rvq import ResidualVQ as JaxResidualVQ
from hilcodec_tpu.utils.checkpoint import _flatten
from hilcodec_tpu.utils.pytree import leaf_paths

from hilcodec_tpu_torch.models.codec import CodecModel
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.ops.rvq import ResidualVQ
from hilcodec_tpu_torch.utils import params as P

# two stages, two residual layers each: exercises the reversed strides,
# the shared wav ring, SpecBlocks at n_fft 16/32/64 and every cache kind
TINY = dict(channels_enc=8, channels_dec=8, n_residual_enc=2,
            n_residual_dec=2, strides=(4, 2), n_fft_base=16, vq_dim=16,
            res_scale_enc=0.577, res_scale_dec=0.577)
TINY_VQ = dict(dim=16, codebook_size=32, num_quantizers=3, kmeans_init=False)
CPU = torch.device("cpu")


def models():
    jm = JaxCodecModel(JaxHILCodec(**TINY), JaxResidualVQ(**TINY_VQ))
    tm = CodecModel(HILCodec(**TINY), ResidualVQ(**TINY_VQ), CPU)
    return jm, tm


def seeded_flat(jax_params, seed=0):
    """JAX leaf-path -> numpy arrays, zero-init scales made nonzero."""
    rng = np.random.default_rng(seed)
    flat = _flatten(jax_params)
    for k in flat:
        if k.endswith("scale_param"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    return flat


def jax_tree(template, flat):
    """Rebuild a JAX param tree shaped like `template` from flat arrays."""
    return jax.tree.unflatten(
        jax.tree.structure(template),
        [jnp.asarray(flat[p]) for p in leaf_paths(template)])


def both_params(jm, tm, seed=0):
    """(jax_params, port_params), unfolded, with equal values."""
    template, _ = jm.init(jax.random.PRNGKey(seed))
    flat = seeded_flat(template, seed)
    return jax_tree(template, flat), P.from_flat(flat,
                                                 tm.param_template(False))


def codebooks(seed=1, shape=(3, 32, 16)):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32))


def t(x):
    """numpy / JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def n(x):
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_jax_checkpoint(hps, path, seed=0):
    """A JAX train checkpoint of config `hps` (a JAX HParams) at `path`:
    the JAX trainer's initial state, its zero-init scales set to seeded
    nonzero values and its codebooks (where it has Euclidean ones) to
    N(0, 1) draws, so that every branch and every code carries signal. Returns the flat arrays."""
    from hilcodec_tpu.models import discriminators as jax_discs
    from hilcodec_tpu.train.loop import build_trainer
    try:
        state = jax.jit(build_trainer(hps).init_state)(
            jax.random.PRNGKey(seed))
    finally:
        jax_discs.set_fbd_lowering("conv2d")
    flat = seeded_flat(state, seed)
    rng = np.random.default_rng(seed + 1)
    key = ".vq_state/embed"
    if key in flat:             # a quantizer with Euclidean codebooks
        flat[key] = rng.standard_normal(flat[key].shape).astype(np.float32)
    flat["__extra__/epoch"] = np.asarray(1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    return flat
