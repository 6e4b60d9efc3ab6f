"""Port RVQ (plain cascade, kernel wrapper, tie check) against the JAX
package, on the CPU. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py; here the wrapper must run the plain
version for CPU tensors and count no launch.

Token bar: `assert_token_parity_exact_or_fp_tie` from tests/test_rvq.py
(exact, or a provable f32 tie). `dequantize` must be exact: it is the same
sequence of f32 adds on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hilcodec_tpu.ops import rvq as JQ
from hilcodec_tpu.ops.pallas_rvq import quantize_pallas

from hilcodec_tpu_torch.ops import rvq as TQ
from hilcodec_tpu_torch.ops import rvq_kernel

from test_rvq import assert_token_parity_exact_or_fp_tie
from torch_port_common import n, t


def _latents(rng, M, C):
    """Unit vectors scaled by sqrt(C), like the encoder's l2norm output."""
    x = rng.standard_normal((1, M, C))
    x = x / np.linalg.norm(x, axis=-1, keepdims=True) * np.sqrt(C)
    return x.astype(np.float32)


@pytest.mark.parametrize("n_q,n_use", [(8, None), (8, 3), (32, None)])
def test_plain_quantize_matches_jax_at_full_shapes(n_q, n_use, rng):
    """Flagship 8 x 1024 x 128 at M=64 (full and partial n), and the
    n_q=32 stack the JAX package sends to the staged kernel (K2)."""
    books = rng.standard_normal((n_q, 1024, 128)).astype(np.float32)
    x = _latents(rng, 64, 128)
    n_eff = n_q if n_use is None else n_use
    ours = TQ.quantize(t(x), t(books), n_use)
    assert ours.shape == (n_eff, 1, 64) and ours.dtype == torch.int32
    assert_token_parity_exact_or_fp_tie(n(ours), x, books, n_eff)
    ref = JQ.quantize(jnp.asarray(x), jnp.asarray(books), n_use)
    assert TQ.token_parity_report(ours, t(ref), t(x), t(books))["ok"]
    np.testing.assert_array_equal(
        n(TQ.dequantize(ours, t(books))),
        n(JQ.dequantize(jnp.asarray(n(ours)), jnp.asarray(books))))


@pytest.mark.parametrize("staged,n_use", [(False, None), (True, None),
                                           (False, 2), (True, 2)])
def test_plain_quantize_matches_pallas_interpret(staged, n_use, rng):
    """K1 (resident) and K2 (staged) run in Pallas interpret mode, as the
    JAX package's own tests run them on the CPU."""
    books = rng.standard_normal((4, 64, 16)).astype(np.float32)
    x = (rng.standard_normal((2, 50, 16)) * 2).astype(np.float32)
    ref = quantize_pallas(jnp.asarray(x), jnp.asarray(books), n_use,
                          interpret=True, staged=staged)
    ours = TQ.quantize(t(x), t(books), n_use)
    np.testing.assert_array_equal(n(ours), n(ref))


def test_quantize_dequantize_matches_jax(rng):
    books = rng.standard_normal((3, 32, 16)).astype(np.float32)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    qj, ij = JQ.quantize_dequantize(jnp.asarray(x), jnp.asarray(books))
    qt, it = TQ.quantize_dequantize(t(x), t(books))
    np.testing.assert_array_equal(n(it), n(ij))
    np.testing.assert_array_equal(n(qt), n(qj))


def test_wrapper_uses_plain_version_on_cpu(rng):
    """A CPU tensor takes the plain version and launches nothing."""
    books = rng.standard_normal((3, 32, 16)).astype(np.float32)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    rvq_kernel.reset_launches()
    got = rvq_kernel.quantize(t(x), t(books), 2)
    np.testing.assert_array_equal(n(got), n(TQ.quantize(t(x), t(books), 2)))
    assert rvq_kernel.LAUNCHES[rvq_kernel.KERNEL] == 0


def test_kernel_entry_refuses_cpu_tensors(rng):
    """The kernel entry never computes on the CPU: it raises."""
    books = torch.randn(2, 32, 16)
    with pytest.raises(ValueError, match="CUDA"):
        rvq_kernel.quantize_cuda(torch.randn(1, 4, 16), books)
    assert rvq_kernel.LAUNCHES[rvq_kernel.KERNEL] == 0


def test_codebook_norms_cached_and_refreshed():
    books = torch.randn(2, 8, 4)
    a = rvq_kernel.codebook_norms(books)
    assert rvq_kernel.codebook_norms(books) is a
    torch.testing.assert_close(a, (books * books).sum(-1))
    books.mul_(2.0)                      # in-place change bumps the version
    b = rvq_kernel.codebook_norms(books)
    assert b is not a
    torch.testing.assert_close(b, (books * books).sum(-1))


def _tie_books(rng):
    """A stack whose codewords 3 and 7 of stage 0 are identical, so their
    distances tie exactly for every input."""
    books = rng.standard_normal((2, 16, 8)).astype(np.float32)
    books[0, 7] = books[0, 3]
    return books


def test_port_tie_check_agrees_with_reference_analyzer(rng):
    """The port's own float64 tie check (used on the card) accepts what
    assert_token_parity_exact_or_fp_tie accepts and rejects what it
    rejects: exact tokens, a constructed exact tie, and a real flip."""
    books = _tie_books(rng)
    # 2000 rows keep one mismatch under the analyzers' 1e-3 rate cap
    x = rng.standard_normal((1, 2000, 8)).astype(np.float32)
    ref = n(TQ.quantize(t(x), t(books)))
    assert_token_parity_exact_or_fp_tie(ref, x, books, 2)
    assert TQ.token_parity_report(t(ref), t(ref), t(x), t(books))["ok"]

    # exact tie: choose the later duplicate where the reference chose 3
    tie = ref.copy()
    p = int(np.where(ref[0, 0] == 3)[0][0])
    tie[0, 0, p] = 7
    assert_token_parity_exact_or_fp_tie(tie, x, books, 2)
    rep = TQ.token_parity_report(t(tie), t(ref), t(x), t(books))
    assert rep["ok"] and rep["ties"] == 1 and rep["not_ties"] == 0

    # a real flip to a codeword that is not a tie
    flip = ref.copy()
    q = int(np.where(ref[0, 0] != 3)[0][0])
    flip[0, 0, q] = (ref[0, 0, q] + 1) % 16
    with pytest.raises(AssertionError):
        assert_token_parity_exact_or_fp_tie(flip, x, books, 2)
    rep = TQ.token_parity_report(t(flip), t(ref), t(x), t(books))
    assert not rep["ok"] and rep["not_ties"] == 1


def test_residual_vq_init_state():
    vq = TQ.ResidualVQ(dim=8, codebook_size=16, num_quantizers=3,
                       kmeans_init=False)
    a = vq.init_state(torch.Generator().manual_seed(0))["embed"]
    b = vq.init_state(torch.Generator().manual_seed(0))["embed"]
    assert a.shape == (3, 16, 8) and torch.equal(a, b)
    z = TQ.ResidualVQ(dim=8, codebook_size=16, num_quantizers=3)
    assert not z.init_state(torch.Generator())["embed"].any()
