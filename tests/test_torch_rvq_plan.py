"""The RVQ cascade kernel's launch plan and its cluster merge, on the CPU.

`rvq_plan` (ops/rvq_kernel.py) is what the card launches, passed whole to
the kernel: the cluster size and rows per cluster chosen from how many
clusters the card holds at once, the codewords of a stage split into one
contiguous slice per CTA of a cluster, each slice into chunks, and a ring
that fits shared memory. `emulate` repeats the kernel's algorithm in torch
(csrc/rvq.cu) on that plan: per row tile and stage, each CTA's first
argmin over its slice, chunk by chunk, then the rank-order merge by
"smaller distance, then smaller index", then the residual update. Its
tokens must be bitwise those of the plain cascade (`ops/rvq.quantize`) and
of JAX's Pallas kernels in interpret mode, the resident one (K1) and the
staged one (K2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hilcodec_tpu.ops.pallas_rvq import quantize_pallas

from hilcodec_tpu_torch.ops import rvq as TQ
from hilcodec_tpu_torch.ops import rvq_kernel as RK
from hilcodec_tpu_torch.ops.conv import row_matmul

from torch_port_common import n, t

NO_INDEX = 2 ** 31 - 1
# clusters an H100 SXM holds at once at one CTA an SM, by cluster size
# (cudaOccupancyMaxActiveClusters at the flagship's shared memory)
H100_HELD = {16: 7, 8: 15}


def h100(plan: RK.RvqPlan) -> int:
    return H100_HELD[plan.cluster]


def slices(plan: RK.RvqPlan, K: int):
    """[k0, k1) of each CTA rank, in rank order (empty past K), as the
    kernel cuts them from the plan's slice."""
    return [(min(K, r * plan.slice), min(K, (r + 1) * plan.slice))
            for r in range(plan.cluster)]


def row_tiles(plan: RK.RvqPlan, M: int):
    """[m0, m1) of each cluster's rows, clipped to M."""
    return [(m0, min(M, m0 + plan.rows)) for m0 in range(0, M, plan.rows)]


def _better(d, i, bd, bi):
    """Elementwise: (d, i) beats (bd, bi)."""
    return (d < bd) | ((d == bd) & (i < bi))


def emulate(x: torch.Tensor, books: torch.Tensor, n_use: int,
            plan: RK.RvqPlan) -> torch.Tensor:
    """The kernel's tokens for x [M, C], codebooks [n_q, K, C]: [n, M]."""
    M, C = x.shape
    K = books.shape[1]
    out = torch.empty((n_use, M), dtype=torch.int32)
    for m0, m1 in row_tiles(plan, M):
        r = x[m0:m1].float()
        for s in range(n_use):
            e = books[s].float()
            # the distances of the reference's formula; a row's bits do not
            # depend on the rows beside it (row_matmul)
            dist = (torch.sum(r * r, 1, keepdim=True)
                    - 2.0 * row_matmul(r, e.T)
                    + torch.sum(e * e, 1)[None, :])
            bd = torch.full((m1 - m0,), float("inf"))
            bi = torch.full((m1 - m0,), NO_INDEX, dtype=torch.int64)
            for k0, k1 in slices(plan, K):           # CTA ranks in order
                cd = torch.full_like(bd, float("inf"))
                ci = torch.full_like(bi, NO_INDEX)
                for j in range(plan.chunks):         # the ring's chunks
                    a = min(k1, k0 + j * plan.codes)
                    b = min(k1, a + plan.codes)
                    if a == b:
                        continue
                    d, i = torch.min(dist[:, a:b], 1)  # first index
                    take = _better(d, i + a, cd, ci)
                    cd, ci = torch.where(take, d, cd), torch.where(
                        take, i + a, ci)
                take = _better(cd, ci, bd, bi)
                bd, bi = torch.where(take, cd, bd), torch.where(take, ci, bi)
            bi = torch.where(bi == NO_INDEX, 0, bi)
            out[s, m0:m1] = bi.to(torch.int32)
            r = r - e[bi]
    return out


@pytest.mark.parametrize("cluster", RK.CLUSTERS)
@pytest.mark.parametrize("K", [1024, 1000, 64, 16, 5])
def test_plan_slices_cover_each_codeword_once(K, cluster):
    plan = RK.make_plan(16, K, 128, 8, cluster, 8)
    cut = slices(plan, K)
    seen = np.zeros(K, dtype=int)
    prev = 0
    for k0, k1 in cut:
        assert k0 == prev and k0 <= k1      # contiguous, in rank order
        prev = k1
        seen[k0:k1] += 1
        # the chunks cover the slice
        assert plan.chunks * plan.codes >= k1 - k0
    assert prev == K and (seen == 1).all()
    assert plan.slice == -(-K // cluster)
    if K < cluster:
        assert sum(k0 == k1 for k0, k1 in cut) == cluster - K


@pytest.mark.parametrize("M", [1, 7, 16, 128, 1000])
def test_plan_row_tiles_cover_rows(M):
    for held in (h100, lambda p: 1):
        plan = RK.rvq_plan(M, 1024, 128, 8, held)
        tiles = row_tiles(plan, M)
        assert plan.tiles == len(tiles) == -(-M // plan.rows)
        assert tiles[0][0] == 0 and tiles[-1][1] == M
        for (a0, a1), (b0, _) in zip(tiles, tiles[1:]):
            assert a1 == b0 and a1 - a0 == plan.rows


@pytest.mark.parametrize("M,held,want", [
    (1, H100_HELD, (16, 8)), (16, H100_HELD, (16, 8)),
    (56, H100_HELD, (16, 8)),     # 7 clusters of 16: one wave
    (57, H100_HELD, (8, 8)),      # 8 of 16 overflow it, 8 of 8 do not
    (120, H100_HELD, (8, 8)),
    (128, H100_HELD, (8, 16)),    # 16 tiles of 8 rows overflow 15
    (1000, H100_HELD, (8, 16)),
    (16, {16: 0, 8: 15}, (8, 8)),  # a card without clusters of 16
])
def test_plan_takes_the_widest_cluster_that_fits_one_wave(M, held, want):
    plan = RK.rvq_plan(M, 1024, 128, 8, lambda p: held[p.cluster])
    assert (plan.cluster, plan.rows) == want
    assert plan == RK.make_plan(M, 1024, 128, 8, *want)


@pytest.mark.parametrize("cluster", RK.CLUSTERS)
@pytest.mark.parametrize("C", [64, 128])
def test_plan_shared_memory_fits(C, cluster):
    for K in (1024, 1000, 64, 16, 5, 8192):
        for rows in RK.ROWS:
            for n_use in (1, 3, 8, 32):
                plan = RK.make_plan(128, K, C, n_use, cluster, rows)
                assert plan.smem == RK.smem_bytes(C, plan.rows, plan.codes,
                                                  plan.ring)
                assert plan.smem <= RK.SMEM_MAX
                assert 1 <= plan.ring <= min(RK.MAX_RING,
                                             n_use * plan.chunks)
                # a slice of at most 64 codewords takes the narrow chunks
                assert plan.codes == (64 if plan.slice <= 64 else 128)
    # the flagship on an H100: at the serving shape, clusters of 16 with a
    # 64-codeword slice in one chunk and a ring of four; at the frame-kernel
    # path's 128 rows, clusters of 8 with a 128-codeword slice and a ring of
    # three
    serve = RK.rvq_plan(16, 1024, 128, 8, h100)
    assert (serve.cluster, serve.rows, serve.codes, serve.ring,
            serve.chunks) == (16, 8, 64, 4, 1)
    frame = RK.rvq_plan(128, 1024, 128, 8, h100)
    assert (frame.cluster, frame.rows, frame.codes, frame.ring,
            frame.chunks) == (8, 16, 128, 3, 1)


def test_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="C % 4"):
        RK.rvq_plan(16, 1024, 126, 8, h100)
    with pytest.raises(ValueError, match="instance"):
        RK.make_plan(16, 1024, 128, 8, 4, 8)
    with pytest.raises(ValueError, match="shared"):
        RK.rvq_plan(16, 1024, 1024, 8, h100)
    with pytest.raises(ValueError, match="holds no cluster"):
        RK.rvq_plan(16, 1024, 128, 8, lambda p: 0)


def _latents(rng, M, C, scale=1.0):
    x = rng.standard_normal((M, C))
    x = x / np.linalg.norm(x, axis=-1, keepdims=True) * np.sqrt(C) * scale
    return x.astype(np.float32)


@pytest.mark.parametrize("M,K,C,n_q,cluster", [
    (16, 1024, 128, 8, 16), (7, 1000, 64, 3, 16),   # ragged K
    (130, 5, 8, 2, 8),       # K < G: CTAs with empty slices; ragged M
    (33, 16, 64, 3, 16)])    # one codeword a CTA
def test_emulation_matches_plain_bitwise(M, K, C, n_q, cluster, rng):
    books = rng.standard_normal((n_q, K, C)).astype(np.float32)
    x = _latents(rng, M, C)
    plan = RK.rvq_plan(M, K, C, n_q, h100)
    assert plan.cluster == cluster
    got = emulate(t(x), t(books), n_q, plan)
    ref = TQ.quantize(t(x)[None], t(books))[:, 0]
    np.testing.assert_array_equal(n(got), n(ref))


@pytest.mark.parametrize("B", [1, 2])   # clusters of 16, then of 8
@pytest.mark.parametrize("staged", [False, True])
def test_emulation_matches_pallas_interpret(staged, B, rng):
    """K1 (resident) and K2 (staged) in Pallas interpret mode, as the JAX
    package's own tests run them on the CPU."""
    books = rng.standard_normal((4, 64, 16)).astype(np.float32)
    x = (rng.standard_normal((B, 50, 16)) * 2).astype(np.float32)
    ref = quantize_pallas(jnp.asarray(x), jnp.asarray(books), None,
                          interpret=True, staged=staged)
    plan = RK.rvq_plan(B * 50, 64, 16, 4, h100)
    assert plan.cluster == (16 if B == 1 else 8)
    got = emulate(t(x).reshape(B * 50, 16), t(books), 4, plan)
    np.testing.assert_array_equal(n(got), n(ref).reshape(4, B * 50))


@pytest.mark.parametrize("M", [16, 128])   # clusters of 16, then of 8
def test_duplicate_codewords_in_different_slices(M, rng):
    """Codewords 100 and 900 of stage 0 are equal and fall in different
    CTAs' slices; rows placed next to them tie exactly, and the lower
    index must win the merge, as in the plain cascade and in JAX."""
    books = rng.standard_normal((2, 1024, 16)).astype(np.float32)
    books[0, 900] = books[0, 100]
    x = _latents(rng, M, 16)
    x[::4] = books[0, 100] + 0.01 * rng.standard_normal((M // 4, 16))
    plan = RK.rvq_plan(M, 1024, 16, 2, h100)
    owner = [r for r, (k0, k1) in enumerate(slices(plan, 1024))
             if k0 <= 100 < k1 or k0 <= 900 < k1]
    assert len(owner) == 2                    # two different CTAs
    got = emulate(t(x), t(books), 2, plan)
    assert (n(got)[0, ::4] == 100).all()
    np.testing.assert_array_equal(
        n(got), n(TQ.quantize(t(x)[None], t(books))[:, 0]))
    ref = quantize_pallas(jnp.asarray(x[None]), jnp.asarray(books),
                          interpret=True)
    np.testing.assert_array_equal(n(got), n(ref)[:, 0])
