"""The frame kernels' GEMM tiling and the numerics of their tensor-core
products, on the CPU.

csrc/segment.cu runs each 1x1-conv phase as (tile, K-slice) work items with
the tile shape and K-split that the lowering (`gemm_tiling`, through
`build_phases`) wrote into the phase table, and multiplies with 3xTF32 on
the tensor cores. The kernel runs only on the card (chip_smoke.py); here the
flagship decoder's and encoder's tables are checked to cover every output
element once and every K column once, in slice order, with the kernel's own
item mapping, and a numpy model of 3xTF32 is held to the tolerance that
chip_smoke.py holds the kernel to.
"""

import functools
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import FRAME_TOL
from hilcodec_tpu_torch.models.hilcodec import HILCodec
from hilcodec_tpu_torch.ops import decoder_kernel as DK
from hilcodec_tpu_torch.ops import encoder_kernel as EK
from hilcodec_tpu_torch.utils.hparams import load_config

CONFIG = Path(__file__).resolve().parents[1] / "configs" / \
    "hilcodec_speech.yaml"
GRID = 264   # an H100's persistent grid: 132 SMs x 2 blocks


@functools.lru_cache(maxsize=None)
def _flagship(part):
    """(ops, cache_shapes, weight offsets, t, c) of the flagship's decoder or
    encoder frame step, from the config alone (no params: every weight sits
    at offset 0, which the lowering does not read)."""
    codec = HILCodec.from_config(load_config(str(CONFIG)).model_kwargs
                                 .to_dict())
    if part == "decoder":
        ops, shapes, dim = DK.decoder_ops(codec.decoder)
        t, c = 1, dim
    else:
        ops, shapes, _ = EK.encoder_ops(codec.encoder)
        t, c = codec.encoder.kernel_size - 1 + codec.hop_length, 1
    offsets = [dict(w=0, w2=0, b=0) if "path" in op.attrs else None
               for op in ops]
    return ops, shapes, offsets, t, c


@pytest.mark.parametrize("batch", [1, 7, 16, 128])
@pytest.mark.parametrize("part", ["decoder", "encoder"])
def test_gemm_tiling_covers_every_element_and_k_once(part, batch):
    ops, shapes, offsets, t, c = _flagship(part)
    table, _ = DK.build_phases(ops, offsets, shapes, batch, t, c, GRID)
    ws, counters = DK.split_workspace(table, batch)
    gemms = table[np.isin(table["kind"], (DK.PW, DK.MIX))]
    assert len(gemms) == (29 if part == "decoder" else 26)
    for p in gemms:
        M, N, K = batch * int(p["t_in"]), int(p["c_out"]), int(p["c_in"])
        bm, bn, S, ks = (int(p[f]) for f in ("bm", "bn", "splits", "kslice"))
        assert (bm, bn) in DK.TILES and 1 <= S <= DK.MAX_SPLITS
        assert ks % DK.BK == 0
        tiles_n = -(-N // bn)
        tiles = -(-M // bm) * tiles_n
        cover = np.zeros((M, N), np.int32)
        slices = {}
        for item in range(tiles * S):        # segment.cu gemm's mapping
            tile, s = divmod(item, S)
            m0, n0 = (tile // tiles_n) * bm, (tile % tiles_n) * bn
            k0, k1 = s * ks, min(K, (s + 1) * ks)
            if s == 0:
                cover[m0:m0 + bm, n0:n0 + bn] += 1
            slices.setdefault(tile, []).append((k0, k1))
        assert (cover == 1).all(), p
        for tile, ranges in slices.items():
            # consecutive and non-empty, in slice order, ending at K
            assert [r[0] for r in ranges] == [0] + [r[1] for r in ranges[:-1]]
            assert all(k1 > k0 for k0, k1 in ranges) and ranges[-1][1] == K
        if S > 1:
            assert tiles * S * bm * bn <= ws and tiles <= counters
    # the lowering fills the grid where the work allows it
    items = [-(-batch * int(p["t_in"]) // int(p["bm"]))
             * -(-int(p["c_out"]) // int(p["bn"])) * int(p["splits"])
             for p in gemms]
    if batch >= 16:
        assert np.median(items) >= GRID / 2


def _tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest, ties away
    from zero (on the magnitude bits)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tensor_core_product(a, w, three):
    """[M, K] x [K, N] as segment.cu's GEMM forms it: k8 steps of
    mma.sync with f32 accumulation; `three`: lo*hi + hi*lo + hi*hi of the
    TF32 split x = hi + lo (3xTF32), else hi*hi (plain TF32)."""
    ah, wh = _tf32(a), _tf32(w)
    al, wl = _tf32(a - ah), _tf32(w - wh)
    pairs = ((al, wh), (ah, wl), (ah, wh)) if three else ((ah, wh),)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in pairs:
            acc = acc + x[:, k0:k0 + 8] @ y[k0:k0 + 8]
    return acc


@pytest.mark.parametrize("K", [96, 768, 1536])
def test_3xtf32_stays_far_inside_the_frame_tolerance(K):
    """At the flagship's scales (unit activations, weights of variance
    1/K, K up to 1536), 3xTF32 keeps its error against float64 at the
    level of an f32 product (~1e-6), twenty times under FRAME_TOL by
    chip_smoke.py's measure (largest |difference| over the largest |value|,
    at least 1); plain TF32 does not meet the tolerance at all."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((64, K)).astype(np.float32)
    w = (rng.standard_normal((K, 64)) / np.sqrt(K)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    scale = max(1.0, float(np.abs(ref).max()))

    def err(y):
        return float(np.abs(y - ref).max()) / scale

    assert err(_tensor_core_product(a, w, True)) < FRAME_TOL / 20
    assert err(_tensor_core_product(a, w, False)) > FRAME_TOL


def _elu_kernel(x):
    """segment.cu's elu() in float32: x above 0, a degree-8 Taylor
    polynomial of expm1 on [-0.5, 0], exp(x) - 1 below."""
    x = np.asarray(x, np.float32)
    q = np.full_like(x, 1.0 / 40320.0)
    for c in (1 / 5040, 1 / 720, 1 / 120, 1 / 24, 1 / 6, 0.5, 1.0):
        q = (q * x + np.float32(c)).astype(np.float32)
    small = (q * x).astype(np.float32)
    large = (np.exp(x) - np.float32(1)).astype(np.float32)
    return np.where(x > 0, x, np.where(x > -0.5, small, large))


@pytest.mark.parametrize("lo,hi", [(-1e-6, 0.0), (-0.5, 0.0), (-0.6, -0.4),
                                   (-20.0, -0.5), (0.0, 10.0)])
def test_kernel_elu_matches_expm1(lo, hi):
    """The frame kernels' ELU keeps expm1's relative accuracy (a few f32
    ulps) on each side of the switch at -0.5 and near 0, where exp(x) - 1
    alone would lose every digit."""
    x = np.linspace(lo, hi, 20001).astype(np.float32)
    ref = np.where(x > 0, x.astype(np.float64),
                   np.expm1(x.astype(np.float64)))
    got = _elu_kernel(x).astype(np.float64)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    assert rel.max() < 4e-7
