"""Bulk streaming of Mimi: S continuous streams coded chunk after chunk
through the port's `MimiCodecModel.encode_stream` then `decode_stream`
(the plain drivers; Mimi has no frame kernels), caches carried, tokens
and int16 PCM copied to the host one chunk behind.

The window, its chunk loop, the host copies and the profiled sub-window
are `bulk_stream`'s, imported as they are; this module builds the model
and its weights (`reference/mimi_ref.make_weights`: seeded weights,
LayerScale gains from U(0.5, 1.5), codebooks drawn from the reference's
projected latents of a seeded clip), counts the work, and checks the
sampled streams against `reference/mimi_ref.py`'s whole-sequence
forward. A stream runs past `context` positions of the transformers
(10 s at 25 Hz) well inside a window, so the check covers the rings after
they wrap.

Traffic parameters: as `bulk_stream` (streams, chunk_frames, megakernel
false, pool_chunks, profile_chunks). Check parameters: sample_streams.

Records: as `bulk_stream`; `work` adds the reference's FLOPs a frame
step and one attention call's FLOPs and bytes (`attn_work`).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import common
from ..reference import mimi_ref
from . import bulk_stream

window = bulk_stream.window
release = bulk_stream.release


def setup(cell: common.Cell) -> Dict[str, Any]:
    from hilcodec_tpu_torch.models.codec import cast_streaming_params
    from hilcodec_tpu_torch.models.mimi import build_mimi
    tr, dev = cell.traffic, cell.device
    t0 = time.perf_counter()
    model = build_mimi(cell.config["model_kwargs"], dev)
    weights = mimi_ref.make_weights(cell.config,
                                    common.sub_seed(cell.seed, 0), dev)
    params, vq_state = weights
    dtype = torch.float32
    if cell.precision == "bf16":
        params = cast_streaming_params(params, torch.bfloat16,
                                       kernels_only=False)
        dtype = torch.bfloat16
    S, F, hop = tr["streams"], tr["chunk_frames"], model.hop_length
    P = tr["pool_chunks"]
    t1 = time.perf_counter()
    gen = common.device_generator(dev, common.sub_seed(cell.seed, 1))
    pool = common.speech_band(gen, P * S, F * hop, dev).view(P, S, 1, F * hop)
    rng = np.random.default_rng(common.sub_seed(cell.seed, 2))
    n_sample = min(cell.check.get("sample_streams", 8), S)
    st = dict(cell=cell, model=model, params=params, vq_state=vq_state,
              weights=weights, dtype=dtype, pool=pool, S=S, F=F, hop=hop,
              rows=np.sort(rng.choice(S, n_sample, replace=False)))
    pinned = dev.type == "cuda"
    n_q = model.vq.num_quantizers
    st["ring"] = [(torch.empty((n_q, S, F), dtype=torch.int16,
                               pin_memory=pinned),
                   torch.empty((S, 1, F * hop), dtype=torch.int16,
                               pin_memory=pinned)) for _ in range(3)]
    bulk_stream._sync(dev)
    t2 = time.perf_counter()
    st["caches"] = model.init_cache(S, dtype)
    bulk_stream._collect(st, bulk_stream._dispatch(st, 0), keep=False)
    st["caches"] = model.init_cache(S, dtype)
    bulk_stream._sync(dev)
    print(f"mimi setup: {t1 - t0:.3f} s model and weights, "
          f"{t2 - t1:.3f} s audio pool, {time.perf_counter() - t2:.3f} s "
          f"warm-up chunk", file=sys.stderr)
    return st


def work(st: Dict[str, Any]) -> Dict[str, Any]:
    cfg = st["cell"].config["model_kwargs"]
    return {"flops_per_unit": mimi_ref.frame_step_flops(cfg, st["S"]),
            "attn_work": mimi_ref.attention_call_work(cfg, st["S"])}


def check(st: Dict[str, Any], rec: Dict[str, Any]) -> Dict[str, Any]:
    """The reference over each sampled stream's whole input, on the
    weights the program ran (f32), one stream at a time."""
    cell = st["cell"]
    dev = cell.device
    params, state = st["weights"]
    cfg = cell.config["model_kwargs"]
    P, K = cell.traffic["pool_chunks"], st["chunks"]
    toks = np.concatenate(st["kept_tok"], axis=-1)     # [n_q, n, K*F]
    pcms = np.concatenate(st["kept_pcm"], axis=-1)     # [n, K*F*hop]
    gap, err = 0.0, 0.0
    for i in range(len(st["rows"])):
        wav = torch.cat([st["inputs"][k % P, i, 0] for k in range(K)])
        g, e = mimi_ref.check_stream(
            params, state, cfg, wav.to(dev),
            torch.from_numpy(toks[:, i].astype(np.int64)).to(dev),
            torch.from_numpy(pcms[i]).to(dev))
        gap, err = max(gap, g), max(err, e)
    lim = cell.check.get("limits", {})
    print(f"mimi check: {len(st['rows'])} streams of {K * st['F']} frames "
          f"({K * st['F'] * st['hop'] / common.SAMPLE_RATE:.1f} s)",
          file=sys.stderr)
    return {"token_gap": (gap, lim.get("token_gap")),
            "pcm_err_steps": (err, lim.get("pcm_err_steps"))}
