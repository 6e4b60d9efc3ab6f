"""Bulk streaming: S continuous streams coded chunk after chunk.

The window dispatches chunks of `chunk_frames` frames a stream through
the port's `CodecModel.encode_stream` then `decode_stream` (the frame
kernels with `megakernel`), carrying the caches from chunk to chunk.
Each chunk's tokens and int16 PCM are copied to the host, and dispatch
runs one chunk ahead of the copy. The audio is speech-band noise made on
the card from the seed: a pool of `pool_chunks` chunks a stream, chunk k
of the window being pool entry k mod `pool_chunks`.

Traffic parameters: streams, chunk_frames, megakernel, pool_chunks,
profile_chunks (the chunks a traced run profiles, after the rest of
the window; its profiled interval opens once one more chunk is in
flight). Check parameters (`workloads/<cell>.json`): sample_streams,
the streams the reference checks, drawn from the seed, whole.

Records: audio_s / wall_s / units (frame steps) of the unprofiled
window, units_profiled, attempted (frames a stream, summed), failed, the
trace, and from `work` the reference's FLOPs a frame step and the least
time of each frame kernel.
"""

from __future__ import annotations

import collections
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import common
from ..reference import codec_ref
from ..trace import Profiled
from . import port


def setup(cell: common.Cell) -> Dict[str, Any]:
    tr, dev = cell.traffic, cell.device
    t0 = time.perf_counter()
    model = port.codec_model(cell.config, dev)
    ref = codec_ref.build(cell.config, "cpu")
    params, books = codec_ref.make_weights(ref, common.sub_seed(cell.seed, 0))
    params, vq_state, dtype = port.stream_params(model, params, books,
                                                 cell.precision, dev)
    S, F, hop = tr["streams"], tr["chunk_frames"], model.hop_length
    P = tr["pool_chunks"]
    t1 = time.perf_counter()
    gen = common.device_generator(dev, common.sub_seed(cell.seed, 1))
    pool = common.speech_band(gen, P * S, F * hop, dev).view(P, S, 1, F * hop)
    rng = np.random.default_rng(common.sub_seed(cell.seed, 2))
    n_sample = min(cell.check.get("sample_streams", 8), S)
    st = dict(cell=cell, model=model, params=params, vq_state=vq_state,
              dtype=dtype, pool=pool, S=S, F=F, hop=hop,
              rows=np.sort(rng.choice(S, n_sample, replace=False)))
    pinned = dev.type == "cuda"
    n_q = model.vq.num_quantizers
    st["ring"] = [(torch.empty((n_q, S, F), dtype=torch.int16,
                               pin_memory=pinned),
                   torch.empty((S, 1, F * hop), dtype=torch.int16,
                               pin_memory=pinned)) for _ in range(3)]
    # warm-up: one chunk through every call of the window, then fresh
    # caches for the window
    _sync(dev)
    t2 = time.perf_counter()
    st["caches"] = model.init_cache(S, dtype)
    _collect(st, _dispatch(st, 0), keep=False)
    st["caches"] = model.init_cache(S, dtype)
    _sync(dev)
    print(f"bulk setup: {t1 - t0:.3f} s model and weights, "
          f"{t2 - t1:.3f} s audio pool, {time.perf_counter() - t2:.3f} s "
          f"warm-up chunk", file=sys.stderr)
    return st


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dispatch(st: Dict[str, Any], k: int):
    """Launch chunk k and its copy to the host; returns its handle."""
    m, cell = st["model"], st["cell"]
    mk = cell.traffic["megakernel"]
    wav = st["pool"][k % cell.traffic["pool_chunks"]].to(st["dtype"])
    ce, cd = st["caches"]
    with torch.profiler.record_function("encode_stream"):
        tok, ce = m.encode_stream(st["params"], st["vq_state"], wav, ce,
                                  megakernel=mk)
    with torch.profiler.record_function("decode_stream"):
        out, cd = m.decode_stream(st["params"], st["vq_state"], tok, cd,
                                  megakernel=mk)
    st["caches"] = (ce, cd)
    tok_h, pcm_h = st["ring"][k % len(st["ring"])]
    tok_h.copy_(tok.to(torch.int16), non_blocking=True)
    pcm_h.copy_(common.to_int16(out), non_blocking=True)
    ev = None
    if cell.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
    return k, tok_h, pcm_h, ev


def _collect(st: Dict[str, Any], handle, keep: bool = True) -> None:
    """Wait for a chunk's copy and keep the sampled streams' outputs."""
    k, tok_h, pcm_h, ev = handle
    if ev is not None:
        ev.synchronize()
    if keep:
        rows = st["rows"]
        st["kept_tok"].append(tok_h.numpy()[:, rows].copy())
        st["kept_pcm"].append(pcm_h.numpy()[rows, 0].copy())


def _run(st: Dict[str, Any], k0: int, until: float = None,
         chunks: int = None, after_first=None) -> int:
    """Dispatch chunks from k0 until the host clock passes `until` (or
    `chunks` chunks are done), one ahead of the copies; returns the next
    chunk index, every copy collected. `after_first` is called once the
    first chunk is dispatched."""
    pending = collections.deque()
    k = k0
    while (time.perf_counter() < until) if until is not None \
            else (k < k0 + chunks):
        pending.append(_dispatch(st, k))
        k += 1
        if k == k0 + 1 and after_first is not None:
            after_first()
        while len(pending) > 1:
            _collect(st, pending.popleft())
    while pending:
        _collect(st, pending.popleft())
    _sync(st["cell"].device)
    return k


def window(st: Dict[str, Any]) -> Dict[str, Any]:
    cell, tr = st["cell"], st["cell"].traffic
    S, F, hop = st["S"], st["F"], st["hop"]
    st["kept_tok"], st["kept_pcm"] = [], []
    prof_chunks = tr["profile_chunks"] if cell.trace else 0
    t0 = time.perf_counter()
    k = _run(st, 0, until=t0 + cell.seconds)
    wall = time.perf_counter() - t0
    rec: Dict[str, Any] = {"audio_s": k * S * F * hop / common.SAMPLE_RATE,
                           "wall_s": wall, "units": k * F,
                           "chunk_frames": F, "precision": cell.precision}
    if prof_chunks:
        # one chunk more than profiled: the window opens once the first
        # is in flight, so the device starts it busy as in the window
        # above, and counts the work launched in it
        with Profiled(cell.device, late=True) as p:
            k2 = _run(st, k, chunks=prof_chunks + 1, after_first=p.open)
        rec["trace"], rec["units_profiled"] = p.data, prof_chunks * F
        k = k2
    st["chunks"] = k
    rec["attempted"], rec["failed"] = k * F * S, 0
    return rec


def work(st: Dict[str, Any]) -> Dict[str, Any]:
    ref = codec_ref.build(st["cell"].config, "cpu")
    w = codec_ref.frame_step_work(ref, st["S"])
    return {"flops_per_unit": w["enc_flops"] + w["rvq_flops"]
            + w["dec_flops"], "k3_work": (w["dec_flops"], w["dec_bytes"]),
            "k4_work": (w["enc_flops"], w["enc_bytes"])}


def release(st: Dict[str, Any]) -> None:
    rows = torch.as_tensor(st["rows"], device=st["pool"].device)
    st["inputs"] = st["pool"][:, rows].float().cpu()   # [P, n, 1, F*hop]
    for key in ("model", "params", "vq_state", "pool", "ring", "caches"):
        st.pop(key, None)


def check(st: Dict[str, Any], rec: Dict[str, Any]) -> Dict[str, Any]:
    """The reference over each sampled stream's whole input."""
    cell = st["cell"]
    dev = cell.device
    ref = codec_ref.build(cell.config, dev)
    params, books = codec_ref.folded_weights(
        ref, common.sub_seed(cell.seed, 0), dev)
    P, K = cell.traffic["pool_chunks"], st["chunks"]
    toks = np.concatenate(st["kept_tok"], axis=-1)     # [n_q, n, K*F]
    pcms = np.concatenate(st["kept_pcm"], axis=-1)     # [n, K*F*hop]
    gap, err = 0.0, 0.0
    with torch.no_grad():
        for i in range(len(st["rows"])):
            wav = torch.cat([st["inputs"][k % P, i, 0] for k in range(K)])
            g, e = codec_ref.check_stream(
                ref, params, books, wav.to(dev),
                torch.from_numpy(toks[:, i]).to(dev),
                torch.from_numpy(pcms[i]).to(dev))
            gap, err = max(gap, g), max(err, e)
    lim = cell.check.get("limits", {})
    return {"token_gap": (gap, lim.get("token_gap")),
            "pcm_err_steps": (err, lim.get("pcm_err_steps"))}
