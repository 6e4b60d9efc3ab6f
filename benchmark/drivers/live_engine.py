"""Live serving: an open loop of listeners on the port's slot engine.

`SlotEngine(mode=...)` is driven in-process; the benchmark owns the
ticks, as `CodecServer._tick_loop` does, without sockets. Each loop
turn submits every frame now due, runs one tick (`collect`, `run`) while
any are pending, and stamps each reply as it reaches the host.

Traffic: `slots` lanes, each a listener receiving one frame every hop /
24000 s from its own phase; a lane plays sessions one after another,
each log-uniform `session_s` long, and when one ends its slot detaches
and the next session attaches (a reset). In `decode` mode a frame is
`n_q` tokens, uniform over the codebook. Every draw comes from the seed
before the window; the schedule does not depend on the system's speed.
A frame due in the window that is not answered `drain_s` after its
close is missing. A traced run profiles the last `profile_s` of the
window.

Check parameters: sample_sessions, the sessions the reference decodes
whole from their first frame (the longest among them).

Records: latency_s (every frame due in the window), late_s (submit -
due), the engine's stats over the unprofiled window, ticks profiled,
attempted (frames due), failed (missing).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import common
from ..reference import codec_ref
from ..trace import Profiled
from . import port


def schedule(seed: int, lanes: int, seconds: float, frame_s: float,
             session_s, n_q: int, codes: int) -> Dict[str, Any]:
    """Every session of every lane that starts in the window: its lane,
    first due time and tokens [frames, n_q]."""
    rng = np.random.default_rng(common.sub_seed(seed, 3))
    lo, hi = np.log(session_s[0]), np.log(session_s[1])
    sessions = []
    for lane in range(lanes):
        t = 0.0
        while t < seconds:
            n = max(1, int(round(np.exp(rng.uniform(lo, hi)) / frame_s)))
            start = t + rng.uniform(0.0, frame_s)
            sessions.append({"lane": lane, "start": start,
                             "tokens": rng.integers(0, codes, (n, n_q))})
            t = start + n * frame_s
    return {"sessions": sessions, "rng": rng}


def setup(cell: common.Cell) -> Dict[str, Any]:
    from hilcodec_tpu_torch.serve.engine import SlotEngine
    tr, dev = cell.traffic, cell.device
    model = port.codec_model(cell.config, dev)
    ref = codec_ref.build(cell.config, "cpu")
    params, books = codec_ref.make_weights(ref, common.sub_seed(cell.seed, 0))
    dtype = torch.bfloat16 if cell.precision == "bf16" else torch.float32
    S = tr["slots"]
    engine = SlotEngine(model, params, {"embed": books.to(dev)}, slots=S,
                        mode=tr["mode"], dtype=dtype, devices=[dev])
    n_q, codes = model.vq.num_quantizers, model.vq.codebook_size
    # warm-up: every slot attached (a reset) and active, then active alone
    engine.warmup()
    slots = [engine.attach() for _ in range(S)]
    for _ in range(2):
        for s in slots:
            engine.submit(s, np.zeros(n_q, np.int16))
        engine.tick()
    for s in slots:
        engine.detach(s)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for k in engine.stats:
        engine.stats[k] = 0 if k in ("ticks", "frames") else 0.0
    frame_s = model.hop_length / common.SAMPLE_RATE
    plan = schedule(cell.seed, S, cell.seconds, frame_s, tr["session_s"],
                    n_q, codes)
    return dict(cell=cell, engine=engine, frame_s=frame_s, plan=plan)


def _sample(plan, seconds: float, frame_s: float, k: int) -> List[int]:
    """The sessions the reference checks: the one with most frames due
    in the window, and k - 1 others drawn from the seed."""
    ses = plan["sessions"]
    due = [min(len(s["tokens"]),
               max(0, int(np.ceil((seconds - s["start"]) / frame_s))))
           for s in ses]
    live = [i for i, d in enumerate(due) if d > 0]
    longest = max(live, key=lambda i: due[i])
    rest = [i for i in live if i != longest]
    pick = plan["rng"].choice(len(rest), min(k - 1, len(rest)),
                              replace=False)
    return [longest] + [rest[j] for j in pick]


def window(st: Dict[str, Any]) -> Dict[str, Any]:
    cell, eng = st["cell"], st["engine"]
    tr, seconds, frame_s = cell.traffic, cell.seconds, st["frame_s"]
    ses = st["plan"]["sessions"]
    # every frame due in the window, in due order
    frames = [(s["start"] + j * frame_s, i, j)
              for i, s in enumerate(ses) for j in range(len(s["tokens"]))
              if s["start"] + j * frame_s < seconds]
    frames.sort()
    due = np.array([f[0] for f in frames])
    fid = {(i, j): n for n, (_, i, j) in enumerate(frames)}
    last = {}
    for _, i, j in frames:
        last[i] = max(last.get(i, -1), j)
    N = len(frames)
    submit_t = np.full(N, np.nan)
    reply_t = np.full(N, np.nan)
    sample = set(_sample(st["plan"], seconds, frame_s,
                         cell.check.get("sample_sessions", 12)))
    pcm = {i: {} for i in sample}
    lane_q: Dict[int, List[int]] = {}      # lane -> frame ids waiting
    lane_ses: Dict[int, int] = {}          # lane -> attached session
    slot_of: Dict[int, int] = {}           # session -> slot
    ses_of: Dict[int, int] = {}            # slot -> session
    prof_at = seconds - tr["profile_s"] if cell.trace else None
    prof = None
    stats0 = None
    ptr, ticks_prof = 0, 0

    def pump(lane: int, now: float) -> None:
        q = lane_q.get(lane)
        while q:
            _, i, j = frames[q[0]]
            if lane_ses.get(lane) is None:
                lane_ses[lane] = i
                slot = eng.attach()
                slot_of[i], ses_of[slot] = slot, i
            if lane_ses[lane] != i:
                return
            eng.submit(slot_of[i], ses[i]["tokens"][j])
            submit_t[q.pop(0)] = now

    t0 = time.perf_counter()
    deadline = seconds + tr["drain_s"]
    while True:
        now = time.perf_counter() - t0
        if prof_at is not None and prof is None and now >= prof_at:
            stats0 = dict(eng.stats)
            prof = Profiled(cell.device).__enter__()
        if prof is not None and prof.data is None and now >= seconds:
            prof.__exit__(None, None, None)
        with torch.profiler.record_function("loadgen.submit"):
            touched = set()
            while ptr < N and due[ptr] <= now:
                lane = ses[frames[ptr][1]]["lane"]
                lane_q.setdefault(lane, []).append(ptr)
                touched.add(lane)
                ptr += 1
            for lane in touched:
                pump(lane, now)
        if eng.pending():
            with torch.profiler.record_function("engine.collect"):
                batch = eng.collect()
            with torch.profiler.record_function("engine.run"):
                out = eng.run(batch)
            t_rep = time.perf_counter() - t0
            if prof is not None and prof.data is None:
                ticks_prof += 1
            freed = []
            for slot, r in out.items():
                i, j = ses_of[slot], int(r["seq"])
                reply_t[fid[(i, j)]] = t_rep
                if i in pcm:
                    pcm[i][j] = np.array(r["pcm"], copy=True)
                if j == last[i]:
                    eng.detach(slot)
                    lane = ses[i]["lane"]
                    del ses_of[slot], slot_of[i]
                    lane_ses[lane] = None
                    freed.append(lane)
            for lane in freed:
                pump(lane, t_rep)
        else:
            if ptr >= N and not any(lane_q.values()):
                break
            if ptr < N:
                wait = due[ptr] - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.002))
        if now > deadline:
            break
    if prof is not None and prof.data is None:
        prof.__exit__(None, None, None)
    end = time.perf_counter() - t0
    answered = ~np.isnan(reply_t)
    lat = np.where(answered, reply_t - due, end - due)
    # a traced run's lateness is read over the unprofiled window
    sub = ~np.isnan(submit_t) & (due < (prof_at if prof_at is not None
                                        else seconds))
    st["pcm"], st["sample"] = pcm, sorted(sample)
    eng_stats = dict(stats0 if stats0 is not None else eng.stats)
    ticks = max(eng.stats["ticks"], 1)
    head, tail = due < 2.0, due >= seconds - 2.0
    print(f"live: slots {tr['slots']}, frames due {N}, answered "
          f"{int(answered.sum())}, ticks {eng.stats['ticks']}, tick "
          f"{1e3 * eng.stats['tick_s_sum'] / ticks:.3f} ms, frames/tick "
          f"{eng.stats['frames'] / ticks:.2f}, latency p50 / p95 "
          f"{1e3 * np.median(lat):.2f} / {1e3 * np.percentile(lat, 95):.2f} ms"
          f", p50 first / last 2 s {1e3 * np.median(lat[head]):.2f} / "
          f"{1e3 * np.median(lat[tail]):.2f} ms", file=sys.stderr)
    rec = {"latency_s": lat.tolist(),
           "late_s": (submit_t[sub] - due[sub]).tolist(),
           "engine_stats": eng_stats, "attempted": N,
           "failed": int((~answered).sum()), "precision": cell.precision}
    if prof is not None:
        rec["trace"], rec["units_profiled"] = prof.data, ticks_prof
        print(f"live: profiled {prof.data.window_s:.3f} s, {ticks_prof} "
              f"ticks", file=sys.stderr)
    return rec


def work(st: Dict[str, Any]) -> Dict[str, Any]:
    return {}


def release(st: Dict[str, Any]) -> None:
    st.pop("engine", None)


def check(st: Dict[str, Any], rec: Dict[str, Any]) -> Dict[str, Any]:
    """Each sampled session's PCM, frame by frame as answered, against
    the offline decode of its tokens from a zero start."""
    cell = st["cell"]
    dev = cell.device
    ref = codec_ref.build(cell.config, dev)
    params, books = codec_ref.folded_weights(
        ref, common.sub_seed(cell.seed, 0), dev)
    err, missing = 0.0, 0
    ses = st["plan"]["sessions"]
    with torch.no_grad():
        for i in st["sample"]:
            got = st["pcm"][i]
            n = len(got)
            if n == 0 or sorted(got) != list(range(n)):
                missing += 1
                continue
            tokens = torch.from_numpy(ses[i]["tokens"][:n].T.copy()).to(dev)
            pcm16 = torch.from_numpy(np.concatenate([got[j]
                                                     for j in range(n)]))
            err = max(err, codec_ref.pcm_error(ref, params, books, tokens,
                                               pcm16.to(dev)))
    lim = cell.check.get("limits", {})
    return {"pcm_err_steps": (err, lim.get("pcm_err_steps")),
            "sessions_unchecked": (float(missing), 0.0)}
