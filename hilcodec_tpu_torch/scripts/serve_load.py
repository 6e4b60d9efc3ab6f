"""Load generator for the port's server: N concurrent real-time client
streams (the port's copy of the JAX package's numpy-only
`scripts/serve_load.py`).

Each client paces hop-sized int16 PCM frames at the real-time frame period
(hop / sr seconds; --rate 0 = as fast as possible), measures per-frame
round-trip latency, and the script prints one JSON line with aggregate
throughput and latency percentiles.

Usage:
  python -m hilcodec_tpu_torch.serve -c configs/hilcodec_speech.yaml \\
      --port 7654 &
  python -m hilcodec_tpu_torch.scripts.serve_load --port 7654 \\
      --clients 16 --frames 300
"""

import argparse
import asyncio
import json
import struct
import time

import numpy as np

_LEN = struct.Struct("<I")


async def _client(port: int, frames: int, hop: int, period: float,
                  seed: int):
    rng = np.random.default_rng(seed)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b'{"mode": "auto"}\n')
    hdr = json.loads((await reader.readline()).decode())
    if not hdr.get("ok"):
        raise RuntimeError(hdr)
    hop = hdr["hop"]
    # speech-like band-limited noise, int16 on the wire
    pcm = (rng.standard_normal(frames * hop) * 3000).astype(np.int16)
    lat = []
    next_t = time.perf_counter()
    try:
        for i in range(frames):
            if period > 0:
                now = time.perf_counter()
                if now < next_t:
                    await asyncio.sleep(next_t - now)
                next_t += period
            payload = pcm[i * hop:(i + 1) * hop].tobytes()
            t0 = time.perf_counter()
            writer.write(_LEN.pack(len(payload)) + payload)
            await writer.drain()
            (ln,) = _LEN.unpack(await reader.readexactly(4))
            await reader.readexactly(ln)
            lat.append(time.perf_counter() - t0)
    finally:
        writer.close()
    return np.asarray(lat)


async def run(ns) -> dict:
    """Drive the clients; print and return the JSON line."""
    t0 = time.perf_counter()
    results = await asyncio.gather(*[
        _client(ns.port, ns.frames, ns.hop,
                0.0 if ns.rate == 0 else ns.hop / ns.sr / ns.rate,
                seed=1000 + i)
        for i in range(ns.clients)])
    wall = time.perf_counter() - t0
    lat = np.concatenate(results) * 1e3
    total_frames = ns.clients * ns.frames
    audio_s = total_frames * ns.hop / ns.sr
    out = {
        "metric": "serving_latency_ms",
        "clients": ns.clients,
        "frames_per_client": ns.frames,
        "paced_x_realtime": ns.rate,
        "p50_ms": round(float(np.percentile(lat, 50)), 3),
        "p95_ms": round(float(np.percentile(lat, 95)), 3),
        "p99_ms": round(float(np.percentile(lat, 99)), 3),
        "max_ms": round(float(lat.max()), 3),
        "deadline_ms": round(ns.hop / ns.sr * 1e3, 2),
        "deadline_misses": int((lat > ns.hop / ns.sr * 1e3).sum()),
        "aggregate_x_realtime": round(audio_s / wall, 3),
    }
    print(json.dumps(out), flush=True)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m hilcodec_tpu_torch.scripts.serve_load")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--hop", type=int, default=320)
    p.add_argument("--sr", type=int, default=24000)
    p.add_argument("--rate", type=float, default=1.0,
                   help="pacing in x real-time per client; 0 = unpaced "
                        "(throughput mode)")
    return p.parse_args(argv)


def main(argv=None):
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
