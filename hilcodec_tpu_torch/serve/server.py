"""Asyncio TCP front-end for the slot-batched serving engine.

Counterpart of `hilcodec_tpu/serve/server.py`, with the same wire protocol
(little-endian, deliberately trivial):

  1. client -> server: one JSON line, e.g. {"mode": "roundtrip"}.
     "mode" must match the server's engine mode (or be omitted/"auto").
  2. server -> client: one JSON line
     {"ok": true, "slot": k, "hop": 320, "n_q": 8, "sr": 24000}
     or {"ok": false, "error": "..."} and close.
  3. frames, both directions: u32 length prefix + payload.
       client payload:  encode/roundtrip = hop x int16 PCM;
                        decode           = n_q x int16 tokens.
       server payload:  encode    = n_q x int16 tokens;
                        decode    = hop x int16 PCM;
                        roundtrip = n_q int16 tokens || hop int16 PCM.
     Responses come back in order, one per input frame.
  4. client closes -> slot freed (the next occupant's masked reset wipes
     any residual stream state).

One background task owns the tick loop: it snapshots work on the event
loop thread (engine.collect), runs the frame step in a worker thread
(so socket reads continue during device execution), and writes replies.
"""

from __future__ import annotations

import asyncio
import json
import struct
from typing import Dict, Optional

import numpy as np

from .engine import SlotEngine

_LEN = struct.Struct("<I")


async def _read_frame(reader: asyncio.StreamReader) -> Optional[bytes]:
    try:
        head = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (ln,) = _LEN.unpack(head)
    if ln > 1 << 20:
        raise ValueError(f"frame length {ln} over 1 MiB")
    try:
        return await reader.readexactly(ln)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None


def _write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(_LEN.pack(len(payload)) + payload)


class CodecServer:
    """TCP server mapping client connections onto engine slots."""

    def __init__(self, engine: SlotEngine, sr: int,
                 host: str = "127.0.0.1", port: int = 0,
                 gather_ms: float = 0.0):
        """gather_ms > 0 micro-batches: after the first frame wakes the
        tick loop, wait this long for more slots' frames to arrive before
        running the step. Raises the latency floor by gather_ms but lifts
        per-tick occupancy — at high client counts each tick costs the
        full S-slot program regardless of how many rows are active, so
        amortizing it over more active slots is the throughput knob."""
        self.engine = engine
        self.sr = sr
        self.host, self.port = host, port
        self.gather_s = gather_ms / 1e3
        self._server: Optional[asyncio.AbstractServer] = None
        self._wake = asyncio.Event()
        self._writers: Dict[int, asyncio.StreamWriter] = {}
        self._inflight: Dict[int, int] = {}   # frames submitted - replied
        self._tick_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._tick_task = asyncio.create_task(self._tick_loop())

    async def stop(self) -> None:
        if self._tick_task:
            self._tick_task.cancel()
            try:
                await self._tick_task
            except asyncio.CancelledError:
                pass
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------ tick loop

    async def _tick_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._wake.wait()
            self._wake.clear()
            if self.gather_s > 0:
                await asyncio.sleep(self.gather_s)
            while True:
                batch = self.engine.collect()
                if batch is None:
                    break
                try:
                    out = await loop.run_in_executor(None, self.engine.run,
                                                     batch)
                except Exception:
                    # one bad batch must not kill the tick loop (every
                    # stream would hang); drop it, rebuild the caches,
                    # and zero the inflight counters the dropped batch
                    # will never answer
                    import traceback
                    traceback.print_exc()
                    self.engine.recover()
                    for slot in batch.active:
                        if slot in self._inflight:
                            self._inflight[slot] = 0
                    continue
                for slot, res in out.items():
                    if slot in self._inflight:
                        self._inflight[slot] -= 1
                    w = self._writers.get(slot)
                    if w is None or w.is_closing():
                        continue
                    if self.engine.mode == "roundtrip":
                        payload = (res["tokens"].tobytes()
                                   + res["pcm"].tobytes())
                    elif self.engine.mode == "encode":
                        payload = res["tokens"].tobytes()
                    else:
                        payload = res["pcm"].tobytes()
                    _write_frame(w, payload)
                for w in {self._writers[s] for s in out
                          if s in self._writers}:
                    try:
                        await w.drain()
                    except ConnectionResetError:
                        pass

    # ----------------------------------------------------------- connection

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        eng = self.engine
        try:
            hello = json.loads((await reader.readline()).decode())
        except Exception:
            writer.close()
            return
        mode = hello.get("mode", "auto")
        if mode == "stats":
            st = dict(eng.stats)
            n = max(st.get("ticks", 0), 1)
            st["tick_ms_mean"] = round(st.pop("tick_s_sum", 0.0) / n * 1e3, 3)
            st["tick_ms_max"] = round(st.pop("tick_s_max", 0.0) * 1e3, 3)
            for k in ("up", "dispatch", "fetch", "collect"):
                st[f"{k}_ms_mean"] = round(
                    st.pop(f"{k}_s_sum", 0.0) / n * 1e3, 3)
            st["wait_ms_mean"] = round(st.pop("wait_s_sum", 0.0)
                                       / max(st.get("frames", 0), 1) * 1e3, 3)
            st["ok"] = True
            writer.write(json.dumps(st).encode() + b"\n")
            await writer.drain()
            writer.close()
            return
        if mode not in ("auto", eng.mode):
            writer.write(json.dumps(
                {"ok": False,
                 "error": f"server mode is {eng.mode!r}"}).encode() + b"\n")
            await writer.drain()
            writer.close()
            return
        try:
            slot = eng.attach()
        except RuntimeError as e:
            writer.write(json.dumps(
                {"ok": False, "error": str(e)}).encode() + b"\n")
            await writer.drain()
            writer.close()
            return
        self._writers[slot] = writer
        self._inflight[slot] = 0
        writer.write(json.dumps(
            {"ok": True, "slot": slot, "hop": eng.hop, "n_q": eng.n_q,
             "sr": self.sr, "mode": eng.mode}).encode() + b"\n")
        await writer.drain()
        try:
            need = 2 * (eng.n_q if eng.mode == "decode" else eng.hop)
            while True:
                payload = await _read_frame(reader)
                if payload is None:
                    break
                # exact length required: a short frame would broadcast-fail
                # inside the tick loop and stall every other stream
                if len(payload) != need:
                    _write_frame(writer, json.dumps(
                        {"ok": False,
                         "error": f"frame payload must be {need} bytes, "
                                  f"got {len(payload)}"}).encode())
                    break
                # wire format == engine format (int16): zero host conversion
                eng.submit(slot, np.frombuffer(payload, np.int16))
                self._inflight[slot] += 1
                self._wake.set()
            # graceful close: let queued frames drain before detaching
            while self._inflight.get(slot, 0) > 0:
                self._wake.set()
                await asyncio.sleep(0.005)
        finally:
            self._writers.pop(slot, None)
            self._inflight.pop(slot, None)
            eng.detach(slot)
            try:
                writer.close()
            except Exception:
                pass


async def serve_forever(engine: SlotEngine, sr: int, host: str,
                        port: int, gather_ms: float = 0.0) -> None:
    srv = CodecServer(engine, sr, host, port, gather_ms=gather_ms)
    await srv.start()
    print(f"serving mode={engine.mode} slots={engine.slots} "
          f"n_q={engine.n_q} on {srv.host}:{srv.port}", flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await srv.stop()
