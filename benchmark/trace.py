"""The device trace of a traced run's profiled sub-window, read from
torch.profiler's Chrome trace.

`Profiled` wraps a stretch of the run: it synchronizes, starts the
profiler (CPU and CUDA activities) and opens the span `bench.window`
(with `late`, only when the body calls `open()`, so that a window can
start with work already in flight); on exit it synchronizes, closes the
span, stops the profiler, writes the trace to a file under `TMPDIR`,
reads it and deletes it. `TraceData`
holds what the readers need:

  * `ops`: every device operation (kernels, copies, sets) inside the
    window, as (name, start_us, dur_us, category, correlation id);
  * `spans`: the host's spans (the benchmark's `record_function` spans
    and aten operators), as (name, start_us, dur_us);
  * `launch_us`: the host time each device operation was launched at,
    by correlation id, so an operation can be placed in the span that
    launched it.

Busy time is the union of the device operations' intervals on the
timeline, never their sum: two operations that overlap count once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class TraceData:
    window: Tuple[float, float]                 # us, on the trace's clock
    ops: List[Tuple[str, float, float, str, Optional[int]]]
    spans: List[Tuple[str, float, float]]
    launch_us: Dict[int, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self) -> List[Tuple[str, float, float, str, Optional[int]]]:
        return [o for o in self.ops if o[3] == "kernel"]

    def window_kernels(self
                       ) -> List[Tuple[str, float, float, str, Optional[int]]]:
        """The kernels launched inside the window: work in flight when it
        opened runs in it (and counts as busy) but was launched before.
        A kernel whose launch the trace does not link to it is placed by
        its start."""
        lo, hi = self.window
        return [k for k in self.kernels()
                if lo <= self.launch_us.get(k[4], k[1]) <= hi]

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) in us."""
        lo, hi = self.window
        spans = sorted((max(ts, lo), min(ts + dur, hi))
                       for _, ts, dur, _, _ in self.ops)
        merged: List[List[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        """The stretches of the window with no device operation."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def host_at(self, t_us: float) -> str:
        """The innermost host span running at `t_us` (the shortest that
        covers it), other than the window itself."""
        best: Optional[Tuple[float, str]] = None
        for name, ts, dur in self.spans:
            if name != WINDOW and ts <= t_us <= ts + dur:
                if best is None or dur < best[0]:
                    best = (dur, name)
        return best[1] if best else "host outside any span"

    def launched_in(self, op, span_name: str) -> bool:
        """Whether device operation `op` was launched inside a host span
        named `span_name`."""
        t = self.launch_us.get(op[4]) if op[4] is not None else None
        if t is None:
            return False
        return any(name == span_name and ts <= t <= ts + dur
                   for name, ts, dur in self.spans)

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The `n` device operations that took most time (seconds, summed
        by name) and the `n` longest idle gaps (seconds), each named by
        the host span running at its middle."""
        by_name: Dict[str, float] = {}
        for name, _, dur, _, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[name[:200], s] for name, s in top],
                "idle_gaps": [[self.host_at((a + b) / 2)[:200],
                               (b - a) * 1e-6] for a, b in gaps]}


def parse(path: str) -> TraceData:
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    window = None
    ops, spans, launch = [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            ops.append((name, ts, dur, cat, corr))
        elif cat in HOST_CATS:
            spans.append((name, ts, dur))
            if cat == "user_annotation" and name == WINDOW:
                window = (ts, ts + dur)
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = ts
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    lo, hi = window
    ops = [o for o in ops if o[1] + o[2] > lo and o[1] < hi]
    return TraceData(window, ops, spans, launch)


def warm_up(device: torch.device) -> None:
    """Start and stop the profiler once, so that a later profiled window
    does not pay the tracer's first start (CUPTI's, about a second)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
    torch.cuda.synchronize(device)


class Profiled:
    """`with Profiled(device) as p: ...` profiles the body; `p.data` is
    its TraceData afterwards. With `late=True` the window opens at
    `p.open()`, which the body calls."""

    def __init__(self, device: torch.device, late: bool = False):
        self.device = device
        self.late = late
        self.span = None
        self.data: Optional[TraceData] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "Profiled":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        if not self.late:
            self.open()
        return self

    def open(self) -> None:
        """Open the window (the span `bench.window`)."""
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()

    def __exit__(self, *exc) -> None:
        self._sync()
        if self.span is not None:
            self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.data = parse(path)
        finally:
            os.remove(path)
