"""The arithmetic the metric readers share: rates over whole windows, a
tail over every sample, shares of the profiled interval, counts of
device kernels, and a kernel's time per call."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence


def rate(rec: Dict, work_key: str) -> Optional[float]:
    """All the work of the unprofiled window over all its wall time."""
    if work_key not in rec or not rec.get("wall_s"):
        return None
    return rec[work_key] / rec["wall_s"]


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def idle_pct(rec: Dict) -> Optional[float]:
    """The share of the profiled interval with no device operation."""
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def kernels_per_unit(rec: Dict) -> Optional[float]:
    """Device kernels launched in the profiled interval per unit of work
    launched in it (frame step, tick or train step)."""
    tr = rec.get("trace")
    if tr is None or not tr.window_kernels() \
            or not rec.get("units_profiled"):
        return None
    return len(tr.window_kernels()) / rec["units_profiled"]


def mfu_pct(rec: Dict) -> Optional[float]:
    """The reference's FLOPs for the units done in the unprofiled window,
    over its wall time, over the card's peak for the cell's precision."""
    if rec.get("peaks") is None or "flops_per_unit" not in rec \
            or not rec.get("wall_s"):
        return None
    peak = rec["peaks"]["bf16" if rec.get("precision") == "bf16" else "f32"]
    return 100.0 * rec["flops_per_unit"] * rec["units"] / rec["wall_s"] / peak


def frame_kernel_calls(rec: Dict, span: str) -> List[float]:
    """Device seconds of each call of the frame kernel (`segment_kernel`)
    launched inside the host span `span` (`encode_stream`: K4,
    `decode_stream`: K3). Where the trace links no launch to its kernel,
    the calls are told apart by order: each chunk runs its encoder's
    `chunk_frames` calls, then its decoder's."""
    tr = rec.get("trace")
    if tr is None:
        return []
    calls = sorted((op for op in tr.kernels() if "segment_kernel" in op[0]),
                   key=lambda op: op[1])
    linked = [op for op in calls if op[4] in tr.launch_us]
    if linked:
        return [op[2] * 1e-6 for op in calls if tr.launched_in(op, span)]
    F = rec.get("chunk_frames")
    if not F:
        return []
    first = 0 if span == "encode_stream" else 1
    return [op[2] * 1e-6 for i, op in enumerate(calls)
            if (i // F) % 2 == first]


def roofline_pct(rec: Dict, span: str, work_key: str) -> Optional[float]:
    """A frame kernel's least time (the larger of its FLOPs over the
    peak and its least bytes over HBM's) over its mean device time a
    call."""
    calls = frame_kernel_calls(rec, span)
    if not calls or rec.get("peaks") is None or work_key not in rec:
        return None
    flops, nbytes = rec[work_key]
    pk = rec["peaks"]
    least = max(flops / pk["bf16" if rec.get("precision") == "bf16"
                            else "f32"], nbytes / pk["hbm"])
    return 100.0 * least / (sum(calls) / len(calls))
