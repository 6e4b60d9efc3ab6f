"""The arithmetic of the readers that read the program's own spans and
counters (`hilcodec_tpu_torch/utils/spans.py`, `SlotEngine.stats`,
`ops/cuda_build.load_record`).

A set of spans is read as the union of its intervals inside the profiled
window. A device operation belongs to it when the host launched the
operation inside that union (and inside the window); an idle gap, for
the part of it that the union covers. A program without the spans (or
the counters) reads as nothing: each function then returns None.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

Intervals = List[Tuple[float, float]]
# the train step's optimizer half: AdamP's per-leaf updates of both sides
# and the discriminators' power iteration
OPTIMIZER_SPANS = ("train.optim_g", "train.optim_d", "train.spectral_norm")


def union(tr, names: Iterable[str]) -> Intervals:
    """The union of the intervals of the host spans named in `names`,
    clipped to the window, as sorted disjoint (start, end) in us."""
    names = set(names)
    lo, hi = tr.window
    ivs = sorted((max(ts, lo), min(ts + dur, hi))
                 for name, ts, dur in tr.spans if name in names)
    merged: List[List[float]] = []
    for s, e in ivs:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _covers(ivs: Intervals, starts: List[float], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ivs[i][1]


def launched_in(tr, names: Iterable[str], kernels_only: bool = False
                ) -> Optional[list]:
    """The device operations (kernels alone with `kernels_only`) launched
    inside the spans `names` in the window; None when the window holds
    no such span or no device operation. An operation whose launch the
    trace does not link to it is in no span."""
    ivs = union(tr, names)
    if not ivs or not tr.ops:
        return None
    starts = [s for s, _ in ivs]
    ops = tr.kernels() if kernels_only else tr.ops
    return [op for op in ops if op[4] in tr.launch_us
            and _covers(ivs, starts, tr.launch_us[op[4]])]


def _units(rec: Dict):
    tr = rec.get("trace")
    return (tr, rec["units_profiled"]) if tr is not None \
        and rec.get("units_profiled") else (None, None)


def device_ms_per_unit(rec: Dict, names: Iterable[str]) -> Optional[float]:
    """Device ms of the operations launched inside the spans `names`, per
    unit of work profiled."""
    tr, units = _units(rec)
    ops = None if tr is None else launched_in(tr, names)
    if ops is None:
        return None
    return 1e-3 * sum(op[2] for op in ops) / units


def kernels_per_unit(rec: Dict, names: Iterable[str]) -> Optional[float]:
    """Device kernels launched inside the spans `names`, per unit of work
    profiled."""
    tr, units = _units(rec)
    ops = None if tr is None else launched_in(tr, names, kernels_only=True)
    return None if ops is None else len(ops) / units


def overlap_us(a: Intervals, b: Intervals) -> float:
    """The length in us of the intersection of two sorted disjoint
    interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct_in(rec: Dict, names: Iterable[str]) -> Optional[float]:
    """The share of the profiled interval with no device operation while
    the host is inside the spans `names`: the window's gaps intersected
    with the spans' union."""
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    ivs = union(tr, names)
    if not ivs:
        return None
    return 100.0 * overlap_us(tr.gaps(), ivs) * 1e-6 / tr.window_s


def per_frame(rec: Dict, key: str, scale: float) -> Optional[float]:
    """`scale` x the engine counter `key` over the frames it collected,
    in the unprofiled window."""
    st = rec.get("engine_stats")
    if not st or key not in st or not st.get("frames"):
        return None
    return scale * st[key] / st["frames"]


def native_record() -> Optional[Dict[str, Dict]]:
    """The port's record of its native libraries' loads in this process
    (`ops/cuda_build.load_record`), or None where the port keeps none."""
    from hilcodec_tpu_torch.ops import cuda_build
    reader = getattr(cuda_build, "load_record", None)
    return None if reader is None else reader()


def native_s(record: Optional[Dict[str, Dict]]) -> Optional[float]:
    """Seconds spent building and loading the libraries of `record`."""
    if record is None:
        return None
    return sum((v["compile_s"] + v["load_s"] for v in record.values()), 0.0)
