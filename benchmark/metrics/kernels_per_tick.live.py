"""kernels_per_tick.live: Device kernels a tick in the profiled sub-
window."""

from benchmark import reading

LAYER = "frame step"
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frame_p95_ms"


def read(rec):
    return reading.kernels_per_unit(rec)
