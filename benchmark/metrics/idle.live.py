"""idle.live: The share of the profiled interval in which no device
operation ran."""

from benchmark import reading

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frame_p95_ms"


def read(rec):
    return reading.idle_pct(rec)
