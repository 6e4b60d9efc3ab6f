"""kernels_per_frame.stream: Device kernels a frame step (all streams)
in the profiled sub-window."""

from benchmark import reading

LAYER = "frame step"
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "stream_rtf"


def read(rec):
    return reading.kernels_per_unit(rec)
