"""k3_roofline: K3's (the decoder frame kernel's) least time over its
mean device time a call: the larger of the reference decoder step's
FLOPs over the peak and its least bytes (weights, input and caches read
once, output and caches written once) over HBM's."""

from benchmark import reading

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stream_rtf"


def read(rec):
    return reading.roofline_pct(rec, "decode_stream", "k3_work")
