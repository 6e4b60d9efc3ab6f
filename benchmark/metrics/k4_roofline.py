"""k4_roofline: K4's (the encoder frame kernel's) least time over its
mean device time a call, as K3's, from the reference encoder step."""

from benchmark import reading

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stream_rtf"


def read(rec):
    return reading.roofline_pct(rec, "encode_stream", "k4_work")
