"""rvq.device_ms_per_frame.stream: Device ms a frame step of the
operations launched inside the program's `codec.quantize` (K1 and its
wrapper) and `codec.dequantize` spans, in the profiled sub-window."""

from benchmark import spans

LAYER = "quantizer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "stream_rtf"


def read(rec):
    return spans.device_ms_per_unit(rec, ("codec.quantize",
                                          "codec.dequantize"))
