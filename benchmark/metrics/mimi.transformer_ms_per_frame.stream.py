"""mimi.transformer_ms_per_frame.stream: Device ms a frame step of the
operations launched inside the program's `mimi.encoder_transformer` and
`mimi.decoder_transformer` spans (both streaming transformers, their
attention included), in the profiled sub-window. A program without the
spans reads as nothing."""

from benchmark import spans

LAYER = "transformer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "stream_rtf"


def read(rec):
    return spans.device_ms_per_unit(rec, ("mimi.encoder_transformer",
                                          "mimi.decoder_transformer"))
