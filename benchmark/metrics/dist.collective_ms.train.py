"""dist.collective_ms.train: Device ms a train step of the operations
launched inside the program's `dist.collective` spans (the step's
all-reduces and broadcasts over its process group) on rank 0, in the
profiled sub-window. A program without the span, or a step without a
group, reads as nothing."""

from benchmark import spans

LAYER = "data parallel"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_audio_s_per_s"


def read(rec):
    return spans.device_ms_per_unit(rec, ("dist.collective",))
