"""kernels_per_step.train: Device kernels a train step in the profiled
sub-window."""

from benchmark import reading

LAYER = "train step"
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_audio_s_per_s"


def read(rec):
    return reading.kernels_per_unit(rec)
