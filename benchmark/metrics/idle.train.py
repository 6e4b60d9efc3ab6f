"""idle.train: The share of the profiled interval in which no device
operation ran."""

from benchmark import reading

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_audio_s_per_s"


def read(rec):
    return reading.idle_pct(rec)
