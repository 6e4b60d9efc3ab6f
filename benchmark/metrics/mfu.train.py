"""mfu.train: The reference's FLOPs a train step times the steps of the
unprofiled window, over its wall time, over the card's peak."""

from benchmark import reading

LAYER = "train step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_audio_s_per_s"


def read(rec):
    return reading.mfu_pct(rec)
