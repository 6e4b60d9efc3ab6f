"""mfu.stream: The reference's FLOPs a frame step (encoder step, RVQ
cascade, decoder step) times the frame steps of the unprofiled window,
over its wall time, over the card's peak."""

from benchmark import reading

LAYER = "frame step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "stream_rtf"


def read(rec):
    return reading.mfu_pct(rec)
