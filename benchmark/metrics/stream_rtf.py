"""stream_rtf: All audio seconds encoded and decoded by all streams in
the window, over the window's wall seconds (the window ends in a device
synchronize)."""

from benchmark import reading

LAYER = "end-to-end"
UNIT = "x_realtime"
BETTER = "higher"
SOURCE = "host_clock"


def read(rec):
    return reading.rate(rec, "audio_s")
