"""train_audio_s_per_s: Batch x segment seconds x the steps completed in
the window, over the window's wall seconds (the last step ends in a
synchronize)."""

from benchmark import reading

LAYER = "end-to-end"
UNIT = "audio-s/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(rec):
    return reading.rate(rec, "audio_s")
