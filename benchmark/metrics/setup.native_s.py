"""setup.native_s: Seconds this process spent building (on a checkout's
first run) and loading the port's native libraries
(`ops/cuda_build.load_record`)."""

from benchmark import spans

LAYER = "set-up"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "setup_s"


def read(rec):
    return spans.native_s(spans.native_record())
