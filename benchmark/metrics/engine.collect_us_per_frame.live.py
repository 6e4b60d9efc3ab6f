"""engine.collect_us_per_frame.live: The host's time in
`SlotEngine.collect` per frame it takes: `stats["collect_s_sum"]` over
the frames collected, in the unprofiled window."""

from benchmark import spans

LAYER = "slot engine"
UNIT = "us"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "frame_p95_ms"


def read(rec):
    return spans.per_frame(rec, "collect_s_sum", 1e6)
