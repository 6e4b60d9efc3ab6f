"""engine.wait_ms.live: How long a frame waits in its slot's queue, from
`SlotEngine.submit` to the `collect` that takes it:
`stats["wait_s_sum"]` over the frames collected, in the unprofiled
window."""

from benchmark import spans

LAYER = "slot engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "frame_p95_ms"


def read(rec):
    return spans.per_frame(rec, "wait_s_sum", 1e3)
