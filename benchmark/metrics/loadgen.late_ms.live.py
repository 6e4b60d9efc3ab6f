"""loadgen.late_ms.live: The 95th percentile of each frame's submit time
minus its due time: how late the load generator offered the load."""

from benchmark import reading

LAYER = "load generator"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "frame_p95_ms"


def read(rec):
    late = rec.get("late_s")
    return None if not late else 1e3 * reading.percentile(late, 95)
