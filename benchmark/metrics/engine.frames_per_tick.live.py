"""engine.frames_per_tick.live: Frames a tick carries:
`SlotEngine.stats["frames"]` over its `stats["ticks"]`, in the
unprofiled window."""

LAYER = "slot engine"
UNIT = "frames"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "frame_p95_ms"


def read(rec):
    st = rec.get("engine_stats")
    if not st or not st["ticks"]:
        return None
    return st["frames"] / st["ticks"]
