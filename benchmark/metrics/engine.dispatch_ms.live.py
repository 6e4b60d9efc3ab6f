"""engine.dispatch_ms.live: The engine's host time to enqueue a tick's
frame step: `SlotEngine.stats["dispatch_s_sum"]` over its ticks, in the
unprofiled window."""

LAYER = "slot engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "frame_p95_ms"


def read(rec):
    st = rec.get("engine_stats")
    if not st or not st["ticks"]:
        return None
    return 1e3 * st["dispatch_s_sum"] / st["ticks"]
