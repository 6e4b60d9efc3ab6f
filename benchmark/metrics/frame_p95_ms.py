"""frame_p95_ms: The 95th percentile, over every frame due in the
window, of the time its reply was in the host's hands minus the time it
was due; a frame never answered counts as waiting until the drain gave
up on it."""

from benchmark import reading

LAYER = "end-to-end"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(rec):
    lat = rec.get("latency_s")
    return None if not lat else 1e3 * reading.percentile(lat, 95)
