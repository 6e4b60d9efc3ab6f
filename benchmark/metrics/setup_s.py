"""setup_s: From the start of the process to the start of the window:
imports, weights from the seed, the port's kernels loaded (built on a
cell's first run in a checkout) and the cell's warm-up."""

LAYER = "end-to-end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(rec):
    return rec.get("setup_s")
