"""optim.idle.train: The share of the profiled interval with no device
operation while the host is inside the program's `train.optim_g`,
`train.optim_d` or `train.spectral_norm` span."""

from benchmark import spans

LAYER = "train step"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_audio_s_per_s"


def read(rec):
    return spans.idle_pct_in(rec, spans.OPTIMIZER_SPANS)
