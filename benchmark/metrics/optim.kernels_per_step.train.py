"""optim.kernels_per_step.train: Device kernels a train step launched
inside the program's `train.optim_g`, `train.optim_d` and
`train.spectral_norm` spans (AdamP's per-leaf update and the power
iteration), in the profiled sub-window."""

from benchmark import spans

LAYER = "train step"
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_audio_s_per_s"


def read(rec):
    return spans.kernels_per_unit(rec, spans.OPTIMIZER_SPANS)
