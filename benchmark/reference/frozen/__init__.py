"""A frozen copy of the port's plain PyTorch code paths.

The reference of the benchmark: the modules the codec's offline passes
and the flagship train step need, copied from the port's `ops/`,
`models/`, `train/`, `parallel/` and `utils/`, with the imports of the
port's kernels taken out (the RVQ's training pass runs the plain cascade,
and `models/codec.py` is a trimmed wrapper without streaming drivers).
Later changes to the port do not reach it, so the yardstick stays put.
It imports nothing of the port.
"""
