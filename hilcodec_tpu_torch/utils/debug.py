"""Debug helpers (`hilcodec_tpu/utils/debug.py`): non-finite and
zero-gradient scanners over the port's trees, and a file logger.

Each scanner returns the JAX leaf paths (`utils/params.tree_to_flat`'s
names: '/'-joined, NamedTuple fields as `.field`) of the leaves it flags.
`find_zero_grads` is the functional analogue of DDP's unused-parameter
finder: a leaf whose gradient is identically zero, usually a module the
loss does not reach.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List

import numpy as np

from .params import tree_map, tree_to_flat


def _paths_where(tree: Any, pred) -> List[str]:
    # bf16 has no numpy dtype: read floating leaves as f32
    tree = tree_map(lambda x: x.detach().float() if x.is_floating_point()
                    else x, tree)
    return [path for path, a in tree_to_flat(tree).items() if pred(a)]


def find_nonfinite(tree: Any) -> List[str]:
    """Leaves holding a NaN or an Inf."""
    return _paths_where(tree, lambda a: a.size and not np.isfinite(a).all())


def find_zero_grads(grads: Any) -> List[str]:
    """Gradient leaves that are identically zero."""
    return _paths_where(grads, lambda a: a.size and not np.any(a))


class FileLogger:
    """Append-only timestamped run log."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log(self, msg: str) -> None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        with open(self.path, "a") as f:
            f.write(f"[{stamp}] {msg}\n")
