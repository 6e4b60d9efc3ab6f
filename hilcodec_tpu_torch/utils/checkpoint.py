"""Train-state checkpoints in the JAX package's layout
(`hilcodec_tpu/utils/checkpoint.py`).

One `{epoch:05d}.ckpt.npz` per save in the run directory: each leaf of
the TrainState under its JAX path (`utils/params.tree_to_flat`) and the
loop's extras under `__extra__/{key}`. A checkpoint written by either
package loads in the other (`np.load` reads the JAX package's compressed
archives and these uncompressed ones alike). The flagship's state is
about 0.7 GB of f32 weights and Adam moments, which zlib barely shrinks
and takes tens of seconds to compress, so it is stored uncompressed.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .params import tree_from_flat, tree_to_flat

_CKPT_RE = re.compile(r"^(\d+)\.ckpt\.npz$")


def save_checkpoint(run_dir: str, epoch: int, state: Any,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write {run_dir}/{epoch:05d}.ckpt.npz (atomically) and return its
    path."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"{epoch:05d}.ckpt.npz")
    flat = tree_to_flat(state)
    for k, v in (extra or {}).items():
        flat[f"__extra__/{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    return path


def latest_checkpoint(run_dir: str) -> Optional[Tuple[int, str]]:
    """(epoch, path) of the newest checkpoint in run_dir, or None."""
    if not os.path.isdir(run_dir):
        return None
    found = [(int(m.group(1)), os.path.join(run_dir, f))
             for f in os.listdir(run_dir) if (m := _CKPT_RE.match(f))]
    return max(found) if found else None


def load_checkpoint(path: str, template: Any
                    ) -> Tuple[Any, Dict[str, np.ndarray]]:
    """(state shaped like `template`, extras). A leaf the file lacks keeps
    the template's value, with a warning, so older runs stay resumable."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    missing: list = []
    state = tree_from_flat(flat, template, missing)
    for key in missing:
        print(f"warning: checkpoint {path} has no leaf {key}; keeping the "
              f"initialized value")
    extras = {k[len("__extra__/"):]: v for k, v in flat.items()
              if k.startswith("__extra__/")}
    return state, extras
