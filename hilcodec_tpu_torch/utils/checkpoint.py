"""Train-state checkpoints in the JAX package's layout
(`hilcodec_tpu/utils/checkpoint.py`).

One `{epoch:05d}.ckpt.npz` per save in the run directory: each leaf of
the TrainState under its JAX path (`utils/params.tree_to_flat`) and the
loop's extras under `__extra__/{key}`. A checkpoint written by either
package loads in the other (`np.load` reads the JAX package's compressed
archives and these uncompressed ones alike). The flagship's state is
about 0.7 GB of f32 weights and Adam moments, which zlib barely shrinks
and takes tens of seconds to compress, so it is stored uncompressed.
`load_codec` reads the codec's weights out of one for the tools (export,
infer, eval, serve); `clean_checkpoints` is the checkpoint GC of
`python -m hilcodec_tpu_torch.clean_checkpoint`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

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


def load_codec(hps, path: Optional[str] = None, device=None,
               random_books: bool = True):
    """(model, params_g, vq_state) of the config's codec
    (`build_codec_model`: for Avocodo the streaming generator, whichever
    trainer the config selects), unfolded, on `device` (CUDA when None).
    With a path, a train checkpoint read into the initial state of the
    config's trainer, as the JAX tools read one; without, the seeded init
    (`CodecModel.seeded(random_books)`). On the card it sets the f32
    parity mode."""
    import torch

    from .. import set_f32_parity_mode
    from ..models.registry import build_codec_model
    from ..train.loop import build_trainer
    model = build_codec_model(hps.get("model", "hilcodec"),
                              hps.model_kwargs.to_dict(), device=device)
    if path is None:
        params, vq_state = model.seeded(random_books)
    else:
        trainer = build_trainer(hps, device)
        state, _ = load_checkpoint(
            path, trainer.init_state(torch.Generator().manual_seed(0)))
        params, vq_state = state.params_g, dict(state.vq_state)
    if model.device.type == "cuda":
        set_f32_parity_mode()
    return model, params, vq_state


def clean_checkpoints(base_dir: str, dry_run: bool = False
                      ) -> List[Tuple[str, int]]:
    """Delete all but the newest checkpoint of every directory under
    base_dir (recursively). Returns [(path, bytes freed)]."""
    removed = []
    for root, _dirs, files in os.walk(base_dir):
        ckpts = sorted((int(m.group(1)), f) for f in files
                       if (m := _CKPT_RE.match(f)))
        for _ep, f in ckpts[:-1]:
            path = os.path.join(root, f)
            size = os.path.getsize(path)
            if not dry_run:
                os.remove(path)
            removed.append((path, size))
    return removed
