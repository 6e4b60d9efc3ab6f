"""TensorBoard summaries and the terminal progress line
(`hilcodec_tpu/utils/summarize.py`).

Scalars, histograms, spectrogram images and audio through torch's
`SummaryWriter`, which needs the `tensorboard` package; the images need
matplotlib as well. `missing()` names what this interpreter cannot write,
so that the training loop can say so once and train on.
"""

from __future__ import annotations

import importlib.util
import sys
import types
from typing import Any, Dict, List, Optional

import numpy as np

from .params import flatten


def missing() -> List[str]:
    """The packages the summaries need that are not installed:
    'tensorboard' (every summary), 'matplotlib' (spectrogram images)."""
    return [name for name in ("tensorboard", "matplotlib")
            if importlib.util.find_spec(name) is None]


def get_writer(log_dir: str):
    # tensorboard imports TensorFlow, where it is installed, for its file
    # I/O alone (seconds of import, and TensorFlow's own device set-up);
    # the `notf` marker selects the built-in stub that does the same I/O,
    # the one tensorboard uses where TensorFlow is absent
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter(log_dir)


def plot_spectrogram_to_numpy(spec: np.ndarray) -> np.ndarray:
    """[n_mels, T] log-mel -> HWC uint8 image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(spec, aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return data


def summarize(writer, epoch: int, scalars: Optional[Dict[str, float]] = None,
              scalars_not_to_print: Optional[Dict[str, float]] = None,
              specs: Optional[Dict[str, np.ndarray]] = None,
              audios: Optional[Dict[str, np.ndarray]] = None,
              hists: Optional[Dict[str, np.ndarray]] = None,
              sampling_rate: int = 24000, echo: bool = True) -> None:
    """Write one epoch's bundle of summaries."""
    scalars = scalars or {}
    for k, v in scalars.items():
        writer.add_scalar(k, float(v), epoch)
    for k, v in (scalars_not_to_print or {}).items():
        writer.add_scalar(k, float(v), epoch)
    for k, v in (specs or {}).items():
        writer.add_image(k, plot_spectrogram_to_numpy(np.asarray(v)),
                         epoch, dataformats="HWC")
    for k, v in (audios or {}).items():
        wav = np.asarray(v).reshape(-1)
        writer.add_audio(k, wav[:, None], epoch, sample_rate=sampling_rate)
    for k, v in (hists or {}).items():
        writer.add_histogram(k, v, epoch)
    if echo and scalars:
        print("  ".join(f"{k}: {float(v):.4f}" for k, v in scalars.items()))


def plot_param_and_grad(hists: Dict[str, np.ndarray], params: Any,
                        grads: Optional[Any] = None,
                        prefix: str = "model") -> None:
    """Each parameter (and gradient) leaf's values into `hists` under
    `{prefix}/{leaf path}` (`{prefix}_grad/...`), the JAX leaf paths; a
    leaf with a NaN or Inf is left out."""
    for tag, tree in ((prefix, params), (prefix + "_grad", grads)):
        if tree is None:
            continue
        for path, leaf in flatten(tree, sep="/").items():
            arr = leaf.detach().cpu().numpy().ravel()
            if arr.size and np.isfinite(arr).all():
                hists[f"{tag}/{path}"] = arr


def progress_line(text: str, file=sys.stdout) -> None:
    """Overwrite the terminal's current line with `text`."""
    file.write("\r\033[K" + text)
    file.flush()
