"""PyTorch / CUDA port of the streaming HILCodec serving path.

The JAX package `hilcodec_tpu` is the reference; this package mirrors its
layout (`ops/`, `models/`, `serve/`, `utils/`) and keeps its parameter
paths and cache order so that the two can be compared leaf by leaf. It
imports `torch` and never `jax` or `hilcodec_tpu`.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; with no device given and no CUDA available they raise.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no device is named and CUDA is unavailable, so that an
    entry point never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def set_f32_parity_mode() -> None:
    """Keep convolutions and matmuls in IEEE f32 on the card.

    cuDNN convolutions default to TF32 (about three decimal digits), which
    would break the waveform parity with the f32 reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# registers the operator hilcodec::rvq_cascade, which programs exported
# from the port (`export --program`) call
from .ops import rvq_kernel as _rvq_kernel  # noqa: E402,F401
