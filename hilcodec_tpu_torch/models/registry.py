"""Model registry: config `model:` name -> CodecModel builder.

Only the HILCodec family is ported; the others raise and point at the
roadmap."""

from __future__ import annotations

from typing import Any, Dict

from .codec import CodecModel

_NOT_PORTED = ("encodec", "avocodo", "audiodec")


def build_codec_model(name: str, model_kwargs: Dict[str, Any],
                      device=None) -> CodecModel:
    """Streaming/deployment surface of family `name` on `device` (CUDA
    when None)."""
    if name == "hilcodec":
        return CodecModel.from_config(model_kwargs, device=device)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {name!r} is not ported to hilcodec_tpu_torch yet; "
            "see ROADMAP.md (Queue 1, other families)")
    raise ValueError(f"unknown model {name!r}")
