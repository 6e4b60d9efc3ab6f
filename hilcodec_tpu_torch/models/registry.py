"""Model registry: config `model:` name -> CodecModel builder.

Every family of the JAX package: HILCodec, EnCodec, Avocodo and
AudioDec."""

from __future__ import annotations

from typing import Any, Dict

from .. import resolve_device
from .audiodec import AudioDec
from .avocodo import AvocodoModel
from .codec import CodecModel, residual_vq
from .encodec import EncodecModel

# the JAX registry's default stack when an EnCodec config has no vq_kwargs
_ENCODEC_VQ = {"dim": 128, "codebook_size": 1024, "num_quantizers": 32}


def build_encodec(model_kwargs: Dict[str, Any], device=None) -> CodecModel:
    kw = dict(model_kwargs)
    kw["vq_kwargs"] = kw.get("vq_kwargs") or dict(_ENCODEC_VQ)
    return CodecModel(EncodecModel.from_config(kw),
                      residual_vq(kw["vq_kwargs"]), resolve_device(device))


def build_avocodo(model_kwargs: Dict[str, Any], device=None) -> CodecModel:
    """The Avocodo generator with its residual VQ; it streams through the
    full-rate head."""
    codec = AvocodoModel.from_config(model_kwargs)
    vq_kwargs = dict(model_kwargs.get("vq_kwargs") or {})
    vq_kwargs.setdefault("dim", codec.vq_dim)
    return CodecModel(codec, residual_vq(vq_kwargs), resolve_device(device))


def build_audiodec(model_kwargs: Dict[str, Any], device=None) -> CodecModel:
    """AudioDec with its residual VQ; an AudioDec config carries no
    vq_kwargs, so the VQ's dim is the codec's code_dim."""
    codec = AudioDec.from_config(model_kwargs)
    vq_kwargs = dict(model_kwargs.get("vq_kwargs") or {})
    vq_kwargs.setdefault("dim", codec.code_dim)
    return CodecModel(codec, residual_vq(vq_kwargs), resolve_device(device))


def build_codec_model(name: str, model_kwargs: Dict[str, Any],
                      device=None) -> CodecModel:
    """Streaming/deployment surface of family `name` on `device` (CUDA
    when None)."""
    if name == "hilcodec":
        return CodecModel.from_config(model_kwargs, device=device)
    if name == "encodec":
        return build_encodec(model_kwargs, device=device)
    if name == "avocodo":
        return build_avocodo(model_kwargs, device=device)
    if name == "audiodec":
        return build_audiodec(model_kwargs, device=device)
    raise ValueError(f"unknown model {name!r}")
