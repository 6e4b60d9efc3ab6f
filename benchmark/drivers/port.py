"""The port's entries as the drivers build them from a configuration
file: its own constructors (the model classes as `models/registry.py`
calls them, `train/loop.py`), never `configs/*.yaml`."""

from __future__ import annotations

from typing import Any, Dict

import torch


def codec_model(config: Dict[str, Any], device: torch.device):
    """The port's `CodecModel` of a configuration file, built by the
    model's own constructors as `models/registry.py` calls them. The
    registry is not imported: it loads every family, Avocodo's PQMF with
    it, and so `scipy.signal`, some seconds of host time in every run's
    set-up."""
    from hilcodec_tpu_torch.models.codec import CodecModel, residual_vq
    kw = dict(config["model_kwargs"])
    if config["model"] == "hilcodec":
        return CodecModel.from_config(kw, device=device)
    if config["model"] == "audiodec":
        from hilcodec_tpu_torch.models.audiodec import AudioDec
        codec = AudioDec.from_config(kw)
        vq_kwargs = dict(kw.get("vq_kwargs") or {})
        vq_kwargs.setdefault("dim", codec.code_dim)
        return CodecModel(codec, residual_vq(vq_kwargs), device)
    raise ValueError(f"no streaming cell builds model {config['model']!r}")


def hparams(config: Dict[str, Any]):
    """The port's `HParams` of a configuration file's training sections."""
    from hilcodec_tpu_torch.utils.hparams import HParams
    return HParams(**{k: config[k] for k in
                      ("model", "model_kwargs", "disc_kwargs", "train",
                       "data")})


def stream_params(model, params: Dict[str, Any], books: torch.Tensor,
                  precision: str, device: torch.device):
    """(folded params, VQ state, activation dtype) for the port's streaming
    drivers; `bf16` casts every leaf and the activations (the port's
    `cast_streaming_params`, the control)."""
    from hilcodec_tpu_torch.models.codec import cast_streaming_params
    folded = model.fold_params(params)
    dtype = torch.float32
    if precision == "bf16":
        folded = cast_streaming_params(folded, torch.bfloat16,
                                       kernels_only=False)
        dtype = torch.bfloat16
    folded, vq_state = model.to_device(folded, {"embed": books})
    return folded, vq_state, dtype
