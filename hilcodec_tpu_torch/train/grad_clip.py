"""Gradient clipping (`hilcodec_tpu/train/grad_clip.py`): global norm,
per-parameter norm and value, selected by `train.clip_grad`."""

from __future__ import annotations

from typing import Any

import torch

from ..utils.params import tree_map


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def clip_grad_norm_global(grads: Any, max_norm: float,
                          eps: float = 1e-6) -> Any:
    sq = sum(torch.sum(torch.square(g.float())) for g in _leaves(grads))
    scale = torch.clamp(max_norm / (torch.sqrt(sq) + eps), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


def clip_grad_norm_local(grads: Any, max_norm: float,
                         eps: float = 1e-6) -> Any:
    """Each parameter's gradient clipped by its own norm."""
    def leaf(g):
        norm = torch.sqrt(torch.sum(torch.square(g.float())))
        scale = torch.clamp(max_norm / (norm + eps), max=1.0)
        return (g.float() * scale).to(g.dtype)
    return tree_map(leaf, grads)


def clip_grad_value(grads: Any, clip_value: float) -> Any:
    return tree_map(lambda g: torch.clamp(g, -clip_value, clip_value), grads)


def make_clipper(clip_grad, clip_grad_kwargs=None):
    """None | 'norm' / 'norm_global' | 'norm_local' | 'value'."""
    kw = dict(clip_grad_kwargs or {})
    if clip_grad is None:
        return lambda g: g
    if clip_grad in ("norm", "norm_global"):
        return lambda g: clip_grad_norm_global(g, kw.get("max_norm", 1.0))
    if clip_grad == "norm_local":
        return lambda g: clip_grad_norm_local(g, kw.get("max_norm", 1.0))
    if clip_grad == "value":
        return lambda g: clip_grad_value(g, kw.get("clip_value", 1.0))
    raise ValueError(f"unknown clip_grad {clip_grad}")

