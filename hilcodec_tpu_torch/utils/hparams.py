"""YAML / JSON config loading: a nested, attribute-accessible `HParams`.

The port's own copy of the reference config system's read side, so the
shipped `configs/*.yaml` load unmodified."""

from __future__ import annotations

import json
from typing import Any, Dict

import yaml


class HParams:
    """Nested attribute-style view over a dict (recursively).

    Supports attribute access (``hp.model_kwargs.strides``), mapping access
    (``hp["model_kwargs"]``), ``in``, ``get`` and conversion back to a
    plain dict."""

    def __init__(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict):
            value = HParams(**value)
        self.__dict__[key] = value

    def __getitem__(self, key: str) -> Any:
        return self.__dict__[key]

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __repr__(self) -> str:
        return f"HParams({self.__dict__!r})"

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, HParams) else v
                for k, v in self.__dict__.items()}


def load_config(path: str) -> HParams:
    """Load a YAML (or JSON) config file into an HParams tree."""
    with open(path, "r") as f:
        text = f.read()
    data = json.loads(text) if path.endswith(".json") else yaml.safe_load(text)
    return HParams(**(data or {}))
