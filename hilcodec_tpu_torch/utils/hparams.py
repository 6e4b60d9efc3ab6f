"""YAML / JSON config loading: a nested, attribute-accessible `HParams`,
dotted `-p a.b=v` overrides and the training CLI's argument parsing.

The port's own copy of `hilcodec_tpu/utils/hparams.py`, so the shipped
`configs/*.yaml` load unmodified."""

from __future__ import annotations

import argparse
import ast
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import yaml


class HParams:
    """Nested attribute-style view over a dict (recursively).

    Supports attribute access (``hp.model_kwargs.strides``), mapping access
    (``hp["model_kwargs"]``), ``in``, ``get``, ``items`` and conversion
    back to a plain dict."""

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

    def items(self):
        return self.__dict__.items()

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


def _parse_value(raw: str) -> Any:
    """A Python literal when it parses as one, else the string."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def update_params(hp: HParams, overrides: Optional[List[str]]) -> HParams:
    """Apply dotted overrides `a.b.c=value` in place, creating missing
    intermediate nodes."""
    for item in overrides or ():
        if "=" not in item:
            raise ValueError(f"override must look like key=value, got "
                             f"{item!r}")
        path, raw = item.split("=", 1)
        keys = path.strip().split(".")
        node = hp
        for key in keys[:-1]:
            if key not in node or not isinstance(node[key], HParams):
                node[key] = HParams()
            node = node[key]
        node[keys[-1]] = _parse_value(raw)
    return hp


def get_hparams(args: Optional[List[str]] = None, base_dir: str = "logs"
                ) -> Tuple[HParams, argparse.Namespace]:
    """The training CLI: `-n NAME [-c CONFIG] [-p a.b=v ...] [-f]
    [-b BASE_DIR] [--device D]`. The config is copied to
    {base_dir}/{name}/config.yaml (refused if another is there, unless
    -f); without -c the run's copy is loaded. Returns the HParams with
    `model_dir` set, and the parsed arguments."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-n", "--name", type=str, required=True,
                        help="run name; the run directory is base_dir/name")
    parser.add_argument("-c", "--config", type=str, default=None,
                        help="YAML / JSON config")
    parser.add_argument("-p", "--params", nargs="*", default=None,
                        help="dotted overrides: a.b.c=value")
    parser.add_argument("-f", "--force", action="store_true",
                        help="overwrite the run's config copy")
    parser.add_argument("-b", "--base_dir", type=str, default=base_dir)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, which must be "
                        "available)")
    ns = parser.parse_args(args)

    run_dir = os.path.join(ns.base_dir, ns.name)
    snapshot = os.path.join(run_dir, "config.yaml")
    if ns.config is None:
        if not os.path.exists(snapshot):
            raise FileNotFoundError(f"no -c given and no config at "
                                    f"{snapshot}")
        hp = load_config(snapshot)
    else:
        hp = load_config(ns.config)
        os.makedirs(run_dir, exist_ok=True)
        if os.path.abspath(ns.config) != os.path.abspath(snapshot):
            if os.path.exists(snapshot) and not ns.force:
                raise FileExistsError(f"{snapshot} exists; pass -f to "
                                      f"overwrite")
            shutil.copyfile(ns.config, snapshot)
    update_params(hp, ns.params)
    hp.model_dir = run_dir
    return hp, ns
