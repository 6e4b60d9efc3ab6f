"""Parameter bridge between the JAX package's flat artifacts and the port.

The JAX package stores parameters as a pytree of nested dicts and lists
whose leaves are addressed by '/'-joined paths (`encoder/stages/0/down_dw/v`)
in its checkpoints and in `{name}_deploy.npz` (which adds the RVQ stack under
`codebooks`). The port keeps the same nested structure with torch tensors
at the leaves and names each leaf by the same path with '/' -> '.'.

The JAX tree already stores convolution weights in torch's layouts
(conv `[Cout, Cin/g, k]`, transposed conv `[Cin, Cout/g, k]`), so loading
is a rename plus a check of every name and shape against the model's own
template (unfolded `{v, g[, b]}` or folded `{w[, b]}` leaves).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


def _items(node) -> List[Tuple[str, Any]]:
    # JAX flattens dicts in sorted key order and lists in index order
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return [(str(i), v) for i, v in enumerate(node)]


def flatten(params: Params, sep: str = ".") -> Dict[str, Any]:
    """Nested dict/list tree -> {path: leaf}, in the JAX leaf order."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        if isinstance(node, (dict, list, tuple)):
            for k, v in _items(node):
                walk(v, f"{prefix}{sep}{k}" if prefix else k)
        else:
            out[prefix] = node

    walk(params, "")
    return out


def unflatten(flat: Mapping[str, Any], sep: str = ".") -> Params:
    """{path: leaf} -> nested tree; all-digit path parts become list slots."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split(sep)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            idx = sorted(int(k) for k in node)
            if idx != list(range(len(idx))):
                raise ValueError(f"non-contiguous list indices {idx}")
            return [node[str(i)] for i in idx]
        return node

    return listify(root)


def is_folded(flat: Mapping[str, Any]) -> bool:
    """Folded deployment trees carry `w` leaves; unfolded carry `v`/`g`."""
    return any(k.replace("/", ".").rsplit(".", 1)[-1] == "w" for k in flat)


def from_flat(flat: Mapping[str, np.ndarray], template: Params,
              device="cpu") -> Params:
    """Flat JAX-path arrays -> the port's param tree on `device`.

    `template` is a param tree of the same model and kind (unfolded or
    folded); every name and shape must match it exactly."""
    flat = {k.replace("/", "."): v for k, v in flat.items()}
    want = {k: tuple(v.shape) for k, v in flatten(template).items()}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"param names differ from the model: "
                         f"missing {missing[:8]}, unexpected {extra[:8]}")
    bad = [(k, tuple(np.shape(flat[k])), s) for k, s in want.items()
           if tuple(np.shape(flat[k])) != s]
    if bad:
        raise ValueError(f"param shapes differ from the model: {bad[:8]}")
    return unflatten({k: torch.from_numpy(np.array(v, np.float32)).to(device)
                      for k, v in flat.items()})


def to_flat(params: Params) -> Dict[str, np.ndarray]:
    """The port's param tree -> {jax_leaf_path: np.ndarray}."""
    return {k.replace(".", "/"): v.detach().cpu().numpy()
            for k, v in flatten(params).items()}


def load_deploy_npz(path: str, model, device="cpu") -> Tuple[Params, dict]:
    """Load a JAX `{name}_deploy.npz` (folded params + `codebooks`) for
    `model` (a port CodecModel). Returns (params, vq_state)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    books = flat.pop("codebooks")
    vq_shape = (model.vq.num_quantizers, model.vq.codebook_size, model.vq.dim)
    if books.shape != vq_shape:
        raise ValueError(f"codebooks {books.shape} != model {vq_shape}")
    params = from_flat(flat, model.param_template(folded=is_folded(flat)),
                       device)
    embed = torch.from_numpy(np.array(books, np.float32)).to(device)
    return params, {"embed": embed}
