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

The train state (`train/step.TrainState`: both param trees, the VQ state,
both optimizer states, the balancer state and the counters) crosses the
same way: `tree_to_flat` / `tree_from_flat` name each leaf by the path the
JAX package gives it in a `.ckpt.npz`, NamedTuple fields as `.field`
(`.params_g/encoder/conv_pre/v`, `.opt_g/.exp_avg/...`, `.iteration`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


def tree_map(fn, tree, *rest):
    """Apply fn leafwise over trees of one structure (dicts, lists, tuples
    and NamedTuples of leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def _path_items(node) -> List[Tuple[str, Any]]:
    """Children with their JAX path keys: `.field` for a NamedTuple."""
    if hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    return _items(node)


def tree_to_flat(tree) -> Dict[str, np.ndarray]:
    """Any state tree -> {JAX leaf path: np.ndarray}, as the JAX
    package's checkpoint writes it."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, (dict, list, tuple)):
            for k, v in _path_items(node):
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = node.detach().cpu().numpy()

    walk(tree, "")
    return out


def tree_from_flat(flat: Mapping[str, np.ndarray], template,
                   missing: List[str] = None):
    """Rebuild `template`'s structure from flat JAX-path arrays, each leaf
    on its template leaf's device with its dtype; shapes must match. A
    path absent from `flat` keeps the template's leaf and is appended to
    `missing` when a list is given, else raises."""
    def walk(node, prefix):
        if isinstance(node, (dict, list, tuple)):
            items = [(k, walk(v, f"{prefix}/{k}" if prefix else k))
                     for k, v in _path_items(node)]
            if isinstance(node, dict):
                return dict(items)
            vals = [v for _, v in items]
            if isinstance(node, list):
                return vals
            return type(node)(*vals) if hasattr(node, "_fields") \
                else tuple(vals)
        if prefix not in flat:
            if missing is None:
                raise ValueError(f"no array for {prefix}")
            missing.append(prefix)
            return node
        arr = np.asarray(flat[prefix])
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"{prefix}: shape {arr.shape} != "
                             f"{tuple(node.shape)}")
        return torch.from_numpy(np.array(arr)).to(node.device, node.dtype)

    return walk(template, "")


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
    template = model.param_template(folded=is_folded(flat))
    if "codebooks" in template:
        # AudioDec's params hold a `codebooks` leaf of their own, under the
        # name the file gives the quantizer's codebooks
        flat["codebooks"] = books
    params = from_flat(flat, template, device)
    embed = torch.from_numpy(np.array(books, np.float32)).to(device)
    return params, {"embed": embed}
