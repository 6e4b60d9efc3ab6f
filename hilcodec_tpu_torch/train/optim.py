"""AdamP, SGDP, RAdam, SAM and regex parameter groups
(`hilcodec_tpu/train/optim.py`).

Functional, on trees of tensors: `init(params) -> state` and
`update(grads, state, params, lr) -> (updates, state)`, the updates to be
added to the params; `lr` is the step's 0-d rate tensor, so nothing reads
the device. `apply(grads, state, params, lr, commit) -> (params, state)`
adds the updates and keeps params and state as they were where the 0-d
bool `commit` is false (the train step's finite and `do_d` flags). The
device alone picks AdamP's path: on a CUDA device `apply` launches the
multi-leaf kernel (`ops/adamp_kernel.py`, `csrc/adamp.cu`) and refuses,
naming the leaf, a tree it cannot take (a leaf not f32, trees of other
structures); on the CPU, and for SGDP and RAdam, it takes the plain path,
`update` and the masked sum. `fused_record()` counts the leaves each path
updated in this process. AdamP projects the update off the radial direction of a
scale-invariant weight (the cosine-similarity gate: a channel view first,
then a layer view) and damps its weight decay by `wd_ratio`; SGDP is SGD
with the same projection. RAdam rectifies Adam's step once rho_t > 5 and
takes plain momentum steps before. SAM wraps a base optimizer in two
phases (`first_step`, `second_step`); the train step cannot drive it (see
`make_optimizer`).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..ops import adamp_kernel as AK
from ..utils.params import flatten, tree_map, unflatten

Params = Any

# leaves updated by the multi-leaf kernel and by the plain path
_RECORD = {"fused": 0, "plain": 0}


def fused_record() -> Dict[str, int]:
    """{"fused": leaves the kernel updated, "plain": leaves the plain path
    updated} in this process, over every `apply`."""
    return dict(_RECORD)


def _apply_plain(opt, grads: Params, state: Any, params: Params,
                 lr: torch.Tensor, commit: Optional[torch.Tensor]
                 ) -> Tuple[Params, Any]:
    """`opt.update`, then the params plus the updates, each leaf of both
    kept where `commit` is false."""
    updates, new_state = opt.update(grads, state, params, lr)
    _RECORD["plain"] += len(flatten(params))
    if commit is None:
        return tree_map(lambda p, u: p + u, params, updates), new_state
    return (tree_map(lambda p, u: torch.where(commit, p + u, p), params,
                     updates),
            tree_map(lambda new, old: torch.where(commit, new, old),
                     new_state, state))


def _check_kernel_trees(trees: Tuple[Dict[str, torch.Tensor], ...],
                        step: torch.Tensor) -> None:
    """Raise ValueError, naming the leaf, unless the flat trees (params,
    grads, exp_avg, exp_avg_sq) have the params' leaves in their order and
    shapes, every leaf f32 on the params' device, and `step` there too."""
    fp = trees[0]
    dev = next(iter(fp.values())).device
    if step.device != dev:
        raise ValueError(f"AdamP.apply: step on {step.device}, the params "
                         f"on {dev}")
    for name, tree in zip(("params", "grads", "exp_avg", "exp_avg_sq"),
                          trees):
        if list(tree) != list(fp):
            odd = sorted(set(tree) ^ set(fp))[:3] or "their order"
            raise ValueError(f"AdamP.apply: the {name} tree's leaves differ "
                             f"from the params' ({odd})")
        for path, t in tree.items():
            if (t.dtype is not torch.float32 or t.device != dev
                    or t.shape != fp[path].shape):
                raise ValueError(
                    f"AdamP.apply: {name} leaf {path} is {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}; the kernel takes f32 "
                    f"leaves of the params' shapes on {dev}")


def _norm_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=1)


def _channel_cos(g: torch.Tensor, p: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """|cosine| per output channel (dim-0 rows)."""
    g2, p2 = g.reshape(g.shape[0], -1), p.reshape(p.shape[0], -1)
    den = torch.clamp(_norm_rows(g2) * _norm_rows(p2), min=eps)
    return torch.abs(torch.sum(g2 * p2, dim=1) / den)


def _layer_cos(g: torch.Tensor, p: torch.Tensor,
               eps: float) -> torch.Tensor:
    return _channel_cos(g.reshape(1, -1), p.reshape(1, -1), eps)


def _project_channel(p: torch.Tensor, perturb: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Remove the component of `perturb` along p, per dim-0 row."""
    expand = (-1,) + (1,) * (p.ndim - 1)
    norm = _norm_rows(p.reshape(p.shape[0], -1)).reshape(expand)
    p_n = p / (norm + eps)
    dot = torch.sum((p_n * perturb).reshape(p.shape[0], -1),
                    dim=1).reshape(expand)
    return perturb - p_n * dot


def _project_layer(p: torch.Tensor, perturb: torch.Tensor,
                   eps: float) -> torch.Tensor:
    p_n = p / (torch.linalg.vector_norm(p.reshape(-1)) + eps)
    return perturb - p_n * torch.sum(p_n * perturb)


def gate_inputs(p: torch.Tensor, g: torch.Tensor, delta: float,
                eps: float) -> Tuple[torch.Tensor, float, torch.Tensor,
                                     float]:
    """(max channel |cos|, its threshold, layer |cos|, its threshold) of
    the gate of a leaf with ndim > 1: a view projects when its cosine is
    below its threshold."""
    d_ch = p.reshape(p.shape[0], -1).shape[1]
    return (torch.max(_channel_cos(g, p, eps)), delta / math.sqrt(d_ch),
            torch.max(_layer_cos(g, p, eps)), delta / math.sqrt(p.numel()))


def _adamp_projection(p: torch.Tensor, grad: torch.Tensor,
                      perturb: torch.Tensor, delta: float, wd_ratio: float,
                      eps: float, project_channel: bool
                      ) -> Tuple[torch.Tensor, Any]:
    """The projected update and its weight-decay factor; the gate's
    branches are selects on the device."""
    if project_channel:
        return _project_channel(p, perturb, eps), wd_ratio
    if p.ndim <= 1:
        return perturb, 1.0
    ch_cos, ch_thr, ly_cos, ly_thr = gate_inputs(p, grad, delta, eps)
    ch_gate, ly_gate = ch_cos < ch_thr, ly_cos < ly_thr
    out = torch.where(ch_gate, _project_channel(p, perturb, eps),
                      torch.where(ly_gate, _project_layer(p, perturb, eps),
                                  perturb))
    wd = torch.where(ch_gate | ly_gate, wd_ratio, 1.0)
    return out, wd


def _leaf_options(group_fn, path: str) -> Dict[str, Any]:
    """A leaf's regex-group overrides, by its '/'-joined JAX path."""
    return group_fn(path) if group_fn else {}


class AdamPState(NamedTuple):
    step: torch.Tensor
    exp_avg: Params
    exp_avg_sq: Params


@dataclasses.dataclass(frozen=True)
class AdamP:
    """Adam whose update is projected off the radial direction of
    scale-invariant weights, with damped weight decay.

    `group_fn(path) -> dict` overrides per leaf (path '/'-joined as in the
    JAX tree): project_channel, weight_decay, lr_scale."""
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    delta: float = 0.1
    wd_ratio: float = 0.1
    nesterov: bool = False
    group_fn: Optional[Callable[[str], Dict[str, Any]]] = None
    # (paths, shapes, device) -> the kernel's table, or None for a tree
    # with no element
    _tables: Dict[Tuple, Optional[AK.DeviceTable]] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def init(self, params: Params) -> AdamPState:
        dev = next(iter(flatten(params).values())).device
        return AdamPState(torch.zeros((), dtype=torch.int32, device=dev),
                          tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    def leaf_options(self, path: str) -> Dict[str, Any]:
        return _leaf_options(self.group_fn, path)

    def resolved_options(self, path: str) -> Dict[str, Any]:
        """A leaf's project_channel, weight_decay and lr_scale, by its
        '.'-joined path."""
        opts = self.leaf_options(path.replace(".", "/"))
        return {"project_channel": opts.get("project_channel", False),
                "weight_decay": opts.get("weight_decay", self.weight_decay),
                "lr_scale": opts.get("lr_scale", 1.0)}

    def update(self, grads: Params, state: AdamPState, params: Params,
               lr: torch.Tensor) -> Tuple[Params, AdamPState]:
        b1, b2 = self.betas
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                         state.exp_avg, grads)
        new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                         state.exp_avg_sq, grads)
        fg, fm, fv = flatten(grads), flatten(new_m), flatten(new_v)
        updates = {}
        for path, p in flatten(params).items():
            g, m, v = fg[path], fm[path], fv[path]
            opts = self.resolved_options(path)
            weight_decay = opts["weight_decay"]
            lr_leaf = lr * opts["lr_scale"]
            denom = torch.sqrt(v) / torch.sqrt(bc2) + self.eps
            if self.nesterov:
                perturb = (b1 * m + (1 - b1) * g) / denom
            else:
                perturb = m / denom
            perturb, wd = _adamp_projection(
                p, g, perturb, self.delta, self.wd_ratio, self.eps,
                opts["project_channel"])
            update = -lr_leaf / bc1 * perturb
            if weight_decay > 0:
                # p *= 1 - lr * weight_decay * wd, written additively
                update = update - lr_leaf * weight_decay * wd * p
            updates[path] = update
        return unflatten(updates), AdamPState(step, new_m, new_v)

    def apply(self, grads: Params, state: AdamPState, params: Params,
              lr: torch.Tensor, commit: Optional[torch.Tensor] = None
              ) -> Tuple[Params, AdamPState]:
        """(params + updates, new state), both as they were where the 0-d
        bool `commit` is false (None: always commit). The kernel for params
        on a CUDA device (ValueError for trees it cannot take), the plain
        path on the CPU. The inputs are left as they are."""
        fp = flatten(params)
        if not fp or next(iter(fp.values())).device.type != "cuda":
            return _apply_plain(self, grads, state, params, lr, commit)
        trees = (fp, flatten(grads), flatten(state.exp_avg),
                 flatten(state.exp_avg_sq))
        _check_kernel_trees(trees, state.step)
        dt = self._device_table(fp)
        if dt is None:          # no leaf has an element
            return _apply_plain(self, grads, state, params, lr, commit)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dt.device)
        if commit is not None:
            commit = torch.as_tensor(commit, device=dt.device).to(torch.bool)
        new_p, new_m, new_v, step = AK.step(
            dt, *(list(t.values()) for t in trees),
            state.step.to(torch.int32), lr, commit, self.betas, self.eps,
            self.wd_ratio, self.nesterov)
        _RECORD["fused"] += len(fp)
        keys = list(fp)
        return (unflatten(dict(zip(keys, new_p))),
                AdamPState(step, unflatten(dict(zip(keys, new_m))),
                           unflatten(dict(zip(keys, new_v)))))

    def _device_table(self, fp: Dict[str, torch.Tensor]
                      ) -> Optional[AK.DeviceTable]:
        """The kernel's table of the flat params' structure on their
        device, built once per optimizer, structure and device; None for a
        tree with no element."""
        dev = next(iter(fp.values())).device
        shapes = tuple(tuple(t.shape) for t in fp.values())
        key = (tuple(fp), shapes, dev)
        if key not in self._tables:
            table = AK.build_table(shapes,
                                   [self.resolved_options(k) for k in fp],
                                   self.delta)
            self._tables[key] = (AK.DeviceTable(table, dev)
                                 if len(table.items_a) else None)
        return self._tables[key]

    def gate_report(self, grads: Params, params: Params
                    ) -> Dict[str, Tuple[float, float, float, float]]:
        """Per leaf whose gate is data-dependent: (max channel |cos|,
        threshold, layer |cos|, threshold), read to the host. A leaf whose
        cosine sits within a hair of its threshold can take the other
        branch on another device."""
        out = {}
        fg = flatten(grads)
        for path, p in flatten(params).items():
            if p.ndim <= 1 or self.leaf_options(
                    path.replace(".", "/")).get("project_channel", False):
                continue
            ch, ch_t, ly, ly_t = gate_inputs(p, fg[path], self.delta,
                                             self.eps)
            out[path.replace(".", "/")] = (float(ch), ch_t, float(ly), ly_t)
        return out


class SGDPState(NamedTuple):
    momentum: Params


@dataclasses.dataclass(frozen=True)
class SGDP:
    """SGD with AdamP's projection of scale-invariant weights; the weight
    decay is divided by (1 - momentum). `group_fn` as AdamP's
    (weight_decay, lr_scale)."""
    momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    delta: float = 0.1
    wd_ratio: float = 0.1
    nesterov: bool = False
    eps: float = 1e-8
    group_fn: Optional[Callable[[str], Dict[str, Any]]] = None

    def init(self, params: Params) -> SGDPState:
        return SGDPState(tree_map(torch.zeros_like, params))

    def update(self, grads: Params, state: SGDPState, params: Params,
               lr: torch.Tensor) -> Tuple[Params, SGDPState]:
        mu, damp = self.momentum, self.dampening
        new_buf = tree_map(lambda b, g: mu * b + (1 - damp) * g,
                           state.momentum, grads)
        fg, fb = flatten(grads), flatten(new_buf)
        updates = {}
        for path, p in flatten(params).items():
            g, buf = fg[path], fb[path]
            opts = _leaf_options(self.group_fn, path.replace(".", "/"))
            weight_decay = opts.get("weight_decay", self.weight_decay)
            lr_leaf = lr * opts.get("lr_scale", 1.0)
            d_p = g + mu * buf if self.nesterov else buf
            wd = 1.0
            if p.ndim > 1:
                d_p, wd = _adamp_projection(p, g, d_p, self.delta,
                                            self.wd_ratio, self.eps, False)
            update = -lr_leaf * d_p
            if weight_decay > 0:
                update = update - (lr_leaf * weight_decay * wd
                                   / (1 - mu)) * p
            updates[path] = update
        return unflatten(updates), SGDPState(new_buf)

    def apply(self, grads: Params, state: SGDPState, params: Params,
              lr: torch.Tensor, commit: Optional[torch.Tensor] = None
              ) -> Tuple[Params, SGDPState]:
        """As AdamP's, on the plain path."""
        return _apply_plain(self, grads, state, params, lr, commit)


class RAdamState(NamedTuple):
    step: torch.Tensor
    exp_avg: Params
    exp_avg_sq: Params


@dataclasses.dataclass(frozen=True)
class RAdam:
    """Rectified Adam (Liu et al. 2020): the adaptive step times the
    rectification term while rho_t > 5, a plain bias-corrected momentum
    step before (selects on the device); weight decay is added to the
    gradient."""
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Params) -> RAdamState:
        dev = next(iter(flatten(params).values())).device
        return RAdamState(torch.zeros((), dtype=torch.int32, device=dev),
                          tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    def update(self, grads: Params, state: RAdamState, params: Params,
               lr: torch.Tensor) -> Tuple[Params, RAdamState]:
        b1, b2 = self.betas
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * (b2 ** t) / bc2
        rect = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                          / torch.clamp((rho_inf - 4) * (rho_inf - 2)
                                        * rho_t, min=1e-12))
        use_rect = rho_t > 5.0
        if self.weight_decay:
            grads = tree_map(lambda g, p: g + self.weight_decay * p,
                             grads, params)
        new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                         state.exp_avg, grads)
        new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                         state.exp_avg_sq, grads)

        def leaf(m, v):
            adaptive = -lr * rect / bc1 * m / (torch.sqrt(v / bc2)
                                              + self.eps)
            return torch.where(use_rect, adaptive, -lr / bc1 * m)

        return tree_map(leaf, new_m, new_v), RAdamState(step, new_m, new_v)

    def apply(self, grads: Params, state: RAdamState, params: Params,
              lr: torch.Tensor, commit: Optional[torch.Tensor] = None
              ) -> Tuple[Params, RAdamState]:
        """As AdamP's, on the plain path."""
        return _apply_plain(self, grads, state, params, lr, commit)


class SAMState(NamedTuple):
    e_w: Params          # the current perturbation (zero between steps)
    base_state: Any


@dataclasses.dataclass(frozen=True)
class SAM:
    """Sharpness-aware minimization over a base optimizer, in two phases:

      e_w, st = sam.first_step(grads, params, st)
      ... the gradients at params + e_w ...
      updates, st = sam.second_step(grads_adv, st, params, lr)
    """
    base: Any
    rho: float = 0.05
    adaptive: bool = False

    def init(self, params: Params) -> SAMState:
        return SAMState(tree_map(torch.zeros_like, params),
                        self.base.init(params))

    def first_step(self, grads: Params, params: Params,
                   state: SAMState) -> Tuple[Params, SAMState]:
        fp, fg = flatten(params), flatten(grads)
        sq = [torch.sum(torch.square((torch.abs(fp[k]) if self.adaptive
                                      else 1.0) * fg[k])) for k in fp]
        scale = self.rho / (torch.sqrt(sum(sq)) + 1e-12)
        e_w = tree_map(lambda p, g: (torch.square(p) if self.adaptive
                                     else 1.0) * g * scale, params, grads)
        return e_w, SAMState(e_w, state.base_state)

    def second_step(self, grads_adv: Params, state: SAMState,
                    params: Params, lr: torch.Tensor
                    ) -> Tuple[Params, SAMState]:
        updates, base_state = self.base.update(grads_adv, state.base_state,
                                               params, lr)
        return updates, SAMState(tree_map(torch.zeros_like, state.e_w),
                                 base_state)


def make_group_fn(optimizer_groups: Optional[List[Dict[str, Any]]]
                  ) -> Optional[Callable[[str], Dict[str, Any]]]:
    """Per-leaf overrides from a config `optimizer_groups` list
    [{regex_list: [...], **overrides}, ...]; later groups win."""
    if not optimizer_groups:
        return None
    compiled = [([re.compile(r) for r in g["regex_list"]],
                 {k: v for k, v in g.items() if k != "regex_list"})
                for g in optimizer_groups]

    def group_fn(path: str) -> Dict[str, Any]:
        opts: Dict[str, Any] = {}
        for regexes, overrides in compiled:
            if any(r.search(path) for r in regexes):
                opts.update(overrides)
        return opts

    return group_fn


def make_optimizer(name: str, kwargs: Dict[str, Any],
                   optimizer_groups: Optional[List[Dict[str, Any]]] = None):
    """(transform, base_lr) by config name; SAM's base optimizer from
    `base_optimizer` / `base_optimizer_kwargs`, its lr the base's."""
    kw = dict(kwargs)
    lr = kw.pop("lr", 1e-3)
    group_fn = make_group_fn(optimizer_groups)
    if name in ("AdamP", "Adam", "AdamW"):
        kw["betas"] = tuple(kw.get("betas", (0.9, 0.999)))
        if name != "AdamP":
            # plain Adam is AdamP with the projection never taken
            kw["delta"] = -1.0
        return AdamP(group_fn=group_fn, **kw), lr
    if name == "SGDP":
        return SGDP(group_fn=group_fn, **kw), lr
    if name == "RAdam":
        kw["betas"] = tuple(kw.get("betas", (0.9, 0.999)))
        return RAdam(**kw), lr
    if name == "SAM":
        base, base_lr = make_optimizer(kw.pop("base_optimizer"),
                                       kw.pop("base_optimizer_kwargs", {}),
                                       optimizer_groups)
        return SAM(base=base, **kw), base_lr
    raise ValueError(f"unknown optimizer {name}")
