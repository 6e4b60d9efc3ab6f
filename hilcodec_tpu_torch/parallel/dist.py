"""Data parallelism over `torch.distributed` (`hilcodec_tpu/parallel/mesh.py`).

One process per card, started by `python -m torch.distributed.run`
(torchrun). `init_from_env` joins the default group from torchrun's
environment: NCCL on `cuda:LOCAL_RANK`, or gloo for a run on the CPU.
The train step places an explicit collective at each site where the JAX
step has one inside its `shard_map` (grads, metrics, VQ statistics and
expiry candidates, balancer norms): the helpers here. Every helper takes
the group and does nothing when it is None, so the single-process step
runs no collective; at world 1 each leaves its input bit for bit as it
was (a sum over one rank, a division by 1). Each collective runs
inside the span `dist.collective` (`utils/spans.py`), opened only where
a group is given. The tensors a collective
takes lie on the trainer's device; `comm_device` is the device of the
host-side reductions (the card under NCCL, the CPU under gloo).

`shard_slots` splits a serving engine's slots over devices, the
counterpart of `shard_streams`: streams are independent, so a slot range
per device needs no collective at all. `place_shards` gives each device
its slot range, a model bound to it and its own copy of the weights; the
engine and `bench --mesh` place their shards with it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.params import flatten

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def launched_by_torchrun() -> bool:
    """True when torchrun's environment names this process's rank."""
    return all(k in os.environ for k in _TORCHRUN_ENV)


def init_from_env(device=None) -> torch.device:
    """Join the default process group from torchrun's RANK / WORLD_SIZE /
    LOCAL_RANK / MASTER_ADDR (and MASTER_PORT): gloo when `device` names
    the CPU, else NCCL on `cuda:LOCAL_RANK`, which must exist. Returns the
    device this rank trains on."""
    if not launched_by_torchrun():
        raise RuntimeError(
            f"init_from_env needs torchrun's environment {_TORCHRUN_ENV}; "
            f"launch with python -m torch.distributed.run")
    local = int(os.environ["LOCAL_RANK"])
    if device is not None and torch.device(device).type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu "
                               "to train data-parallel on the CPU (gloo)")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but only "
                               f"{torch.cuda.device_count()} card(s)")
        backend, dev = "nccl", torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return dev


def default_group():
    """The default group when one is initialized, else None (a single
    process: no collectives)."""
    return dist.group.WORLD if dist.is_initialized() else None


def world(group=None) -> int:
    """Ranks in `group` (the default group when None); 1 without a group."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in `group`; 0 without a group."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def comm_device(group=None) -> torch.device:
    """Where a host-side reduction's tensor lives: the current card under
    NCCL, the CPU otherwise."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _collective():
    """The span `dist.collective`, imported where a collective runs."""
    from ..utils.spans import span
    return span("dist.collective")


# -- collectives on the trainer's tensors (identity for group None) ----------
def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group's ranks (a new tensor)."""
    if group is None:
        return x
    out = x.contiguous().clone()
    with _collective():
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def mean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean of x over the group's ranks (JAX's pmean: psum / n)."""
    if group is None:
        return x
    return all_sum(x, group) / dist.get_world_size(group)


def broadcast0(x: torch.Tensor, group) -> torch.Tensor:
    """Rank 0's x on every rank (JAX's all_gather(x)[0])."""
    if group is None:
        return x
    out = x.contiguous().clone()
    with _collective():
        dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x (of one shape), concatenated on axis 0 in rank
    order."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    with _collective():
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def mean_leaves(leaves: Sequence[torch.Tensor], group
                ) -> List[torch.Tensor]:
    """The mean over ranks of every tensor of `leaves`, in f32, through one
    all_reduce of one flat bucket."""
    if group is None:
        return list(leaves)
    flat = torch.cat([x.float().reshape(-1) for x in leaves])
    flat = mean(flat, group)
    out, i = [], 0
    for x in leaves:
        out.append(flat[i:i + x.numel()].view(x.shape))
        i += x.numel()
    return out


# -- host-side reductions ----------------------------------------------------
def barrier(group=None) -> None:
    """Wait for every rank (nothing without a group of two or more)."""
    if world(group) > 1:
        with _collective():
            dist.barrier(group)


def process_mean(value: float, weight: float = 1.0, group=None) -> float:
    """Weighted mean of a per-process value over the processes; the value
    itself without a group."""
    if world(group) == 1:
        return value
    t = torch.tensor([value * weight, weight], dtype=torch.float64,
                     device=comm_device(group))
    with _collective():
        dist.all_reduce(t, group=group)
    return float(t[0] / max(float(t[1]), 1e-12))


def all_sum_host(values: Sequence[float], group=None) -> np.ndarray:
    """Elementwise sum over the processes of a vector of host numbers, in
    f64."""
    arr = np.asarray(values, np.float64)
    if world(group) == 1:
        return arr
    t = torch.from_numpy(arr).to(comm_device(group))
    with _collective():
        dist.all_reduce(t, group=group)
    return t.cpu().numpy()


def assert_replicas_consistent(tree: Any, rtol: float = 1e-6,
                               atol: float = 1e-7, group=None) -> None:
    """Every leaf of `tree` equal (within rtol / atol) to rank 0's copy.
    Every rank raises the same AssertionError, naming the first diverged
    leaf, so that no rank is left waiting in a later collective."""
    if world(group) == 1:
        return
    group = group or dist.group.WORLD
    flat = flatten(tree)
    names = list(flat)
    mine = torch.cat([v.detach().double().reshape(-1)
                      for v in flat.values()])
    ref = broadcast0(mine, group)
    bad = len(names)
    i = 0
    for j, v in enumerate(flat.values()):
        a, b = mine[i:i + v.numel()], ref[i:i + v.numel()]
        i += v.numel()
        if not bool(torch.all(torch.abs(a - b) <= atol + rtol * b.abs())):
            bad = j
            break
    first = torch.tensor([bad], dtype=torch.int64, device=mine.device)
    with _collective():
        dist.all_reduce(first, op=dist.ReduceOp.MIN, group=group)
    if int(first) < len(names):
        raise AssertionError(f"replica divergence at {names[int(first)]} "
                             f"(rank {rank(group)} of {world(group)})")


# -- serving -------------------------------------------------------------------
def shard_slots(slots: int, n_shards: int) -> List[range]:
    """The slot range of each of `n_shards` devices; the slots must divide
    evenly."""
    if n_shards < 1 or slots % n_shards:
        raise ValueError(f"{slots} slots do not divide evenly over "
                         f"{n_shards} devices")
    per = slots // n_shards
    return [range(k * per, (k + 1) * per) for k in range(n_shards)]


def place_shards(model, params, vq_state, devices: Sequence,
                 slots: int) -> List[Tuple[Any, Any, Dict, range]]:
    """[(model, params, vq_state, rows)] of each of `devices`: the slots
    split evenly (`shard_slots`), the `CodecModel` bound to the device
    and its own copy of the params and the VQ state there."""
    out = []
    for d, rows in zip(devices, shard_slots(slots, len(devices))):
        m = dataclasses.replace(model, device=torch.device(d))
        out.append((m, *m.to_device(params, vq_state), rows))
    return out


def mesh_devices(device) -> List[torch.device]:
    """The devices `--mesh` spans: every visible card for a CUDA device,
    else `device` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]
