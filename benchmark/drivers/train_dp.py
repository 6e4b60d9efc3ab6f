"""Data-parallel training: the flagship's train step at world `world`, one
rank a card, as `train.py` runs it under torchrun.

Rank 0 is the harness's process on card 0; `setup` starts ranks 1 to
world - 1 as child processes (`python -m benchmark.drivers.train_dp
<cell file> <rank>`) with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), so every rank joins the group
through the port's `parallel/dist.init_from_env` (NCCL on
`cuda:LOCAL_RANK`, gloo on the CPU) and builds its trainer with
`build_trainer(..., group=default_group())`. Each rank starts from the
same weights (the reference's init from the seed), takes its own
`batch` rows of speech-band noise a step, made on its card from the seed,
the step and its rank, and the same quantizer draws. The step places its
own collectives (gradients, metrics, VQ statistics and expiry
candidates, balancer norms).

Set-up runs `checked_steps` steps on every rank, keeps rank 0's losses,
first moments after step 1 and params after the last, and asks
`assert_replicas_consistent` whether every rank holds rank 0's params.
The window chains steps on every rank until rank 0's clock says stop:
before each step rank 0 tells the others, over a gloo group of their
hosts, whether there is one (so no card waits on it); a traced run
profiles `profile_steps` more on rank 0. After the window every rank
frees the program's state and runs the frozen reference's
`checked_steps` steps from the same state, batches and draws, over the
same group, with the reference's own copy of the collectives; rank 0
compares them in `check`, as `train_steps` does, and the children exit.

Records: audio_s (steps x world x batch x segment seconds) / wall_s /
units (steps) of the window, units_profiled, attempted (steps), failed
(steps whose finite flag, meaned over the ranks, is under 1), and from
`work` one rank's reference FLOPs a step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict

import torch

from .. import common
from ..reference import train_ref
from ..trace import Profiled
from . import port, train_steps

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(rank: int, world: int, master_port: int) -> Dict[str, str]:
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(master_port)}


def _batch(cell: common.Cell, k: int, rank: int,
           device: torch.device) -> torch.Tensor:
    tr = cell.traffic
    gen = common.device_generator(device, common.sub_seed(cell.seed,
                                                          100 + k, rank))
    return common.speech_band(gen, tr["batch"], tr["segment"], device)


def _cell_file(cell: common.Cell) -> str:
    """The cell as the children read it: its files may differ from
    BENCHMARK.json's (tests run it at tiny widths)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="train_dp_")
    with os.fdopen(fd, "w") as f:
        json.dump({"name": cell.name, "config_name": cell.config_name,
                   "traffic_name": cell.traffic_name, "chips": cell.chips,
                   "config": cell.config, "traffic": cell.traffic,
                   "check": cell.check, "seed": cell.seed,
                   "seconds": cell.seconds, "trace": cell.trace,
                   "device": cell.device.type,
                   "precision": cell.precision}, f)
    return path


def _join(cell: common.Cell, rank: int) -> Dict[str, Any]:
    """Join the group, build the trainer and run the checked steps."""
    from hilcodec_tpu_torch.parallel import dist as D
    from hilcodec_tpu_torch.train.loop import build_trainer
    import torch.distributed as tdist
    dev = D.init_from_env("cpu" if cell.device.type == "cpu" else None)
    group = D.default_group()
    flags = tdist.new_group(backend="gloo")
    cfg = cell.config
    if cell.precision == "bf16":
        cfg = dict(cfg, train=dict(cfg["train"], compute_dtype="bfloat16"))
    trainer = build_trainer(port.hparams(cfg), dev, group=group)
    ref = train_ref.build(cell.config, "cpu")
    weights = train_ref.make_weights(ref, common.sub_seed(cell.seed, 0))
    state = train_steps._program_state(
        trainer, weights, train_ref.start_iteration(cell.config))
    st = dict(cell=cell, rank=rank, device=dev, group=group, flags=flags,
              trainer=trainer, losses=[])
    for k in range(cell.traffic["checked_steps"]):
        wav = _batch(cell, k, rank, dev)
        state, m = trainer.train_step(
            state, wav,
            trainer.sample_draws(train_steps._draw_gen(cell, k), wav.shape))
        st["losses"].append({key: float(v) for key, v in m.items()
                             if key.startswith("loss/")})
        if k == 0:
            st["m1_g"] = train_steps._clone(state.opt_g.exp_avg)
            st["m1_d"] = train_steps._clone(state.opt_d.exp_avg)
    st["p_g"] = train_steps._clone(state.params_g)
    st["p_d"] = train_steps._clone(state.params_d)
    try:
        D.assert_replicas_consistent({"g": state.params_g,
                                      "d": state.params_d}, group=group)
        st["diverged"] = 0.0
    except AssertionError as e:
        print(f"train_dp rank {rank}: {e}", file=sys.stderr)
        st["diverged"] = 1.0
    st["state"], st["next"] = state, cell.traffic["checked_steps"]
    return st


def _announce(st: Dict[str, Any], go: bool) -> bool:
    """Rank 0's word to every rank's host: one more step, or none."""
    import torch.distributed as tdist
    t = torch.tensor([1 if go else 0], dtype=torch.int32)
    tdist.broadcast(t, src=0, group=st["flags"])
    return bool(t[0])


def _step(st: Dict[str, Any]) -> None:
    cell, trainer = st["cell"], st["trainer"]
    k = st["next"]
    with torch.profiler.record_function("train_step"):
        wav = _batch(cell, k, st["rank"], st["device"])
        st["state"], m = trainer.train_step(
            st["state"], wav,
            trainer.sample_draws(train_steps._draw_gen(cell, k), wav.shape))
    st["finite"].append(m["finite"])
    st["next"] = k + 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(st: Dict[str, Any], until: float = None, steps: int = None) -> int:
    """Rank 0: steps until the clock passes `until` (or `steps` steps),
    each announced to the other ranks first."""
    k0 = st["next"]
    while (time.perf_counter() < until) if until is not None \
            else (st["next"] < k0 + steps):
        _announce(st, True)
        _step(st)
    _sync(st["device"])
    return st["next"] - k0


def setup(cell: common.Cell) -> Dict[str, Any]:
    world = cell.traffic["world"]
    if cell.device.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"world {world} needs {world} cards, "
                           f"{torch.cuda.device_count()} visible")
    master = _free_port()
    saved = {k: os.environ.get(k) for k in _ENV}
    path = _cell_file(cell)
    root = os.path.dirname(common.HERE)
    children = []
    for r in range(1, world):
        env = dict(os.environ, **_env(r, world, master))
        children.append(subprocess.Popen(
            [sys.executable, "-m", "benchmark.drivers.train_dp", path,
             str(r)], cwd=root, env=env, stdout=subprocess.DEVNULL))
    os.environ.update(_env(0, world, master))
    try:
        st = _join(cell, 0)
    except BaseException:
        for child in children:
            child.kill()
        raise
    st.update(children=children, saved_env=saved, cell_file=path)
    return st


def window(st: Dict[str, Any]) -> Dict[str, Any]:
    cell, tr = st["cell"], st["cell"].traffic
    world = tr["world"]
    st["finite"] = []
    t0 = time.perf_counter()
    steps = _run(st, until=t0 + cell.seconds)
    wall = time.perf_counter() - t0
    rec: Dict[str, Any] = {
        "audio_s": steps * world * tr["batch"] * tr["segment"]
        / common.SAMPLE_RATE,
        "wall_s": wall, "units": steps, "precision": cell.precision}
    if cell.trace:
        with Profiled(cell.device) as p:
            done = _run(st, steps=tr["profile_steps"])
        rec["trace"], rec["units_profiled"] = p.data, done
    _announce(st, False)
    finite = torch.stack(st["finite"]).float().cpu()
    rec["attempted"] = int(finite.numel())
    rec["failed"] = int((finite < 1).sum())
    return rec


def work(st: Dict[str, Any]) -> Dict[str, Any]:
    tr = st["cell"].traffic
    ref = train_ref.build(st["cell"].config, "cpu")
    return {"flops_per_unit": train_ref.step_flops(ref, tr["batch"],
                                                   tr["segment"])}


def release(st: Dict[str, Any]) -> None:
    for key in ("trainer", "state", "finite"):
        st.pop(key, None)


def _reference(cell: common.Cell, st: Dict[str, Any]) -> Dict[str, Any]:
    """The frozen reference's checked steps on this rank's shard, over the
    same group; returns rank 0's readings."""
    dev = st["device"]
    ref = dataclasses.replace(train_ref.build(cell.config, dev),
                              group=st["group"])
    weights = train_ref.make_weights(ref, common.sub_seed(cell.seed, 0))
    state = train_ref.init_state(ref, weights,
                                 train_ref.start_iteration(cell.config))
    out = {"p0_g": train_steps._clone(state.params_g),
           "p0_d": train_steps._clone(state.params_d), "losses": []}
    for k in range(cell.traffic["checked_steps"]):
        wav = _batch(cell, k, st["rank"], dev)
        state, m = ref.train_step(
            state, wav, ref.sample_draws(train_steps._draw_gen(cell, k),
                                         wav.shape))
        out["losses"].append({key: float(v) for key, v in m.items()
                              if key.startswith("loss/")})
        if k == 0:
            out["r1_g"] = train_steps._clone(state.opt_g.exp_avg)
            out["r1_d"] = train_steps._clone(state.opt_d.exp_avg)
    out["r_g"] = train_steps._clone(state.params_g)
    out["r_d"] = train_steps._clone(state.params_d)
    out["b1"] = ref.optim_g.betas[0]
    return out


def _finish(st: Dict[str, Any]) -> int:
    """Leave the group; rank 0 also waits for the children and puts the
    environment back. Returns the worst child exit code."""
    import torch.distributed as tdist
    if tdist.is_initialized():
        tdist.destroy_process_group()
    worst = 0
    for child in st.get("children", []):
        try:
            rc = child.wait(timeout=300)
        except subprocess.TimeoutExpired:
            child.kill()
            rc = -9
        worst = max(worst, abs(rc))
    for k, v in st.get("saved_env", {}).items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    if st.get("cell_file"):
        os.remove(st["cell_file"])
    return worst


def check(st: Dict[str, Any], rec: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's first steps over the same shards, as `train_steps`
    holds the single-card step; besides, whether every rank held rank
    0's params after the checked steps, and the children's exit."""
    cell = st["cell"]
    try:
        r = _reference(cell, st)
    finally:
        children_rc = _finish(st)
    loss_gap = 0.0
    for k, mine in enumerate(st["losses"]):
        for key, v in mine.items():
            x = r["losses"][k][key]
            loss_gap = max(loss_gap, abs(v - x) / max(abs(x), 1e-6))
    b1 = r["b1"]
    grad_gap = delta_gap = 0.0
    for side in ("g", "d"):
        g_ref = {k: v / (1 - b1) for k, v in r[f"r1_{side}"].items()}
        g_prog = {k: v / (1 - b1) for k, v in st[f"m1_{side}"].items()}
        gap, at, out = train_ref.norm_gap(g_prog, g_ref, g_ref)
        p0 = r[f"p0_{side}"]
        dgap, dat, _ = train_ref.norm_gap(
            {k: st[f"p_{side}"][k] - p0[k] for k in p0},
            {k: r[f"r_{side}"][k] - p0[k] for k in p0}, g_ref)
        print(f"train_dp check {side}: first gradients {gap:.3e} at {at}, "
              f"changes {dgap:.3e} at {dat}, {out} of {len(g_ref)} leaves "
              f"left out", file=sys.stderr)
        grad_gap, delta_gap = max(grad_gap, gap), max(delta_gap, dgap)
    lim = cell.check.get("limits", {})
    return {"loss_gap": (loss_gap, lim.get("loss_gap")),
            "grad1_gap": (grad_gap, lim.get("grad1_gap")),
            "delta3_gap": (delta_gap, lim.get("delta3_gap")),
            "replicas_diverged": (st["diverged"],
                                  lim.get("replicas_diverged")),
            "children_rc": (float(children_rc), lim.get("children_rc"))}


def _child(path: str, rank: int) -> int:
    """Rank `rank` of the cell in the file `path`: the checked steps, the
    window's steps as rank 0 announces them, then the reference's."""
    with open(path) as f:
        d = json.load(f)
    # a rank left behind by rank 0 (its process gone) ends itself rather
    # than hold its card waiting in a collective
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(2.0)
            if os.getppid() != parent:
                os._exit(1)
    threading.Thread(target=watch, daemon=True).start()
    from benchmark.reference.codec_ref import set_f32
    set_f32()
    torch.set_num_threads(4)
    dev = torch.device("cuda", rank) if d["device"] == "cuda" \
        else torch.device("cpu")
    cell = common.Cell(d["name"], d["config_name"], d["traffic_name"],
                       d["chips"], d["config"], d["traffic"], d["check"],
                       d["seed"], d["seconds"], d["trace"], dev,
                       d["precision"])
    st = _join(cell, rank)
    st["finite"] = []
    while _announce(st, False):
        _step(st)
    _sync(st["device"])
    release(st)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _reference(cell, st)
    _finish(st)
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
