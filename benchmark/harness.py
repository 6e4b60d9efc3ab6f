"""The benchmark's harness: one run of one cell.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

The cell is found by name in `BENCHMARK.json`; its configuration, traffic
mix and check files are read by name (`common.load_cell`), and the
traffic names the driver (`drivers/<driver>.py`) that runs it. A driver
has five functions:

  setup(cell) -> state          build the port's entry, weights and inputs
                                from the seed, warm up every shape
  window(state) -> records      the measured window (with --trace 1, a
                                profiled sub-window at its end)
  release(state)                free the port's state
  check(state, records) -> {name: (value, limit)}
                                the reference's comparison
  work(state) -> {...}          the reference's count of the work a unit
                                does (traced runs only)

Each metric is a reader `metrics/<name>.py` found by the metric's name:
`read(records) -> value or None`. With --trace 0 the line carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics and the
breakdown. The numbers compared close the line, under `checks`, and are
the last lines on standard error.

One extra option, for the control and never used by a check:
`--precision bf16` runs the port's bf16 path in the program's place.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from . import common, guard, trace

HERE = common.HERE


def set_environment(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library may pull in JAX."""
    cache = os.path.join(root, "benchmark", "out", "cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse_args(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    return ap.parse_args(argv)


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def load_reader(name: str):
    """The reader of metric `name` (`metrics/<name>.py`)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool
                 ) -> List[Dict[str, Any]]:
    """The metrics a run of `cell` reports: end-to-end ones untraced,
    per-layer ones traced; a metric without `workloads` is every cell's."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def run_cell(cell: common.Cell, bench: Dict[str, Any], t_start: float
             ) -> Tuple[Dict[str, Any], List[str]]:
    """Run `cell` and return (the result's object, the lines naming each
    number compared beside its limit)."""
    import torch
    from .reference.codec_ref import set_f32

    set_f32()
    torch.set_num_threads(4)
    driver = load_driver(cell.driver)
    t_driver = time.perf_counter()
    state = driver.setup(cell)
    setup_s = time.perf_counter() - t_start
    if cell.trace and cell.device.type == "cuda":
        trace.warm_up(cell.device)
    print(f"setup: {t_driver - t_start:.3f} s of imports and CUDA start, "
          f"{setup_s - (t_driver - t_start):.3f} s of the cell's set-up",
          file=sys.stderr)
    records = driver.window(state)
    records["setup_s"] = setup_s
    dev = cell.device
    cuda = dev.type == "cuda"
    device: Dict[str, Any] = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell.chips,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if cuda else 0)}
    records["peaks"] = common.peaks(device["kind"]) if cuda else None
    if cell.trace:
        records.update(driver.work(state))
    driver.release(state)
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(state, records)
    data = records.get("trace")
    if cell.trace and data is not None:
        device["busy_s"] = data.busy_s()
        device["window_s"] = data.window_s
    metrics = {}
    for m in cell_metrics(bench, cell.name, cell.trace):
        value = load_reader(m["name"]).read(records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (records["failed"] == 0 and all(
        lim is not None and val <= lim for val, lim in checks.values()))
    result = {"correct": correct, "attempted": records["attempted"],
              "failed": records["failed"], "metrics": metrics,
              "device": device}
    if cell.trace and data is not None:
        result["breakdown"] = data.breakdown()
    # a number that is not finite stays readable in the JSON line
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                            "limit": lim} for k, (v, lim) in checks.items()}
    lines = [f"check {k}: {v!r} limit {lim!r}"
             for k, (v, lim) in checks.items()]
    return result, lines


def main(argv: Optional[List[str]], t_start: float) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    root = os.path.dirname(HERE)
    set_environment(root)
    import torch

    bench = common.benchmark_json(root)
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"error: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"error: the cell needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import hilcodec_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the port is not importable: {e}", file=sys.stderr)
        return 2
    cell = common.load_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            args.precision)
    result, lines = run_cell(cell, bench, t_start)
    found = guard.forbidden_modules()
    if found:
        print(f"error: {guard.Forbidden(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
