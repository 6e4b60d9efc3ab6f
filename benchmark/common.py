"""What every driver of the benchmark shares: where its files are, how a
cell is read from them, the seeded inputs and weights, and the int16
wire format.

A cell is found by name: `BENCHMARK.json` names its configuration and its
traffic mix, and the harness reads `configs/<config>.json`,
`traffic/<traffic>.json` and `workloads/<cell>.json` beside this file.
The traffic file names the driver (`drivers/<driver>.py`) that runs it.
Nothing here imports the port: the drivers do, and the reference never.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLE_RATE = 24000
# the leaves the codecs initialize at zero (`zero_init`): a trained model
# has them nonzero, and at zero they fold the branches they scale away
ZERO_INIT_LEAVES = ("res_scale_param", "scale_param")


def read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Optional[str] = None) -> Dict[str, Any]:
    """`BENCHMARK.json` at the root of the checkout."""
    return read_json(os.path.join(root or os.path.dirname(HERE),
                                  "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One workload as the harness runs it."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    check: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    precision: str = "f32"

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_cell(bench: Dict[str, Any], name: str, seed: int, seconds: float,
              trace: bool, device: torch.device, precision: str = "f32"
              ) -> Cell:
    """The cell `name` of `bench` with its configuration, traffic and
    check files read by name."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = read_json(os.path.join(os.path.dirname(HERE), conf["file"]))
    traffic = read_json(os.path.join(HERE, "traffic",
                                     entry["traffic"] + ".json"))
    check_path = os.path.join(HERE, "workloads", name + ".json")
    check = read_json(check_path) if os.path.exists(check_path) else {}
    return Cell(name, entry["config"], entry["traffic"], entry["chips"],
                config, traffic, check, seed, seconds, trace, device,
                precision)


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one use of the run's seed (any size of integer):
    the weights, a traffic pool, one step's batch."""
    ss = np.random.SeedSequence([seed % (1 << 64), *keys])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def fill_zero_init(params: Any, gen: torch.Generator) -> Any:
    """`params` with every zero-init scale drawn from U(0.5, 1.5)."""
    if isinstance(params, dict):
        return {k: (0.5 + torch.rand(v.shape, generator=gen)
                    if k in ZERO_INIT_LEAVES else fill_zero_init(v, gen))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(fill_zero_init(v, gen) for v in params)
    return params


def speech_band(gen: torch.Generator, rows: int, samples: int,
                device: torch.device) -> torch.Tensor:
    """[rows, 1, samples] of speech-band noise: white noise shaped to
    80-7000 Hz with a -6 dB / octave tilt above 500 Hz, under a syllabic
    (3-6 Hz) envelope, at -26 to -14 dBFS RMS a row."""
    x = torch.randn((rows, samples), generator=gen, device=device)
    spec = torch.fft.rfft(x)
    f = torch.fft.rfftfreq(samples, 1.0 / SAMPLE_RATE).to(device)
    shape = ((f >= 80) & (f <= 7000)).float() / torch.clamp(f / 500.0,
                                                           min=1.0)
    x = torch.fft.irfft(spec * shape, n=samples)
    t = torch.arange(samples, device=device) / SAMPLE_RATE
    rate = 3.0 + 3.0 * torch.rand((rows, 1), generator=gen, device=device)
    phase = 6.2831853 * torch.rand((rows, 1), generator=gen, device=device)
    env = (0.5 + 0.5 * torch.sin(6.2831853 * rate * t + phase)) ** 2
    x = x * (0.1 + env)
    db = -26.0 + 12.0 * torch.rand((rows, 1), generator=gen, device=device)
    x = x / x.pow(2).mean(dim=1, keepdim=True).sqrt() * 10.0 ** (db / 20.0)
    return torch.clamp(x, -1.0, 1.0).unsqueeze(1)


def device_generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def to_int16(wav: torch.Tensor) -> torch.Tensor:
    """The int16 wire format of a [-1, 1] waveform: round half to even,
    clip."""
    return torch.clamp(torch.round(wav.float() * 32768.0), -32768,
                       32767).to(torch.int16)


def peaks(device_name: str) -> Dict[str, float]:
    """The peaks of the card the run is on (`peaks.json`, by a part of
    its name)."""
    table = read_json(os.path.join(HERE, "peaks.json"))
    name = device_name.lower()
    for key, val in table["cards"].items():
        if key in name:
            return val
    raise KeyError(f"no peaks for {device_name!r} in peaks.json")
