"""The data-parallel train cell at world 2 over gloo on the CPU, at tiny
widths: a sound run reads correct, with the params equal on both ranks;
one rank's gradient left out of the all-reduce reads not correct. Rank 0
is this process; rank 1 is the child process that
`drivers/train_dp.py` starts."""

import copy
import time

import pytest
import torch

from benchmark import common, harness
from benchmark.tests import tiny

CELL = "hilcodec_speech.train_dp4"


def tiny_cell(seed=2 ** 33 + 29):
    bench = common.benchmark_json()
    c = common.load_cell(bench, CELL, seed, 1.0, False, torch.device("cpu"))
    c.traffic.update(dict(tiny.TRAFFIC["train_steps"], world=2))
    c.config = tiny.tiny_config(copy.deepcopy(c.config))
    return c


def run(c):
    return harness.run_cell(c, common.benchmark_json(), time.perf_counter())


def test_a_sound_run_is_correct():
    res, lines = run(tiny_cell())
    assert res["correct"], lines
    assert res["checks"]["replicas_diverged"]["value"] == 0.0
    assert res["checks"]["children_rc"]["value"] == 0.0
    assert not torch.distributed.is_initialized()


def test_one_ranks_gradient_left_out(monkeypatch):
    from hilcodec_tpu_torch.parallel import dist as D
    real = D.mean_leaves

    def left_out(leaves, group):
        # rank 0 (this process) sends zeros: the mean lacks its gradient
        return real([torch.zeros_like(x) for x in leaves], group)
    monkeypatch.setattr(D, "mean_leaves", left_out)
    res, lines = run(tiny_cell())
    assert not res["correct"], lines


def test_the_collective_span_is_read():
    from benchmark.trace import TraceData
    reader = harness.load_reader("dist.collective_ms.train")
    tr = TraceData((0.0, 100.0), [("nccl", 10.0, 5.0, "kernel", 1)],
                   [("dist.collective", 0.0, 20.0)], {1: 5.0})
    assert reader.read({"trace": tr, "units_profiled": 1}) == \
        pytest.approx(0.005)
    tr = TraceData((0.0, 100.0), [("k", 10.0, 5.0, "kernel", 1)], [],
                   {1: 5.0})
    assert reader.read({"trace": tr, "units_profiled": 1}) is None


def test_the_new_cells_keep_to_the_contract():
    """What the older harness test asks of every cell, as the contract now
    has it: a four-card cell only within the share of cells that may take
    four cards (25% rounded down, or one), and a configuration's `reduced`
    the keys its file says it changed from the source."""
    bench = common.benchmark_json()
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert [w["name"] for w in four] == [CELL]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        for m in harness.cell_metrics(bench, w["name"], True):
            assert m["moves"] in [x["name"] for x in
                                  harness.cell_metrics(bench, w["name"],
                                                       False)]
    for c in bench["configs"]:
        cfg = common.read_json(f"{common.HERE}/../{c['file']}")
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg.get("reduced_note", {})
    for name in ("mimi.transformer_ms_per_frame.stream",
                 "mimi.attn_roofline", "dist.collective_ms.train"):
        m = next(x for x in bench["per_layer"] if x["name"] == name)
        r = harness.load_reader(name)
        assert (r.UNIT, r.SOURCE, r.BETTER, r.LAYER, r.MOVES) == (
            m["unit"], m["source"], m["better"], m["layer"], m["moves"])
