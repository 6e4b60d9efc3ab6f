"""The check that decides `correct`, on the CPU at tiny widths: a sound
run passes, and the control (the port's own bf16 path in its place) and
each fault a cell can have come out not correct. The runs skip the
harness's look for a card and drive the rest of a run
(`harness.run_cell`) with the cells' own limits."""

import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

STREAM_CELLS = ["hilcodec_speech.bulk_fk1024", "audiodec_24k.bulk1024",
                "hilcodec_speech.live_decode"]
TRAIN = "hilcodec_speech.train_b24"


@pytest.mark.parametrize("name", STREAM_CELLS + [TRAIN])
def test_a_sound_run_is_correct(name):
    res, lines = tiny.run(tiny.cell(name))
    assert res["correct"], lines
    assert list(res)[-1] == "checks"
    assert all(v["limit"] is not None for v in res["checks"].values())


@pytest.mark.parametrize("name", STREAM_CELLS + [TRAIN])
def test_the_control_is_not_correct(name):
    res, lines = tiny.run(tiny.cell(name, precision="bf16"))
    assert not res["correct"], lines


@pytest.mark.parametrize("name", STREAM_CELLS[:2])
def test_a_token_altered_where_it_is_produced(name, monkeypatch):
    from hilcodec_tpu_torch.models import codec
    quantize = codec.rvq_kernel.quantize

    def altered(x, books, n=None):
        idx = quantize(x, books, n).clone()
        idx[-1, 0, 0] = (idx[-1, 0, 0] + 1) % books.shape[1]
        return idx
    monkeypatch.setattr(codec.rvq_kernel, "quantize", altered)
    res, lines = tiny.run(tiny.cell(name))
    assert not res["correct"], lines


@pytest.mark.parametrize("name", STREAM_CELLS)
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    from hilcodec_tpu_torch.models.codec import CodecModel
    decode = CodecModel.decode_stream

    def altered(self, *a, **k):
        wav, cache = decode(self, *a, **k)
        wav = wav.clone()
        wav[0, 0, -1] += 0.01
        return wav, cache
    monkeypatch.setattr(CodecModel, "decode_stream", altered)
    res, lines = tiny.run(tiny.cell(name))
    assert not res["correct"], lines


def test_a_train_step_that_returns_its_state_unchanged(monkeypatch):
    from hilcodec_tpu_torch.train import step
    real = step.Trainer.train_step

    def unchanged(self, state, wav, draws):
        _, metrics = real(self, state, wav, draws)
        return state, metrics
    monkeypatch.setattr(step.Trainer, "train_step", unchanged)
    res, lines = tiny.run(tiny.cell(TRAIN))
    assert not res["correct"], lines


def test_a_train_step_that_leaves_out_half_the_batch(monkeypatch):
    from hilcodec_tpu_torch.train import step
    real = step.Trainer.train_step

    def half(self, state, wav, draws):
        b = wav.shape[0] // 2
        rows = b * (wav.shape[-1] // self.model.hop_length)
        draws = dataclasses.replace(draws,
                                    expire_idx=draws.expire_idx % rows)
        return real(self, state, wav[:b], draws)
    monkeypatch.setattr(step.Trainer, "train_step", half)
    res, lines = tiny.run(tiny.cell(TRAIN))
    assert not res["correct"], lines


def test_a_traced_run_reads_its_trace():
    res, _ = tiny.run(tiny.cell(STREAM_CELLS[0], trace=True))
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device operation on the CPU: the device readers find nothing
    assert "idle.stream" not in res["metrics"]
    assert torch.device("cpu").type == res["device"]["platform"]
