"""Tiny widths of the benchmark's configurations, for CPU tests."""

import copy
import time

import torch

from benchmark import common, harness

HIL = dict(channels_enc=8, channels_dec=8, n_residual_enc=2,
           n_residual_dec=2, strides=[4, 2], n_fft_base=16)
HIL_VQ = dict(dim=16, codebook_size=32, num_quantizers=3)
TRAIN_VQ = dict(HIL_VQ, kmeans_init=True, decay=0.99, ema_num_threshold=0.5,
                ema_num_initial=0.5, dropout=True, dropout_index=[1, 2, 3])
AUDIODEC = dict(encode_channels=4, decode_channels=16, code_dim=8,
                vq_kwargs=dict(dim=8, codebook_size=32, num_quantizers=3))
DISC = {"mfbd_kwargs": {"use": True, "channels": [4, 8, 8, 8, 8],
                        "kernel_sizes": [5] * 5, "strides": [3, 3, 3, 3, 1]},
        "mpd_kwargs": {"use": False}, "msd_kwargs": {"use": False},
        "mstftd_kwargs": {"use": True, "magnitude": False,
                          "n_ffts": [64, 128], "hop_lengths": [16, 32],
                          "win_lengths": [64, 128], "filters": 4,
                          "filters_scale": 2}}
# traffic at these widths (the tiny HILCodec's hop is 8 samples)
TRAFFIC = {
    "bulk_stream": {"streams": 4, "chunk_frames": 5, "pool_chunks": 3,
                    "profile_chunks": 1},
    "live_engine": {"slots": 4, "session_s": [0.01, 0.04],
                    "profile_s": 0.03, "drain_s": 5.0},
    "train_steps": {"batch": 2, "segment": 4800}}
SECONDS = {"bulk_stream": 0.5, "live_engine": 0.1, "train_steps": 1.0}


def tiny_config(config):
    """`config` at tiny widths."""
    cfg = copy.deepcopy(config)
    mk = cfg["model_kwargs"]
    if cfg["model"] == "hilcodec":
        mk.update(HIL, vq_kwargs=dict(mk["vq_kwargs"], **HIL_VQ))
        if "train" in cfg:
            mk["vq_kwargs"] = dict(TRAIN_VQ)
            cfg["disc_kwargs"] = copy.deepcopy(DISC)
    else:
        mk.update(copy.deepcopy(AUDIODEC))
    return cfg


def cell(name, seed=2 ** 33 + 7, trace=False, precision="f32", bench=None):
    """The cell `name` of BENCHMARK.json at tiny widths on the CPU."""
    bench = bench or common.benchmark_json()
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    traffic = common.read_json(f"{common.HERE}/traffic/"
                               f"{entry['traffic']}.json")
    kind = traffic["driver"]
    c = common.load_cell(bench, name, seed, SECONDS[kind], trace,
                         torch.device("cpu"), precision)
    c.traffic.update(TRAFFIC[kind])
    c.config = tiny_config(c.config)
    return c


def run(c, bench=None):
    """(result, check lines) of a run of cell `c`."""
    return harness.run_cell(c, bench or common.benchmark_json(),
                            time.perf_counter())
