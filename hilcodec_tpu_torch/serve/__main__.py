"""Streaming codec server on the card: N concurrent client streams share one
frame step over a fixed slot batch (see serve/engine.py).

Usage:
  python -m hilcodec_tpu_torch.serve -c CONFIG [--params DEPLOY_NPZ]
      [--slots S] [--mode roundtrip|encode|decode] [-n N_QUANTIZERS]
      [--host H] [--port P] [--gather-ms MS] [--device DEV]

`--params` loads a `{name}_deploy.npz` written by the JAX package's
`export.py` (folded params + codebooks). Without it the server runs seeded
random weights and N(0, 1) codebooks, for latency and throughput only.
"""

import argparse
import asyncio

import torch

from ..models.registry import build_codec_model
from ..utils.hparams import load_config
from ..utils.params import load_deploy_npz
from . import SlotEngine, serve_forever


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m hilcodec_tpu_torch.serve")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--params", default=None,
                   help="JAX {name}_deploy.npz (folded params + codebooks)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = pick a free port (printed at startup)")
    p.add_argument("--slots", type=int, default=16)
    p.add_argument("--mode", default="roundtrip",
                   choices=["roundtrip", "encode", "decode"])
    p.add_argument("-n", "--num_quantizers", type=int, default=None)
    p.add_argument("--gather-ms", type=float, default=0.0,
                   help="micro-batch window: wait this many ms after the "
                        "first pending frame so more slots join each tick")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without it)")
    ns = p.parse_args(argv)

    hps = load_config(ns.config)
    model = build_codec_model(hps.get("model", "hilcodec"),
                              hps.model_kwargs.to_dict(), device=ns.device)
    if ns.params:
        params, vq_state = load_deploy_npz(ns.params, model, model.device)
        fold = False
    else:
        gen = torch.Generator().manual_seed(0)
        params, vq_state = model.init(gen)
        vq_state["embed"] = torch.randn(
            tuple(vq_state["embed"].shape), generator=gen
        ).to(model.device)
        fold = True
        print("WARNING: no --params given — serving UNTRAINED random weights "
              "(latency/throughput bench mode; audio output is garbage)",
              flush=True)
    print(f"building {ns.slots}-slot engine (mode={ns.mode}) on "
          f"{model.device}...", flush=True)
    engine = SlotEngine(model, params, vq_state, slots=ns.slots,
                        n=ns.num_quantizers, mode=ns.mode, fold=fold,
                        device=model.device)
    dt = engine.warmup()
    print(f"warmup done in {dt:.1f}s", flush=True)
    asyncio.run(serve_forever(engine, hps.data.sampling_rate,
                              ns.host, ns.port, gather_ms=ns.gather_ms))


if __name__ == "__main__":
    main()
