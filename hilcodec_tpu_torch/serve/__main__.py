"""Streaming codec server on the card: N concurrent client streams share one
frame step over a fixed slot batch (see serve/engine.py).

Usage:
  python -m hilcodec_tpu_torch.serve -c CONFIG
      [--params DEPLOY_NPZ | --ckpt CKPT] [--slots S]
      [--mode roundtrip|encode|decode] [-n N_QUANTIZERS]
      [--host H] [--port P] [--gather-ms MS] [--mesh] [--device DEV]

`--params` loads a `{name}_deploy.npz` (folded params + codebooks) written
by `python -m hilcodec_tpu_torch.export` or the JAX package's `export.py`;
`--ckpt` loads a train checkpoint (`{epoch:05d}.ckpt.npz` of either
package) through the trainer's initial state and folds it. Without either
the server runs seeded random weights and N(0, 1) codebooks, for latency
and throughput only. `--mesh` shards the slots over every visible card
(`SlotEngine(devices=...)`; the slots must divide evenly), as serve.py's
`--mesh` does over the JAX devices.
"""

import argparse
import asyncio

from ..models.registry import build_codec_model
from ..parallel.dist import mesh_devices
from ..utils.checkpoint import load_codec
from ..utils.hparams import load_config
from ..utils.params import load_deploy_npz
from . import SlotEngine, serve_forever


def serving_weights(hps, params_path=None, ckpt_path=None, device=None):
    """(model, params, vq_state) to serve: a deploy npz as it was written
    (folded by export), or a train checkpoint, or (with neither) seeded
    random weights, folded."""
    if params_path:
        model = build_codec_model(hps.get("model", "hilcodec"),
                                  hps.model_kwargs.to_dict(), device=device)
        return (model,) + load_deploy_npz(params_path, model, model.device)
    if not ckpt_path:
        print("WARNING: no --params or --ckpt given — serving UNTRAINED "
              "random weights (latency/throughput bench mode; audio output "
              "is garbage)", flush=True)
    model, params, vq_state = load_codec(hps, ckpt_path, device)
    return model, model.fold_params(params), vq_state


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m hilcodec_tpu_torch.serve")
    p.add_argument("-c", "--config", required=True)
    src = p.add_mutually_exclusive_group()
    src.add_argument("--params", default=None,
                     help="{name}_deploy.npz (folded params + codebooks)")
    src.add_argument("--ckpt", default=None,
                     help="train checkpoint {epoch:05d}.ckpt.npz")
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
    p.add_argument("--mesh", action="store_true",
                   help="shard the slots over every visible card")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without it)")
    ns = p.parse_args(argv)

    hps = load_config(ns.config)
    model, params, vq_state = serving_weights(hps, ns.params, ns.ckpt,
                                              ns.device)
    devices = mesh_devices(model.device) if ns.mesh else [model.device]
    print(f"building {ns.slots}-slot engine (mode={ns.mode}) on "
          f"{', '.join(map(str, devices))}...", flush=True)
    engine = SlotEngine(model, params, vq_state, slots=ns.slots,
                        n=ns.num_quantizers, mode=ns.mode, fold=False,
                        devices=devices)
    dt = engine.warmup()
    print(f"warmup done in {dt:.1f}s", flush=True)
    asyncio.run(serve_forever(engine, hps.data.sampling_rate,
                              ns.host, ns.port, gather_ms=ns.gather_ms))


if __name__ == "__main__":
    main()
