"""Export a trained checkpoint to deployment artifacts (the port's
`export.py`).

  * `{OUT}_deploy.npz`    folded inference parameters (weight norm
                          removed, static scales merged) under the JAX
                          leaf paths, plus the RVQ codebooks as
                          `codebooks`; written compressed
  * `{OUT}_cache_enc.npz` / `{OUT}_cache_dec.npz`
                          zero streaming caches, `e_in{i}` / `d_in{i}` in
                          [B, C, L], B = 1

Both packages' servers load the deploy npz (`python -m
hilcodec_tpu_torch.serve --params`, and the JAX package's param tree by
its leaf paths).

With `--program` (the port's counterpart of the JAX `--stablehlo`) it also
writes the one-dispatch streaming steps as `torch.export` programs with
the folded weights and codebooks in them, at `--streams` streams and
`--frames` frames a dispatch, traced on the export device (run them there):

  * `{OUT}_enc.pt2`  (wav [B, 1, F*hop], *cache) -> (tokens, *cache),
                     tokens [n_q, B, F]
  * `{OUT}_dec.pt2`  (tokens [n_q, B, F] int32, *cache) -> (wav, *cache)

Each is the plain frame step (no frame kernels, as the JAX export); the
RVQ cascade is the operator `hilcodec::rvq_cascade`, which launches the
RVQ kernel on the card. Loading one needs `import hilcodec_tpu_torch`
(which registers that operator) and then `torch.export.load(path)
.module()`; unlike the JAX programs, it does not load without the
package. `--stablehlo` itself serializes XLA programs and is refused.

Usage: python -m hilcodec_tpu_torch.export -c CONFIG [--ckpt PATH]
           [-o OUT] [--device DEV] [--program [--streams B] [--frames F]]
"""

import argparse
import os
import sys

import numpy as np
import torch

from .utils.checkpoint import load_codec
from .utils.hparams import load_config
from .utils.params import flatten, unflatten


class _Step(torch.nn.Module):
    """One streaming dispatch of `model` as a module: the folded params and
    the codebooks are its buffers, so `torch.export` saves them in the
    program."""

    def __init__(self, model, params, vq_state, encode: bool, frames: int):
        super().__init__()
        self.model, self.encode, self.frames = model, encode, frames
        self.names = list(flatten(params))
        for i, leaf in enumerate(flatten(params).values()):
            self.register_buffer(f"p{i}", leaf)
        self.register_buffer("embed", vq_state["embed"])

    def forward(self, x, *cache):
        params = unflatten({k: getattr(self, f"p{i}")
                            for i, k in enumerate(self.names)})
        vq_state = {"embed": self.embed}
        step = (self.model.encode_stream if self.encode
                else self.model.decode_stream)
        out, cache = step(params, vq_state, x, list(cache),
                          frames_per_step=self.frames)
        return (out, *cache)


def export_programs(model, params, vq_state, output: str, streams: int = 1,
                    frames: int = 1) -> dict:
    """`torch.export` the plain streaming encode and decode dispatches of
    `model` (folded `params`) at `streams` x `frames` frames on the model's
    device, and save them as {output}_enc.pt2 / {output}_dec.pt2. Returns
    {path: bytes}."""
    hop, n_q = model.hop_length, model.vq.num_quantizers
    dev = model.device
    cache_enc, cache_dec = model.init_cache(streams)
    wav = torch.zeros((streams, 1, frames * hop), device=dev)
    tokens = torch.zeros((n_q, streams, frames), dtype=torch.int32,
                         device=dev)
    written = {}
    with torch.no_grad():
        for name, encode, x, cache in (("enc", True, wav, cache_enc),
                                       ("dec", False, tokens, cache_dec)):
            step = _Step(model, params, vq_state, encode, frames)
            # one eager dispatch first: the per-device constants that the
            # ops cache (STFT bases, windows) are then real tensors, which
            # the trace takes in as constants, and not tensors of the trace
            step(x, *cache)
            prog = torch.export.export(step, (x, *cache))
            path = f"{output}_{name}.pt2"
            torch.export.save(prog, path)
            written[path] = os.path.getsize(path)
    return written


def export(hps, ckpt, output, device=None, program=False, streams=1,
           frames=1) -> str:
    """Write the deploy and cache npz files of `ckpt` (seeded init when
    None) under the prefix `output`, and with `program` the exported
    streaming steps; returns the summary lines."""
    model, params, vq_state = load_codec(hps, ckpt, device,
                                         random_books=False)
    params = model.fold_params(params)

    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    flat = {k: v.detach().cpu().numpy()
            for k, v in flatten(params, sep="/").items()}
    flat["codebooks"] = vq_state["embed"].detach().cpu().numpy()
    with open(f"{output}_deploy.npz", "wb") as f:
        np.savez_compressed(f, **flat)

    cache_enc, cache_dec = model.init_cache(1, device="cpu")
    np.savez(f"{output}_cache_enc.npz",
             **{f"e_in{i}": c.numpy() for i, c in enumerate(cache_enc)})
    np.savez(f"{output}_cache_dec.npz",
             **{f"d_in{i}": c.numpy() for i, c in enumerate(cache_dec)})
    n_enc = sum(c.numel() for c in cache_enc)
    n_dec = sum(c.numel() for c in cache_dec)
    out = (f"wrote {output}_deploy.npz ({len(flat)} tensors), "
           f"cache_enc ({len(cache_enc)} tensors / {n_enc} f32), "
           f"cache_dec ({len(cache_dec)} tensors / {n_dec} f32)")
    if program:
        for path, n in export_programs(model, params, vq_state, output,
                                       streams, frames).items():
            out += (f"\nwrote {path} ({n / 1e6:.1f} MB torch.export "
                    f"program, streams={streams}, frames={frames}, "
                    f"device={model.device})")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m hilcodec_tpu_torch.export",
        description="Without --ckpt the port's seeded init is exported; it "
                    "cannot equal the JAX package's PRNGKey(0) init.")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt", default=None,
                   help="train checkpoint {epoch:05d}.ckpt.npz (either "
                        "package's)")
    p.add_argument("-o", "--output", default="deploy/model")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without it)")
    p.add_argument("--stablehlo", action="store_true",
                   help="not available in the port (see ROADMAP.md); "
                        "--program is its counterpart")
    p.add_argument("--program", action="store_true",
                   help="also write the streaming enc/dec steps as "
                        "torch.export programs {OUT}_enc.pt2 / _dec.pt2 "
                        "(the counterpart of the JAX --stablehlo), traced "
                        "on --device; load with `import hilcodec_tpu_torch` "
                        "(registers the RVQ operator), then "
                        "torch.export.load(path).module()")
    p.add_argument("--streams", type=int, default=1,
                   help="batch dimension of the --program export")
    p.add_argument("--frames", type=int, default=1,
                   help="frames per dispatch in the --program export")
    ns = p.parse_args(argv)
    if ns.stablehlo:
        sys.exit("error: --stablehlo serializes XLA programs and has no "
                 "counterpart in hilcodec_tpu_torch (see ROADMAP.md); "
                 "--program writes torch.export programs")
    if ns.streams < 1 or ns.frames < 1:
        sys.exit("error: --streams and --frames must be positive")
    print(export(load_config(ns.config), ns.ckpt, ns.output, ns.device,
                 ns.program, ns.streams, ns.frames))


if __name__ == "__main__":
    main()
