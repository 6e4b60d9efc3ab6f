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

Usage: python -m hilcodec_tpu_torch.export -c CONFIG [--ckpt PATH]
           [-o OUT] [--device DEV]
"""

import argparse
import os
import sys

import numpy as np

from .utils.checkpoint import load_codec
from .utils.hparams import load_config
from .utils.params import flatten


def export(hps, ckpt, output, device=None) -> str:
    """Write the deploy and cache npz files of `ckpt` (seeded init when
    None) under the prefix `output`; returns the summary line."""
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
    return (f"wrote {output}_deploy.npz ({len(flat)} tensors), "
            f"cache_enc ({len(cache_enc)} tensors / {n_enc} f32), "
            f"cache_dec ({len(cache_dec)} tensors / {n_dec} f32)")


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
                   help="not available in the port (see ROADMAP.md)")
    ns = p.parse_args(argv)
    if ns.stablehlo:
        sys.exit("error: --stablehlo serializes XLA programs and has no "
                 "counterpart in hilcodec_tpu_torch (see ROADMAP.md)")
    print(export(load_config(ns.config), ns.ckpt, ns.output, ns.device))


if __name__ == "__main__":
    main()
