"""Train the token LM (the range coder's entropy model) on a trained
codec's tokens: the port's counterpart of `scripts/train_lm.py`, with its
flags, tokenizer, warm-up and cosine schedule and LM checkpoint.

It tokenizes a corpus with a codec checkpoint (train segments overlap by
half a segment), trains `models/encodec.LMModel` with next-step
cross-entropy (`train/lm.py`, Adam), and reports the held-out bits a token
against the fixed log2(card) of raw tokens, at step 0, every 200 steps and
at the end. The LM checkpoint (`{steps:05d}.ckpt.npz` under --out) loads
in both packages.

Usage:
  python -m hilcodec_tpu_torch.train_lm -c CONFIG --ckpt CODEC_CKPT
      --data CORPUS [--steps 3000] [--batch 32] [--seg-tokens 150]
      [--n-q N] [--dim 200 --heads 8 --layers 5] [--lr 3e-4]
      [--out LM_DIR] [--device DEV]

CORPUS holds train/ and eval/ wav directories (the layout of
`scripts/make_synth_corpus.py`). Runs on the card unless --device names
another device.
"""

import argparse
import math
import os
import time

import numpy as np
import torch

LOG_EVERY = 200


def load_folded_codec(config: str, ckpt: str, device=None):
    """(hps, model, folded params, vq_state) of a codec checkpoint."""
    from .utils.checkpoint import load_codec
    from .utils.hparams import load_config
    hps = load_config(config)
    model, params, vq_state = load_codec(hps, ckpt, device)
    return hps, model, model.fold_params(params), vq_state


@torch.no_grad()
def tokenize_dir(model, params, vq_state, wav_dir, seg_tokens, n_q,
                 batch=32, stride_tokens=None) -> np.ndarray:
    """Encode every wav under wav_dir into seg_tokens-frame segments
    (stride_tokens < seg_tokens: overlapping segments) -> int32
    [N_seg, n_q, seg_tokens]."""
    from .utils.wavio import read_wav
    hop = model.hop_length
    seg_samples = seg_tokens * hop
    stride = (stride_tokens or seg_tokens) * hop
    segs = []
    for root, _dirs, files in os.walk(wav_dir):
        for f in sorted(files):
            if not f.lower().endswith(".wav"):
                continue
            wav, _sr = read_wav(os.path.join(root, f))
            for i in range(0, len(wav) - seg_samples + 1, stride):
                segs.append(wav[i:i + seg_samples])
    if not segs:
        raise SystemExit(f"no usable wavs under {wav_dir}")
    segs = np.stack(segs).astype(np.float32)[:, None, :]   # [N, 1, T]
    pad = (-len(segs)) % batch
    padded = np.concatenate([segs, segs[:pad]]) if pad else segs
    out = []
    for i in range(0, len(padded), batch):
        x = torch.from_numpy(padded[i:i + batch]).to(model.device)
        toks = model.encode(params, vq_state, x, n=n_q)
        out.append(toks.permute(1, 0, 2).cpu().numpy())     # [B, n_q, T']
    return np.concatenate(out)[: len(segs)].astype(np.int32)


def lr_at(it: int, base: float, steps: int, warmup: int) -> float:
    """Linear warm-up, then a cosine decay to 0 at `steps`."""
    return base * min(1.0, it / max(warmup, 1)) * 0.5 * (
        1 + math.cos(math.pi * max(0, it - warmup) / max(1, steps - warmup)))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m hilcodec_tpu_torch.train_lm")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data", default="data/synth",
                   help="corpus root with train/ and eval/ wav dirs")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seg-tokens", type=int, default=150,
                   help="LM context length in frames (train segments "
                        "stride seg/2)")
    p.add_argument("--n-q", type=int, default=None,
                   help="quantizers to model (default: the codec's full "
                        "ladder)")
    p.add_argument("--dim", type=int, default=200)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--out", default=None, help="save LM params here")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without it)")
    ns = p.parse_args(argv)

    from .models.encodec import LMModel
    from .train.lm import lm_cross_entropy, lm_train_step
    from .train.optim import make_optimizer
    from .utils.checkpoint import save_checkpoint

    hps, model, params, vq_state = load_folded_codec(ns.config, ns.ckpt,
                                                     ns.device)
    dev = model.device
    n_q = ns.n_q or int(vq_state["embed"].shape[0])
    card = int(vq_state["embed"].shape[1])
    hop = model.hop_length
    fps = hps.data.sampling_rate / hop
    raw_bits = math.log2(card)

    print(f"tokenizing: n_q={n_q} card={card} hop={hop} "
          f"seg={ns.seg_tokens} tokens", flush=True)
    train_toks = tokenize_dir(model, params, vq_state,
                              os.path.join(ns.data, "train"), ns.seg_tokens,
                              n_q, stride_tokens=max(1, ns.seg_tokens // 2))
    eval_toks = tokenize_dir(model, params, vq_state,
                             os.path.join(ns.data, "eval"), ns.seg_tokens,
                             n_q)
    print(f"  train segments: {train_toks.shape}, eval: {eval_toks.shape}",
          flush=True)

    lm = LMModel(n_q=n_q, card=card, dim=ns.dim, num_heads=ns.heads,
                 num_layers=ns.layers, past_context=ns.seg_tokens)
    lm_params = lm.init(torch.Generator().manual_seed(0), dev)
    opt, _lr = make_optimizer("Adam", {"lr": ns.lr, "betas": [0.9, 0.98]})
    opt_state = opt.init(lm_params)

    def tokens(arr):                                  # -> [n_q, B, T]
        return torch.from_numpy(arr.transpose(1, 0, 2)).to(dev)

    @torch.no_grad()
    def eval_bits(prm) -> float:
        """Held-out bits a token, in batches of 16 segments."""
        nats = 0.0
        for i in range(0, len(eval_toks), 16):
            chunk = eval_toks[i:i + 16]
            nats += float(lm_cross_entropy(lm, prm, tokens(chunk))) \
                * len(chunk)
        return nats / len(eval_toks) / math.log(2)

    bits0 = eval_bits(lm_params)
    print(f"step 0: held-out {bits0:.3f} bits/token (raw {raw_bits:.1f})",
          flush=True)
    rng = np.random.default_rng(0)
    warmup = min(500, ns.steps // 10)
    t0 = time.time()
    for it in range(1, ns.steps + 1):
        idx = rng.integers(0, len(train_toks), ns.batch)
        lr = torch.tensor(lr_at(it, ns.lr, ns.steps, warmup),
                          dtype=torch.float32, device=dev)
        lm_params, opt_state, loss = lm_train_step(
            lm, opt, lm_params, opt_state, tokens(train_toks[idx]), lr)
        if it % LOG_EVERY == 0 or it == ns.steps:
            bits = eval_bits(lm_params)
            print(f"step {it}: train {float(loss) / math.log(2):.3f} "
                  f"bits/token, held-out {bits:.3f}, "
                  f"{(time.time() - t0) / it * 1000:.0f} ms/step",
                  flush=True)

    bits = eval_bits(lm_params)
    kbps_raw = raw_bits * n_q * fps / 1000
    kbps_lm = bits * n_q * fps / 1000
    print(f"FINAL: held-out {bits:.3f} bits/token vs raw {raw_bits:.1f} "
          f"=> entropy-coded {kbps_lm:.2f} kbps vs {kbps_raw:.2f} kbps "
          f"fixed-rate ({(1 - bits / raw_bits) * 100:.1f}% saved) "
          f"at n_q={n_q}, {fps:.0f} fps", flush=True)
    if ns.out:
        save_checkpoint(ns.out, ns.steps, lm_params)
        print(f"saved LM params under {ns.out}")


if __name__ == "__main__":
    main()
