"""Offline objective evaluation with confidence intervals (the port's
`eval.py`).

  model mode:    run wavs through the codec and score the reconstruction
    python -m hilcodec_tpu_torch.eval -c CONFIG [--ckpt CKPT]
        -i FILELIST_OR_DIR [-n N_Q] [--stream] [--device DEV]
  degraded mode: score decoded wavs against their references
    python -m hilcodec_tpu_torch.eval -i REF_DIR -d DEG_DIR

Model mode pads each wav to a power-of-two number of hops and runs the
offline `encode` / `decode` (the RVQ kernel on the card; Avocodo through
its full-rate head, as its trainer's facade `AvocodoCodecModel` codes),
or with --stream (and for inputs over 512 hops)
`encode_stream` / `decode_stream`. A quantizer without Euclidean
codebooks (`vq: ''`, shape-gain) has no token coding: the codec
reconstructs through `forward` (at -n stages), as the JAX eval does.
`model: audiodec` exits with an error, as the JAX eval cannot run it
either: it takes the bare AudioDec generator, which has no token coding.
Prints each metric's mean and 95% t-interval, and per-file values with
-v.
"""

import argparse
import math
import os
import sys

import numpy as np
import torch

METRICS = ("pesq", "stoi", "sisdr", "mcd", "visqol", "visqol_audio")
STREAM_ABOVE_HOPS = 512


def collect_wavs(path):
    """A .wav file, a filelist (`relative/path.wav|...` lines, relative to
    the list) or a directory -> sorted wav paths."""
    if path.lower().endswith(".wav") and os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in files
                       if f.lower().endswith(".wav"))
        return sorted(out)
    base = os.path.dirname(os.path.abspath(path))
    out = []
    with open(path) as f:
        for line in f:
            rel = line.strip().split("|")[0]
            if rel:
                out.append(rel if os.path.isabs(rel)
                           else os.path.join(base, rel))
    return out


def t_interval(values, confidence=0.95):
    """Mean and half-width of the t-distribution interval."""
    values = np.asarray(values, np.float64)
    n = len(values)
    mean = float(values.mean())
    if n < 2:
        return mean, float("nan")
    from scipy.stats import t
    sem = float(values.std(ddof=1)) / math.sqrt(n)
    return mean, float(t.ppf((1 + confidence) / 2, n - 1)) * sem


def score_pair(ref, deg, sr, metrics):
    """Per-file metric dict, through the training path's backends."""
    from scipy.signal import resample_poly

    from .train.metrics import (_RESAMPLE_RATES, _pesq_backend, mcd,
                                measure_visqol, sisdr, stoi)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    out = {}
    for name in metrics:
        sr_t = _RESAMPLE_RATES[name]
        if sr_t is None:
            r_t, d_t, sr_t = ref, deg, sr
        else:
            g = math.gcd(sr, sr_t)
            r_t = resample_poly(ref, sr_t // g, sr // g)
            d_t = resample_poly(deg, sr_t // g, sr // g)
        try:
            if name == "stoi":
                out[name] = float(stoi(r_t, d_t, sr_t))
            elif name == "sisdr":
                out[name] = float(sisdr(r_t, d_t))
            elif name == "mcd":
                out[name] = float(mcd(r_t, d_t, sr_t))
            elif name == "pesq":
                out[name] = float(_pesq_backend(r_t, d_t, sr_t))
            else:
                mode = "speech" if name == "visqol" else "audio"
                out[name] = float(measure_visqol(r_t, d_t, sr_t, mode))
        except Exception as e:   # one metric of one file; the run goes on
            print(f"  {name} failed: {e!r}", file=sys.stderr)
    return out


def codec_runner(hps, ckpt=None, n=None, stream=False, device=None):
    """wav [T] (numpy) -> the codec's reconstruction [T // hop * hop]."""
    from .utils.checkpoint import load_codec
    if hps.get("model", "hilcodec") == "audiodec":
        sys.exit("error: eval does not run model: audiodec, as the JAX "
                 "eval does not: it takes the bare generator of "
                 "build_model, which has no token coding; score the output "
                 "of infer in degraded mode (-d) instead")
    if not ckpt:
        print("warning: no --ckpt, scoring randomly initialized weights",
              file=sys.stderr)
    from .models.avocodo import AvocodoFullRate, AvocodoModel
    from .models.codec import CodecModel
    from .ops.rvq import ResidualVQ, RVQDraws
    model, params, vq_state = load_codec(hps, ckpt, device)
    params = model.fold_params(params)
    hop, dev = model.hop_length, model.device
    forward_only = not isinstance(model.vq, ResidualVQ)
    # Avocodo codes offline through its full-rate head (the trainer's
    # facade, AvocodoCodecModel)
    coder = (CodecModel(AvocodoFullRate(model.codec), model.vq, dev)
             if isinstance(model.codec, AvocodoModel) else model)

    @torch.no_grad()
    def run(wav):
        L = len(wav) // hop * hop
        Lp = hop * (1 << max(0, L // hop - 1).bit_length())
        x = torch.zeros((1, 1, Lp), dtype=torch.float32)
        x[0, 0, :L] = torch.from_numpy(np.ascontiguousarray(wav[:L]))
        x = x.to(dev)
        if forward_only:
            y = model.forward(params, vq_state, x,
                              RVQDraws(n) if n else None, training=False)[0]
        elif stream or Lp // hop > STREAM_ABOVE_HOPS:
            ce, cd = model.init_cache(1)
            tok, _ = model.encode_stream(params, vq_state, x, ce, n=n)
            y, _ = model.decode_stream(params, vq_state, tok, cd)
        else:
            y = coder.decode(params, vq_state,
                             coder.encode(params, vq_state, x, n))
        return y[0, 0, :L].cpu().numpy()

    return run


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m hilcodec_tpu_torch.eval")
    p.add_argument("-i", "--input", required=True,
                   help="reference wavs: filelist .txt or directory")
    p.add_argument("-d", "--degraded", default=None,
                   help="degraded wav dir (skip the model, score directly)")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("-n", "--num_quantizers", type=int, default=None)
    p.add_argument("-m", "--metrics", default="pesq,stoi,sisdr,mcd",
                   help="comma list of " + ",".join(METRICS))
    p.add_argument("--sr", type=int, default=None,
                   help="sample rate override (default: config or wav)")
    p.add_argument("--max-files", type=int, default=None)
    p.add_argument("--stream", action="store_true",
                   help="the streaming drivers for every input")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without it)")
    p.add_argument("-v", "--verbose", action="store_true")
    ns = p.parse_args(argv)
    metrics = [m.strip() for m in ns.metrics.split(",") if m.strip()]
    bad = [m for m in metrics if m not in METRICS]
    if bad:
        sys.exit(f"error: unknown metric(s) {bad}; choose from {METRICS}")
    if ns.degraded is not None and not os.path.isdir(ns.degraded):
        sys.exit(f"error: degraded dir {ns.degraded!r} does not exist")

    from .utils.wavio import read_wav

    refs = collect_wavs(ns.input)
    if ns.max_files:
        refs = refs[: ns.max_files]
    if not refs:
        sys.exit(f"error: no wav files found under {ns.input!r}")

    run_model = None
    sr_cfg = ns.sr
    if ns.degraded is None:
        if not ns.config:
            sys.exit("error: need -c CONFIG (or -d DEG_DIR for "
                     "degraded mode)")
        from .utils.hparams import load_config
        hps = load_config(ns.config)
        sr_cfg = sr_cfg or hps.data.sampling_rate
        run_model = codec_runner(hps, ns.ckpt, ns.num_quantizers, ns.stream,
                                 ns.device)

    per_file = {m: [] for m in metrics}
    for i, path in enumerate(refs):
        ref, sr = read_wav(path)
        sr = sr_cfg or sr
        if ns.degraded is not None:
            dpath = os.path.join(ns.degraded, os.path.basename(path))
            if not os.path.exists(dpath):
                print(f"skip (no degraded): {path}", file=sys.stderr)
                continue
            deg, _ = read_wav(dpath)
        else:
            deg = run_model(ref)
        scores = score_pair(ref, deg, sr, metrics)
        for k, v in scores.items():
            per_file[k].append(v)
        if ns.verbose:
            line = "  ".join(f"{k}={v:.4f}" for k, v in scores.items())
            print(f"[{i + 1}/{len(refs)}] {os.path.basename(path)}: "
                  f"{line}")

    print(f"\n== {len(refs)} files ==")
    for m in metrics:
        vals = per_file[m]
        if not vals:
            print(f"{m}: no results")
            continue
        mean, half = t_interval(vals)
        print(f"{m}: {mean:.4f} +/- {half:.4f} (95% CI, n={len(vals)})")


if __name__ == "__main__":
    main()
