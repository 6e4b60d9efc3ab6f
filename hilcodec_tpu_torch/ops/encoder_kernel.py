"""The fused encoder frame step.

Counterpart of `hilcodec_tpu/ops/pallas_encoder.py`: `encoder_ops` and the
step class `EncoderMegakernel`, on the shared executor of
`ops/decoder_kernel.py` (plain version `run_plain`, CUDA C++ kernel
`csrc/segment.cu`). As in the JAX package, the wav-ring update and the
SpecBlocks' causal log-magnitude STFTs stay outside the kernel (plain
matmuls on the ring, `SpecBlock._spec`); each log-magnitude enters the
kernel time-major ([B, T_s, F]) as the aux input of its `mix` op. The
encoder's dilations are `dilation_base ** bi` with `bi` counting from 1,
the decoder's from 0.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .decoder_kernel import FrameKernel, Op, check_supported

KERNEL = "encoder_frame"
SOURCE = "hilcodec_tpu_torch/csrc/segment.cu"
# launches of the kernel, counted where it is launched and nowhere else
LAUNCHES: Dict[str, int] = {KERNEL: 0}


def reset_launches() -> None:
    LAUNCHES[KERNEL] = 0


def encoder_ops(enc) -> Tuple[List[Op], List[Tuple[int, int]], List[dict]]:
    """(ops, cache_shapes for slots 1.. [(L, C)...], spec descriptors)."""
    check_supported(enc, "encoder")
    if getattr(enc, "spec_learnable", False):
        raise ValueError("encoder frame kernel: fixed STFT basis only")
    ops: List[Op] = []
    cache_shapes: List[Tuple[int, int]] = []
    specs: List[dict] = []
    group = 0
    c = enc.n_filters
    ops.append(Op("dense1ch", dict(path=("conv_pre",), k=enc.kernel_size,
                                   c=c)))
    ratios = tuple(reversed(enc.ratios))
    mult = 1
    for si, ratio in enumerate(ratios):
        ch = mult * enc.n_filters
        spec_obj = enc.stages[si][0]
        if spec_obj is not None:
            specs.append(dict(stage=si, n_fft=spec_obj.n_fft,
                              stride=spec_obj.stride,
                              path=("stages", si, "spec")))
            ops.append(Op("mix", dict(path=("stages", si, "spec"),
                                      f=spec_obj.n_fft // 2 + 1, cout=ch)))
        kr = enc.residual_kernel_size
        for bi in range(1, enc.n_residual_layers + 1):
            group += 1
            idx = bi - 1 if enc.spec == "" else bi
            pre = ((1 + idx * enc.res_scale ** 2) ** -0.5
                   if enc.res_scale is not None else None)
            ops.append(Op("res_begin", dict(pre_scale=pre),
                          atomic_group=group))
            for di, d in enumerate((enc.dilation_base ** bi, 1)):
                base = ("stages", si, "blocks", bi - 1, "blocks", di)
                ops.append(Op("act", dict(name=enc.activation),
                              atomic_group=group))
                ops.append(Op("pw", dict(path=base + ("pointwise",), cin=ch,
                                         cout=ch), atomic_group=group))
                cache_shapes.append((d * (kr - 1), ch))
                ops.append(Op("dw", dict(path=base + ("depthwise",), k=kr,
                                         d=d, c=ch),
                              cache_slot=len(cache_shapes) - 1,
                              atomic_group=group))
            ops.append(Op("res_end", dict(), atomic_group=group))
        if enc.res_scale is not None:
            ops.append(Op("scale", dict(
                s=(1 + enc.n_residual_layers * enc.res_scale ** 2) ** -0.5)))
        ops.append(Op("act", dict(name=enc.activation)))
        ops.append(Op("pw", dict(path=("stages", si, "down_pw"), cin=ch,
                                 cout=2 * ch)))
        cache_shapes.append((ratio, 2 * ch))
        ops.append(Op("dws", dict(path=("stages", si, "down_dw"),
                                  k=2 * ratio, s=ratio, c=2 * ch),
                      cache_slot=len(cache_shapes) - 1))
        mult *= 2

    ch = mult * enc.n_filters
    if enc.spec_post is not None:
        specs.append(dict(stage=len(ratios), n_fft=enc.spec_post.n_fft,
                          stride=enc.spec_post.stride, path=("spec_post",)))
        ops.append(Op("mix", dict(path=("spec_post",),
                                  f=enc.spec_post.n_fft // 2 + 1, cout=ch)))
    ops.append(Op("act", dict(name=enc.activation)))
    kp = enc.last_kernel_size
    cache_shapes.append((kp - 1, ch))
    ops.append(Op("dw", dict(path=("post_dw",), k=kp, d=1, c=ch),
                  cache_slot=len(cache_shapes) - 1))
    ops.append(Op("pw", dict(path=("post_pw",), cin=ch, cout=enc.dimension)))
    if enc.l2norm:
        ops.append(Op("l2norm", dict(c=enc.dimension, eps=1e-12,
                                     inout_norm=enc.inout_norm)))
    return ops, cache_shapes, specs


class EncoderMegakernel(FrameKernel):
    """Fused streaming encoder step. `step(folded_params, cache, x)`:
    cache = [wav_ring [B, 1, W]] + time-major layer caches ([B, L, C]) in
    the reference flat order; x = [B, 1, hop*L] new samples."""
    kernel = KERNEL
    launches = LAUNCHES

    def __init__(self, enc):
        ops, cache_shapes, specs = encoder_ops(enc)
        super().__init__(ops, cache_shapes)
        self.enc = enc
        self.specs = specs

    def cache_to_time_major(self, cache: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
        return [cache[0]] + self._to_time_major(cache[1:])

    def cache_from_time_major(self, cache: Sequence[torch.Tensor]
                              ) -> List[torch.Tensor]:
        return [cache[0]] + [c.transpose(1, 2) for c in cache[1:]]

    def init_cache(self, batch: int, dtype=torch.float32, device="cpu"
                   ) -> List[torch.Tensor]:
        ring = torch.zeros((batch, 1, self.enc.wav_cache_len), dtype=dtype,
                           device=device)
        return [ring] + self._zeros(batch, dtype, device)

    def _spec_block(self, sd: dict):
        if sd["path"] == ("spec_post",):
            return self.enc.spec_post
        return self.enc.stages[sd["stage"]][0]

    def frame_inputs(self, ring: torch.Tensor, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                List[torch.Tensor]]:
        """The work outside the kernel: (new wav ring, the wav window of
        conv_pre [B, k-1+hop*L], the log-mags [B, L_s, F])."""
        enc = self.enc
        wcl = enc.wav_cache_len
        wav = torch.cat([ring, x], dim=-1)               # [B, 1, W+hop*L]
        aux = [self._spec_block(sd)._spec(
                   wav[:, :, wcl - (sd["n_fft"] - 1):], pad=False
               ).transpose(1, 2) for sd in self.specs]
        return (wav[:, :, wav.shape[-1] - wcl:],
                wav[:, 0, wcl - (enc.kernel_size - 1):], aux)

    def step(self, params, cache: Sequence[torch.Tensor], x: torch.Tensor
             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: [B, 1, hop*L] -> (latents [B, dim, L], new_cache)."""
        ring, window, aux = self.frame_inputs(cache[0], x)
        z, caches = self.run(params, window, aux, cache[1:])
        return z.transpose(1, 2), [ring] + caches
