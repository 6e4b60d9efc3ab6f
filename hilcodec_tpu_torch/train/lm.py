"""Training of the token LM, the entropy model of the range coder
(`hilcodec_tpu/train/lm.py`): next-step cross-entropy over the RVQ tokens
of a codec, and one optimizer step of it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..models.encodec import LMModel
from ..utils.params import flatten, tree_map, unflatten


def lm_inputs_from_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """tokens [n_q, B, T] -> LM input indices [B, n_q, T]: shifted right by
    one step, offset by +1, position 0 = the reserved missing index 0."""
    x = tokens.permute(1, 0, 2).long() + 1
    return F.pad(x[:, :, :-1], (1, 0))


def lm_cross_entropy(lm: LMModel, params: Any, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """Mean next-step cross-entropy (nats a token) over all codebooks;
    tokens [n_q, B, T] from the RVQ encoder."""
    probs, _, _ = lm.apply(params, lm_inputs_from_tokens(tokens))
    targets = tokens.permute(1, 0, 2).long()             # [B, n_q, T]
    p = torch.gather(probs, 1, targets[:, None])[:, 0]    # [B, n_q, T]
    return -torch.mean(torch.log(torch.clamp(p, min=1e-10)))


def lm_train_step(lm: LMModel, optimizer, params: Any, opt_state: Any,
                  tokens: torch.Tensor, lr: torch.Tensor
                  ) -> Tuple[Any, Any, torch.Tensor]:
    """One step of `optimizer` (`train/optim.make_optimizer`'s transform)
    on the cross-entropy: -> (params, opt_state, loss)."""
    flat = {k: v.detach().requires_grad_() for k, v in
            flatten(params).items()}
    loss = lm_cross_entropy(lm, unflatten(flat), tokens)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    updates, opt_state = optimizer.update(unflatten(grads), opt_state,
                                          params, lr)
    params = tree_map(lambda p, u: (p + u).detach(), params, updates)
    return params, opt_state, loss.detach()
