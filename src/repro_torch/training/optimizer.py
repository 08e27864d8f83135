"""AdamW, written by hand (the counterpart of
``repro.training.optimizer``).

The reference's update: fp32 moments; one global-norm clip over every
gradient before the moments; bias correction at ``step + 1``; weight
decay on every leaf (norms, embeddings and padded slots included); the
parameter cast back to its own dtype.  ``torch.optim.AdamW`` keeps its
moments in the parameter's dtype and has no global clip, so it is not
used.  The update runs leaf by leaf, in place, so no fp32 copy of the
whole model is ever held: at most a few fp32 temporaries of one leaf.

Parameters, gradients and moments are dicts of tensors keyed by the
model's parameter names (``dict(model.named_parameters())``)."""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def adamw(lr: Union[Callable[[int], float], float],
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0):
    """``(init, update)``.  ``lr``: a rate, or a schedule from the step
    (counted from 1) to a rate."""
    f32 = np.float32
    lr_fn = lr if callable(lr) else (lambda _: float(f32(lr)))

    def init(params: Tree) -> AdamWState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
        return AdamWState(0, zeros(), zeros())

    @torch.no_grad()
    def update(grads: Dict[str, Optional[torch.Tensor]], state: AdamWState,
               params: Tree, gnorm: Optional[torch.Tensor] = None
               ) -> AdamWState:
        """One step: ``params`` updated in place, the moments too; a
        gradient of None (a weight the loss did not reach) is zero.
        ``gnorm``: the global gradient norm, when the caller holds a
        shard of the model (``training.sharded``); else computed from
        ``grads``."""
        step = state.step + 1
        # global-norm clip, as a device scalar (no host sync)
        if gnorm is None:
            sq = [torch.sum(torch.square(g.float()))
                  for g in grads.values() if g is not None]
            gnorm = torch.sqrt(torch.stack(sq).sum()) if sq else None
        scale = (1.0 if gnorm is None else torch.clamp(
            grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0))
        # the reference's fp32 scalars
        bc1 = float(f32(1) - f32(b1) ** f32(step))
        bc2 = float(f32(1) - f32(b2) ** f32(step))
        lr_t = lr_fn(step)
        for k, p in params.items():
            g = grads.get(k)
            g = (torch.zeros_like(p, dtype=torch.float32) if g is None
                 else g.float() * scale)
            m, n = state.mu[k], state.nu[k]
            m.mul_(b1).add_(g * (1 - b1))
            n.mul_(b2).add_(g.square_().mul_(1 - b2))
            denom = (n / bc2).sqrt_().add_(eps)
            delta = (m / bc1).div_(denom)
            pf = p.float()
            delta.add_(weight_decay * pf)
            p.copy_(pf - lr_t * delta)
        return AdamWState(step, state.mu, state.nu)

    return init, update
