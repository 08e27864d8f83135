"""Training step: next-token cross-entropy + AdamW (the counterpart of
``repro.training.train_step``).

``loss_fn`` is the reference's: the tokens shifted by one, a VLM's patch
positions dropped before the loss, the fp32 ``log_softmax``
cross-entropy mean plus ``AUX_WEIGHT`` times the MoE load-balance loss.
The gradient is PyTorch autograd over ``Model.forward_train`` (plain
PyTorch, as the reference differentiates plain ``jnp``: no kernel of
the port runs in training), and the optimizer updates the model's
weights in place."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.model import Model

AUX_WEIGHT = 0.01  # MoE load-balance loss weight

Batch = Dict[str, torch.Tensor]


def loss_fn(model: Model, batch: Batch, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: ``tokens`` (B, S+1) and, where the model has them,
    ``frames`` (B, F, d) or ``patches`` (B, P, d), on the model's
    device.  Returns (total loss, {"ce", "aux"})."""
    toks = batch["tokens"]
    labels = toks[:, 1:].long()
    logits, aux = model.forward_train(
        toks[:, :-1].long(), frames=batch.get("frames"),
        patches=batch.get("patches"), remat=remat)
    # VLM: image positions are prepended: only text positions have labels
    if model.cfg.vision is not None and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:, :]
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    ce = nll.mean()
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def make_train_step(model: Model, opt_update: Callable,
                    remat: bool = True):
    """``train_step(opt_state, batch) -> (opt_state, metrics)``: the
    loss and its gradient, then ``opt_update`` on every weight of the
    model (updated in place).  Metrics are detached device scalars:
    ``loss``, ``ce``, ``aux``."""
    params = dict(model.named_parameters())

    def train_step(opt_state, batch: Batch):
        for p in params.values():
            p.grad = None
        loss, metrics = loss_fn(model, batch, remat)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        opt_state = opt_update(grads, opt_state, params)
        for p in params.values():
            p.grad = None
        return opt_state, {k: v.detach() for k, v in
                           dict(metrics, loss=loss).items()}
    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        loss, metrics = loss_fn(model, batch, remat=False)
        return dict(metrics, loss=loss)
    return eval_step
