"""Training launcher (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --steps 100 [--batch 8 --seq 128] [--ckpt-dir /path \
        --ckpt-every 50] [--smoke] [--device cpu]

One device, the card by default (``--device cpu`` runs the same plain
PyTorch path on the CPU): weights from ``Model.random`` with a
``torch.Generator`` seeded 0, the reference's WSD schedule and AdamW,
activation checkpointing per block, batches from the synthetic Markov
stream.  ``--smoke`` trains the reduced config.  Resumes from the
checkpoint in ``--ckpt-dir`` when there is one (the data is a pure
function of the step, so a resumed run sees the batches an unbroken
one would).  ``--stop-after N`` ends the run after step N with its
checkpoint written, as a run cut short there; the schedule stays that
of ``--steps``.  Sharded training (the reference's ``--mesh``) is not
ported yet.

``train(cfg, ...)`` is the CLI's body for a given config (a caller may
cut the depth); it returns one ``(loss, seconds)`` per step run, the
step timed to the loss on the host.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.padding import make_plan
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.model import build
from repro_torch.training import (AdamWState, DataConfig, SyntheticStream,
                                  adamw, make_train_step, wsd)
from repro_torch.training import checkpoint as ckpt


def batch_on(data: SyntheticStream, step: int, device) -> dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch(step).items()}


def train(cfg: ModelConfig, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 100, log_every: int = 10, device=None,
          stop_after: Optional[int] = None,
          log: Callable[[str], None] = print) -> List[Tuple[float, float]]:
    dev = resolve_device(device)
    plan = make_plan(cfg, 1)
    log(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
        f"{steps} steps, batch {batch} x {seq}, device={dev}")
    model = build(cfg, plan, 0, device=dev)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    sched = wsd(lr, warmup=max(steps // 20, 1), stable=steps // 2,
                decay=steps)
    opt_init, opt_update = adamw(sched)
    opt_state = opt_init(params)
    start_step = 0

    if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, "index.json")):
        tree, start_step = ckpt.restore(ckpt_dir)
        with torch.no_grad():
            model.load_state_dict(tree["params"])
        step, mu, nu = tree["opt"]
        opt_state = AdamWState(int(step), *(
            {k: v.to(dev) for k, v in m.items()} for m in (mu, nu)))
        log(f"[train] resumed from step {start_step}")

    def save(step: int) -> None:
        ckpt.save(ckpt_dir, {"params": params, "opt": opt_state}, step=step)

    step_fn = make_train_step(model, opt_update)
    data = SyntheticStream(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    end = steps if stop_after is None else min(steps, stop_after)
    out = []
    t0 = time.time()
    for i in range(start_step, end):
        ts = time.perf_counter()
        opt_state, metrics = step_fn(opt_state, batch_on(data, i, dev))
        loss = float(metrics["loss"])
        out.append((loss, time.perf_counter() - ts))
        if i % log_every == 0 or i == end - 1:
            log(f"step {i:6d} loss {loss:.6f} "
                f"({(time.time()-t0)/max(i-start_step+1,1):.2f}s/it)")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            save(i + 1)
    if ckpt_dir:
        save(end)
        log(f"[train] final checkpoint at {ckpt_dir}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    choices=ASSIGNED_ARCHS + ["qwen2.5-32b"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--stop-after", type=int, default=None,
                    help="end after this step, its checkpoint written "
                         "(the schedule stays that of --steps)")
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
          lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          log_every=args.log_every, device=args.device,
          stop_after=args.stop_after)


if __name__ == "__main__":
    main()
