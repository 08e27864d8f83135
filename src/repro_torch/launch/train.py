"""Training launcher (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --steps 100 [--batch 8 --seq 128] [--mesh 2,2] [--ckpt-dir /path \
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
of ``--steps``.

``--mesh D,M`` trains over a D x M grid of workers (FSDP over ``data``,
TP over ``model``: ``training.sharded``), all D*M of them on
``--device`` (one card holds them all; the tests put them on the CPU),
under the lane plan ``make_plan(cfg, M, "lane")``, as the reference's
``--mesh`` does.  The weights are ``build(cfg, plan, 0)`` with the MLPs
in the plan's per-shard layout, placed by ``param_pspecs(...,
fsdp=True)``.  A checkpoint keeps the reference's on-disk format and
the logical leaves: ``save`` gathers the shards and a restore places
them again, so a mesh run's checkpoint restores into the single-device
trainer and back, wherever the two plans give the weights the same
shapes (llama3-8b at M = 2 does).

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
from repro_torch.core.weight_transform import relayout_block_mlp
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Grid, resolve_device
from repro_torch.models.model import Model, build
from repro_torch.training import (AdamWState, DataConfig, SyntheticStream,
                                  adamw, make_train_step, wsd)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import sharded as TS


def batch_on(data: SyntheticStream, step: int, device) -> dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch(step).items()}


class MeshTrainer:
    """A model's weights and AdamW state sharded over a ``(D, M)`` grid
    of workers on ``device``, and its sharded train step.  ``model`` is
    the logical model (lane plan of M, MLPs in the per-shard layout);
    its weights are copied out into the shards."""

    def __init__(self, model: Model, shape: Tuple[int, int], device,
                 opt_update):
        self.grid = Grid([device] * (shape[0] * shape[1]), shape)
        self.step = TS.ShardedStep.from_model(model, self.grid)
        self.specs, self.shards = self.step.specs, self.step.shards
        self.opt_state = TS.opt_init_sharded(self.shards)
        self.fn = TS.make_sharded_train_step(self.step, opt_update)

    def __call__(self, batch: dict) -> dict:
        self.opt_state, metrics = self.fn(self.opt_state, batch)
        return metrics

    def tree(self) -> dict:
        """The checkpoint tree: logical leaves gathered from the shards."""
        st = self.opt_state
        return {"params": SH.gather(self.shards, self.specs, self.grid),
                "opt": AdamWState(st.step, SH.gather(st.mu, self.specs,
                                                     self.grid),
                                  SH.gather(st.nu, self.specs, self.grid))}

    @torch.no_grad()
    def load(self, tree: dict) -> None:
        """Place a checkpoint's logical leaves into the shards."""
        step, mu, nu = tree["opt"]
        for src, dst in ((tree["params"], self.shards),
                         (mu, self.opt_state.mu), (nu, self.opt_state.nu)):
            placed = SH.place(src, self.specs, self.grid)
            for k, parts in dst.items():
                for p, q in zip(parts, placed[k]):
                    p.copy_(q)
        self.opt_state = AdamWState(int(step), self.opt_state.mu,
                                    self.opt_state.nu)


def train(cfg: ModelConfig, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 100, log_every: int = 10, device=None,
          stop_after: Optional[int] = None,
          log: Callable[[str], None] = print,
          mesh: Optional[Tuple[int, int]] = None
          ) -> List[Tuple[float, float]]:
    dev = resolve_device(device)
    plan = make_plan(cfg, mesh[1], mode="lane") if mesh else make_plan(cfg, 1)
    where = (f"device={dev}" if mesh is None else
             f"mesh={mesh[0]}x{mesh[1]} on {mesh[0] * mesh[1]} x {dev}")
    log(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
        f"{steps} steps, batch {batch} x {seq}, {where}")
    model = build(cfg, plan, 0, device=dev)
    sched = wsd(lr, warmup=max(steps // 20, 1), stable=steps // 2,
                decay=steps)
    opt_init, opt_update = adamw(sched)
    if mesh is None:
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        state = {"opt": opt_init(params)}
        step_fn = make_train_step(model, opt_update)

        def run(b: dict) -> dict:
            state["opt"], metrics = step_fn(state["opt"], b)
            return metrics

        def tree() -> dict:
            return {"params": params, "opt": state["opt"]}

        def load(t: dict) -> None:
            with torch.no_grad():
                model.load_state_dict(t["params"])
            step, mu, nu = t["opt"]
            state["opt"] = AdamWState(int(step), *(
                {k: v.to(dev) for k, v in m.items()} for m in (mu, nu)))
    else:
        for blk in model.layers:
            relayout_block_mlp(blk.mlp, cfg.d_ff, plan.max_tp,
                               cfg.activation)
        run = MeshTrainer(model, mesh, dev, opt_update)
        tree, load = run.tree, run.load
        del model
    start_step = 0

    if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, "index.json")):
        t, start_step = ckpt.restore(ckpt_dir)
        load(t)
        log(f"[train] resumed from step {start_step}")

    def save(step: int) -> None:
        ckpt.save(ckpt_dir, tree(), step=step)

    data = SyntheticStream(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    end = steps if stop_after is None else min(steps, stop_after)
    out = []
    t0 = time.time()
    for i in range(start_step, end):
        ts = time.perf_counter()
        metrics = run(batch_on(data, i, dev))
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
    ap.add_argument("--mesh", default=None,
                    help="data,model: train over a D x M grid of workers "
                         "on --device (omit for one device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
          lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          log_every=args.log_every, device=args.device,
          stop_after=args.stop_after,
          mesh=(tuple(int(x) for x in args.mesh.split(","))
                if args.mesh else None))


if __name__ == "__main__":
    main()
