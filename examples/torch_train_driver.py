"""End-to-end training driver on the PyTorch port (the counterpart of
``examples/train_driver.py``): data pipeline -> model -> AdamW + WSD
schedule -> checkpointing, for any assigned architecture.

Presets:
    smoke  (default) the reduced model, 200 steps, demonstrably reduces
           the loss;
    100m   a ~100M-param config for the card (same code path).

    PYTHONPATH=src python examples/torch_train_driver.py --arch minicpm-2b \
        --steps 200 [--preset 100m] [--ckpt /tmp/ck] [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core.padding import make_plan
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.train import batch_on
from repro_torch.models.model import build
from repro_torch.training import (DataConfig, SyntheticStream, adamw,
                                  make_train_step, wsd)
from repro_torch.training import checkpoint as ckpt


def preset_config(cfg, preset: str):
    if preset == "smoke":
        return cfg.reduced()
    if preset == "100m":
        return dataclasses.replace(
            cfg.reduced(), name=cfg.name + "-100m", num_layers=8,
            d_model=768, num_heads=12, num_kv_heads=4, head_dim=0,
            d_ff=2048 if cfg.d_ff else 0, vocab_size=32768)
    raise ValueError(preset)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = preset_config(get_config(args.arch), args.preset)
    plan = make_plan(cfg, 1)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}, "
          f"device={dev}")
    model = build(cfg, plan, 0, device=dev).requires_grad_(True)
    # MiniCPM's WSD schedule (arXiv:2404.06395): warmup/stable/decay
    sched = wsd(3e-3, warmup=args.steps // 10,
                stable=args.steps // 2, decay=args.steps)
    opt_init, opt_update = adamw(sched)
    opt_state = opt_init(dict(model.named_parameters()))
    step_fn = make_train_step(model, opt_update)
    data = SyntheticStream(DataConfig(cfg.vocab_size, args.seq,
                                      args.batch, seed=0))
    t0 = time.time()
    first = None
    for i in range(args.steps):
        batch = batch_on(data, i, dev)
        if cfg.encoder is not None:     # stub frontend inputs
            batch["frames"] = torch.randn(
                (args.batch, cfg.encoder.num_frames, cfg.d_model),
                generator=torch.Generator().manual_seed(i)).to(dev)
        opt_state, m = step_fn(opt_state, batch)
        if i == 0:
            first = float(m["loss"])
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {float(m['loss']):.4f} "
                  f"ce {float(m['ce']):.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    final = float(m["loss"])
    print(f"loss: {first:.4f} -> {final:.4f} "
          f"({'improved' if final < first else 'NO IMPROVEMENT'})")
    if args.ckpt:
        ckpt.save(args.ckpt, {"params": dict(model.named_parameters()),
                              "opt": opt_state}, step=args.steps)
        print(f"checkpoint written to {args.ckpt}")
    assert final < first, "training must reduce loss"


if __name__ == "__main__":
    main()
