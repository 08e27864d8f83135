"""Quickstart on the PyTorch port: build a model from an
assigned-architecture config, serve a few batched requests through the
continuous-batching engine (paged, header-centric KV cache), and print
the generations (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--arch llama3-8b] \
        [--device cpu]

The reduced smoke variant by default, so it runs in seconds on the CPU;
pass --full-config on the card.  The card is the default device.
"""
import argparse

import numpy as np

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    print(f"arch={cfg.name}  layers={cfg.num_layers} d_model={cfg.d_model} "
          f"params={cfg.param_count()/1e6:.1f}M")

    eng = Engine(cfg, max_batch=4, max_seq=256, seed=0, device=args.device)
    stub = np.random.default_rng(0)
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [42]]
    reqs = []
    for i, p in enumerate(prompts):
        # an encoder-decoder reads frames, a vision model may take patches
        frames = None if cfg.encoder is None else stub.standard_normal(
            (cfg.encoder.num_frames, cfg.d_model), dtype=np.float32)
        patches = None if cfg.vision is None or i % 2 else \
            stub.standard_normal((cfg.vision.num_patches, cfg.d_model),
                                 dtype=np.float32)
        reqs.append(ServeRequest(p, max_new_tokens=args.tokens,
                                 frames=frames, patches=patches))
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    for r in reqs:
        print(f"req{r.rid} prompt={r.prompt} -> {r.generated} "
              f"(ttft={r.ttft*1e3:.0f}ms)")
    assert all(len(r.generated) == args.tokens for r in reqs)


if __name__ == "__main__":
    main()
