"""The paper demo on the PyTorch port: live parallelism transformation
while serving (the counterpart of ``examples/serve_transform.py``).  An
engine on four workers starts as 4x(TP1); a long request arrives
mid-stream, the engine transforms to TP4 without dropping a token (one
schedule step per decode iteration), then decomposes back to 4x(TP1).

    PYTHONPATH=src python examples/torch_serve_transform.py [--device cpu]

The four workers are four sets of tensors on one device (the card by
default).  Every stream is asserted equal to that of an engine that
never transforms.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tokens", type=int, default=10)
    args = ap.parse_args()

    # float32: the demo asserts token-EXACT continuity, and bf16 cross-TP
    # reduction order can flip near-tie argmaxes
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    devs = [args.device] * 4
    print(f"workers: {len(devs)} x {args.device} | arch: {cfg.name}")

    kw = dict(max_batch=4, max_seq=128, page_tokens=16, seed=3,
              devices=devs)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 16).tolist()
               for _ in range(4)]

    def requests():
        return [ServeRequest(p, max_new_tokens=args.tokens)
                for p in prompts]

    ref = Engine(cfg, **kw)
    want = requests()
    for r in want:
        ref.submit(r)
    ref.run_until_done()

    eng = Engine(cfg, **kw)
    reqs = requests()
    for r in reqs:
        eng.submit(r)
    for i in range(3):
        eng.step()
    print(">>> long request arrives: transforming 4x(TP1) -> TP4 "
          "(MLP-first, reversed traversal; one step per decode iteration)")
    for tp in (4, 1):
        n = eng.transform(tp)
        seen = len(eng.transform_reports)
        while eng.transforming:
            out = eng.step()
            assert out["emitted"] > 0      # decoding never stalls
        for rep in eng.transform_reports[seen:]:
            ops = ",".join(f"L{o.layer}.{o.component}" for o in rep.ops)
            print(f"    schedule step [{ops}] "
                  f"{'kernels' if rep.kernel_plane else 'copies'} "
                  f"{rep.seconds*1e3:.1f}ms "
                  f"(modeled {rep.modeled_s*1e3:.3f}ms)")
        print(f"    transformation complete in {n} steps: {eng.par_layout}")
        if tp == 4:
            eng.step()
            print(">>> long request done: decomposing TP4 -> 4x(TP1)")
    eng.run_until_done()
    for r, w in zip(reqs, want):
        ok = r.generated == w.generated
        print(f"req{r.rid} {r.generated} {'== ref' if ok else '!! MISMATCH'}")
        assert ok
    print("token continuity preserved across both transformations")


if __name__ == "__main__":
    main()
