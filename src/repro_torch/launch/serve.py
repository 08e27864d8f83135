"""Serving launcher: a thin CLI over the port's ``ClusterEngine`` control
plane (the counterpart of ``repro.launch.serve``, with its flags, trace
and printed lines).

The §5 scheduler (``GygesScheduler`` by default) routes every request and
decides every transformation; this module only parses arguments, builds
the trace, and prints what the control plane did.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch llama3-8b] \
        [--instances 2] [--requests 16] [--long-every 5] [--scheduler gyges] \
        [--device cuda] [--workers 8] [--no-smoke]

The pool is ``--workers`` workers of ``--device``: by default 8 workers
of the card, as the reference's 8 devices (it raises without a GPU;
``--device cpu`` runs the plain PyTorch path).  At 8 the reduced
``llama3-8b`` (4 kv heads) runs with replicated kv heads, as the
reference's GQA padding rule lays them out.  Short requests spread over
the TP1 instances, a long request
triggers a scheduler-issued live scale-up (``Engine.transform``, one
§4.3 schedule step per engine step), and the Alg-2 scan decomposes the
instance once the long request drains.

By default the model is the reduced config in float32.  ``--no-smoke``
serves the published config at full width and depth in its own dtype
(random weights), e.g. the paper's own qwen2.5-32b (62.3 GB in bf16),
which fits one H100 as one instance of one worker: ``--arch qwen2.5-32b
--no-smoke --instances 1 --workers 1 --max-seq 8192``.  ``--model`` is
another name for ``--arch``: ``--model xlstm-1.3b --no-smoke`` serves
xLSTM[7:1] (42 mLSTM and 6 sLSTM blocks, no MLP) the same way.

An encoder-decoder (``--arch whisper-tiny``) or a vision model (``--arch
phi-3-vision-4.2b``) serves with stub frontend inputs drawn from
``--seed``: every request's frames, every other request's patches (the
rest text only).  Such a model never changes degree (the reference's
per-layer paths refuse it), so a trace with long requests, which makes
the scheduler transform, is refused at start: pass ``--long-every 0``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.registry import all_configs
from repro_torch.core.scheduler import SCHEDULERS, PrefillPolicy, ScaleUp
from repro_torch.launch.mesh import resolve_device
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import live_change_refusal
from repro_torch.serving.request import ServeRequest


def build_trace(n: int, long_every: int, cluster: ClusterEngine,
                gen_tokens: int, seed: int = 0) -> list:
    """Mixed short/long ServeRequests sized against the cluster's
    admission ceilings: shorts fit a TP1 instance, longs need max TP.
    An encoder-decoder's requests carry frames, every other request of
    a vision model patches (stub embeddings from a generator of their
    own, seeded by ``seed``); the patches count in a request's
    context."""
    cfg = cluster.cfg
    rng = np.random.default_rng(seed)
    stub = np.random.default_rng([seed, 1])
    base = cluster.engines[0].max_seq_at(1)
    full = cluster.engines[0].max_seq_at(cluster.engines[0].max_tp)
    reqs = []
    for i in range(n):
        patches = None
        if cfg.vision is not None and i % 2 == 0:
            patches = stub.standard_normal(
                (cfg.vision.num_patches, cfg.d_model), dtype=np.float32)
        room = gen_tokens + (0 if patches is None else len(patches))
        if long_every and (i + 1) % long_every == 0:
            plen = max(1, full - room - 1)
        else:
            plen = int(rng.integers(2, max(3, base - room)))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).tolist()
        frames = None if cfg.encoder is None else stub.standard_normal(
            (cfg.encoder.num_frames, cfg.d_model), dtype=np.float32)
        reqs.append(ServeRequest(rid=i, prompt=prompt,
                                 max_new_tokens=gen_tokens, frames=frames,
                                 patches=patches))
    return reqs


def _action_line(act) -> str:
    kind = "scale-up" if isinstance(act, ScaleUp) else "scale-down"
    return f"{kind} instance {act.iid} -> TP{act.tp_to} ({act.reason})"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", default="llama3-8b",
                    choices=sorted(all_configs(include_paper_model=True)))
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--scheduler", default="gyges",
                    choices=sorted(SCHEDULERS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--long-every", type=int, default=5,
                    help="every Nth request is long-context (0 = none)")
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=0,
                    help="slots per instance (0 = one per worker)")
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="chunked-prefill token budget per engine step "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--prefill-mode", default="mixed",
                    choices=("prefill", "decode", "mixed"),
                    help="prefill/decode priority when budgeted")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced model config in float32 (default); "
                         "--no-smoke: the published config at full width "
                         "and depth, in its own dtype")
    ap.add_argument("--device", default="cuda",
                    help="device of every worker (default the card)")
    ap.add_argument("--workers", type=int, default=8,
                    help="workers of --device in the pool")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the trace and of its stub frames and "
                         "patches")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    reason = live_change_refusal(cfg)
    if reason is not None and args.long_every:
        ap.error(f"{cfg.name} serves at a static degree ({reason}): long "
                 "requests would make the scheduler transform it; pass "
                 "--long-every 0")
    devs = [resolve_device(args.device)] * args.workers
    w = len(devs) // args.instances
    policy = (PrefillPolicy(token_budget=args.prefill_budget,
                            mode=args.prefill_mode,
                            long_threshold=args.max_seq // w or 1,
                            order="sjf")
              if args.prefill_budget else None)
    cluster = ClusterEngine(
        cfg, devs, n_instances=args.instances,
        max_batch=args.max_batch or w, max_seq=args.max_seq,
        scheduler=None if args.scheduler == "gyges"
        else SCHEDULERS[args.scheduler](),
        prefill_policy=policy)
    print(f"[serve] {cfg.name}: {args.instances} instances x {w} devices, "
          f"scheduler={cluster.scheduler.name}, "
          f"TP1 ceiling {cluster.engines[0].max_seq_at(1)} tok, "
          f"TP{w} ceiling {cluster.engines[0].max_seq_at(w)} tok")

    trace = build_trace(args.requests, args.long_every, cluster,
                        args.gen_tokens, seed=args.seed)
    n_long = sum(1 for r in trace
                 if cluster.scheduler.is_long(r.total_tokens))
    print(f"[serve] trace: {len(trace)} requests ({n_long} long)")
    seen = 0
    for r in trace:
        cluster.submit(r)
        cluster.step()
        for act in cluster.actions[seen:]:
            print(f"[serve] step {cluster.steps}: {_action_line(act)}")
        seen = len(cluster.actions)
    m = cluster.run()   # drain + Alg-2 quiet window
    for act in cluster.actions[seen:]:
        print(f"[serve] drain: {_action_line(act)}")
    print(f"[serve] final TPs: {[e.tp for e in cluster.engines]}")
    print("[serve] " + ", ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in m.items()))


if __name__ == "__main__":
    main()
