"""Scheduler playground on the PyTorch port's simulator: replay the
paper's §6.2.4 hybrid workload (or a long-tail trace) against RR / LLF /
Gyges and print who triggers avoidable transformations (Fig. 13).  The
port's counterpart of ``examples/scheduler_sim.py``, with the same
traces, decisions and numbers; pure Python, no device.

    PYTHONPATH=src python examples/torch_scheduler_sim.py [--trace longtail]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.cluster_sim import Cluster, hybrid_trace, longtail_trace
from repro_torch.core.scheduler import SCHEDULERS


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="hybrid",
                    choices=["hybrid", "longtail"])
    ap.add_argument("--duration", type=float, default=300.0)
    args = ap.parse_args()

    cfg = get_config("qwen2.5-32b")
    if args.trace == "hybrid":
        trace = hybrid_trace(duration=args.duration, short_qpm=300,
                             long_qpm=1.0, out_len=300, seed=1)
    else:
        trace = longtail_trace(duration=args.duration, qps=2.0, seed=1)
    n_long = sum(1 for r in trace if r.in_len > 4000)
    print(f"trace: {len(trace)} requests ({n_long} long)")
    print(f"{'sched':8s} {'tps':>8s} {'fin':>9s} {'ttft_p99':>9s} "
          f"{'transforms':>11s}")
    for name in ("rr", "llf", "gyges"):
        c = Cluster(cfg, n_hosts=1, scheduler=SCHEDULERS[name]())
        m = c.run(trace, dt=0.25)
        print(f"{name:8s} {m['throughput_tps']:8.1f} "
              f"{m['finished']:4.0f}/{m['total']:4.0f} "
              f"{m['ttft_p99']:8.2f}s {m['n_transforms']:11.0f}")
    print("\n(gyges routes long requests to existing TP>1 instances — "
          "fewest transformations, paper Fig. 13)")


if __name__ == "__main__":
    main()
