"""Control-plane demo on the PyTorch port: the scheduler drives live
engines (the counterpart of ``examples/serve_cluster.py``).

Two transformable instances (four workers each) serve a mixed trace in
two acts:

1. **In-place scale-up**: a long request that fits one engine's own
   workers at a higher TP yields a ``ScaleUp`` that the plane executes
   through ``Engine.transform``; a second long request rides the scaled
   instance, and the Alg-2 scan decomposes it afterwards.
2. **Cross-instance merge**: a request longer than ANY single engine's
   full-TP ceiling makes the scheduler borrow the idle engine (donor
   parked, workers adopted, donor KV migrated, one session across the
   widened mesh); the scale-down returns the loan and revives the donor.

    PYTHONPATH=src python examples/torch_serve_cluster.py [--device cpu]
    PYTHONPATH=src python examples/torch_serve_cluster.py --smoke  # merge
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.scheduler import ScaleDown, ScaleUp
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.request import ServeRequest


def act_one_in_place(cluster, req):
    """Scale-up within one engine's own workers."""
    shorts = [req(i, 6, 8) for i in range(4)]          # fit TP1
    long_a = req(100, 24, 16)                          # 40 tok -> TP4
    long_b = req(101, 30, 16)                          # rides the TP4

    for r in shorts[:2]:
        cluster.submit(r)
    for _ in range(3):
        cluster.step()
    n_before = len(cluster.actions)
    cluster.submit(long_a)   # unplaceable -> scheduler decides ScaleUp
    cluster.step()
    for act in cluster.actions[n_before:]:
        assert isinstance(act, ScaleUp) and not act.donor_iids
        print(f">>> scheduler decision: ScaleUp(instance {act.iid} -> "
              f"TP{act.tp_to}) [{act.reason}]")
    for r in shorts[2:]:
        cluster.submit(r)
    cluster.submit(long_b)
    cluster.run()
    ups = [a for a in cluster.actions if isinstance(a, ScaleUp)]
    downs = [a for a in cluster.actions if isinstance(a, ScaleDown)]
    for act in downs:
        print(f">>> scheduler decision: ScaleDown(instance {act.iid} -> "
              f"TP{act.tp_to}) [{act.reason}]")
    assert len(ups) == 1, "second long request must NOT scale up again"
    assert len(downs) >= 1 and all(e.tp == 1 for e in cluster.engines)
    assert all(r.done for r in shorts + [long_a, long_b])
    print("act 1: one in-place scale-up, one scale-down, "
          "zero dropped tokens\n")


def act_two_merge(cluster, req):
    """Cross-instance merge: borrow the whole idle engine (Fig. 3)."""
    e0 = cluster.engines[0]
    single = e0.max_seq_at(e0.max_tp)              # one engine, full TP
    merged = e0.max_seq_at(cluster.total_width)    # the whole pool
    print(f"act 2: request of {single + 16} tok > single-engine ceiling "
          f"{single}, <= pool ceiling {merged}")
    short = req(200, 6, 8)                  # donor-side in-flight work
    cluster.submit(short)
    for _ in range(2):
        cluster.step()
    n_before = len(cluster.actions)
    cluster.submit(req(201, single, 16))    # the merge trigger
    merges = [a for a in cluster.actions[n_before:]
              if isinstance(a, ScaleUp) and a.donor_iids]
    assert merges, "expected a cross-instance merge"
    act = merges[0]
    donor = cluster._engine(act.donor_iids[0])
    print(f">>> scheduler decision: ScaleUp(instance {act.iid} -> "
          f"TP{act.tp_to}, donors={list(act.donor_iids)}) [{act.reason}]")
    print(f"    donor {donor.iid} parked, its workers on loan; target "
          f"pool grew to {cluster._engine(act.iid).max_seq_alloc} "
          f"tok/slot")
    cluster.run()
    # the zero-stall contract: decode kept emitting THROUGH the
    # merge/split sessions
    assert cluster.stall_steps == 0, cluster.stall_steps
    print(f"    overlap: {cluster.tokens_during_session} tokens emitted "
          f"during {cluster.session_steps} cross-device session steps, "
          f"{cluster.stall_steps} decode stalls")
    downs = [a for a in cluster.actions[n_before:]
             if isinstance(a, ScaleDown)]
    for a in downs:
        print(f">>> scheduler decision: ScaleDown(instance {a.iid} -> "
              f"TP{a.tp_to}) [{a.reason}]")
    assert downs and not donor.parked and donor.tp == 1
    assert all(e.tp == 1 and not e.parked for e in cluster.engines)
    print(f"act 2: merged to TP{act.tp_to}, split back, donor revived "
          f"(final TPs {[e.tp for e in cluster.engines]})\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="run only the merge act")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    cluster = ClusterEngine(cfg, [args.device] * 8, n_instances=2,
                            max_batch=4, max_seq=64, dwell_steps=4)
    e0 = cluster.engines[0]
    print(f"cluster: 2 instances x {e0.W} workers | "
          f"TP1 ceiling {e0.max_seq_at(1)} tok, "
          f"TP{e0.max_tp} ceiling {e0.max_seq_at(e0.max_tp)} tok, "
          f"pool ceiling {e0.max_seq_at(cluster.total_width)} tok")

    rng = np.random.default_rng(0)

    def req(rid, plen, new):
        return ServeRequest(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, size=plen).tolist(), max_new_tokens=new)

    if not args.smoke:
        act_one_in_place(cluster, req)
    act_two_merge(cluster, req)
    m = cluster.metrics()
    print(f"served {m['total']} requests ({m['finished']} finished), "
          f"{cluster.n_transforms} transformations")


if __name__ == "__main__":
    main()
