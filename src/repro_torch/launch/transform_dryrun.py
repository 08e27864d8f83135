"""Dry run of the Gyges transformation itself, on the meta device: the
counterpart of ``repro.launch.transform_dryrun``.

The reference lowers the reshard of a pod of 64 hosts, each merging
4 x (TP1) into TP4 (the paper's Fig. 3, 64 times in parallel), and
counts the collective bytes of the compiled program.  Hosts are
independent, so one host of 4 workers gives the per-device numbers: this
runs the port's own live transformation (``core.instance.
InstanceGroup.transform``, the session the engines use) from TP1 x 4 to
TP4 on 4 workers on ``meta`` and records the bytes its exchanges moved
between workers (``launch.comm_analysis``).  Each worker keeps a slice
of its own replica of the weights, so they move no byte between
workers; the KV pools move by all-to-all, each worker sending the
(k-1)/k of its pages' heads that its k-1 peers now hold.

    PYTHONPATH=src python -m repro_torch.launch.transform_dryrun \\
        [--arch llama3-8b] [--tokens-per-seq 4096]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core.instance import InstanceGroup
from repro_torch.core.padding import make_plan
from repro_torch.core.weight_transform import relayout_block_mlp
from repro_torch.launch import specs as SP
from repro_torch.launch.comm_analysis import counting, total_collective_bytes
from repro_torch.models.blocks import ATTENTION_KINDS
from repro_torch.models.model import PAGE_TOKENS

OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "experiments", "dryrun_torch")

K = 4   # workers a host; TP1 x K -> TPK


def run(arch: str, tokens_per_seq: int, batch_per_rep: int = 4,
        cfg=None, save: bool = True) -> Dict[str, Any]:
    """One host's ``K x (TP1) -> TPK`` on meta: the record of its
    exchanges.  ``cfg`` overrides the registry's config."""
    cfg = cfg or get_config(arch)
    plan = make_plan(cfg, K, mode="page")
    model = SP.param_specs(cfg, plan)
    for blk in model.layers:
        relayout_block_mlp(blk.mlp, cfg.d_ff, plan.max_tp, cfg.activation)
    group = InstanceGroup(cfg, [SP.META] * K, batch_per_rep, tokens_per_seq,
                          page_tokens=PAGE_TOKENS, params=model)
    pools = [l.cache[0] for l in group.layers if l.kind in ATTENTION_KINDS]
    pool_bytes = K * sum(SP.nbytes(c.pool) for c in pools)
    t0 = time.time()
    with counting() as tally:
        group.transform(K)
    coll = tally.collective_bytes()
    rec = {
        "arch": arch, "mesh": f"1 host x (rep, tp) of {K} workers",
        "direction": f"{K}x(TP1) -> TP{K}",
        "run_s": round(time.time() - t0, 1),
        "collectives": coll,
        "collective_bytes_per_device": total_collective_bytes(coll) // K,
        "collective_ops": coll["count"],
        "weights_bytes_global": sum(SP.nbytes(p) for p in
                                    model.parameters()),
        "kv_pool_bytes_per_host": pool_bytes,
        "kv_pool_all_to_all_expected": pool_bytes * (K - 1) // K,
        "devices": K,
    }
    if save:
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, f"transform_{arch}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--tokens-per-seq", type=int, default=4096)
    args = ap.parse_args(argv)
    rec = run(args.arch, args.tokens_per_seq)
    print(f"OK transform {rec['arch']}: run={rec['run_s']}s "
          f"coll={rec['collective_bytes_per_device']:.3e} B/dev "
          f"({rec['collective_ops']} ops; all-to-all "
          f"{rec['collectives']['all-to-all']:.3e} B, expected "
          f"{rec['kv_pool_all_to_all_expected']:.3e})")


if __name__ == "__main__":
    main()
