"""Find an open-loop cell's knee: the highest arrival rate at which the
backlog does not grow over the window.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 2.5,3,3.5,4

Sets the cell up once, then for each rate runs a window of ``seconds``
(the cell's mix at that rate, a seed of its own) and drains it, and
prints one JSON line a rate: the end-to-end metrics, the backlog
(requests due and not yet started) at each quarter of the window, and
the requests still unstarted at its close.  Run once, when a cell is
defined; the chosen rate is written into the mix's file.
"""
import time

T_PROC0 = time.monotonic()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def backlog(rd, t: float) -> int:
    return sum(1 for r in rd["requests"]
               if r["due"] <= t and (r["prefill_start"] is None
                                     or r["prefill_start"] > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch
    import harness
    import lib
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = lib.cell(args.workload)
    base = harness.Run(cell, args.seed, args.seconds, False,
                       t_proc0=T_PROC0)
    base.setup()
    print(json.dumps({"setup_s": time.monotonic() - T_PROC0}), flush=True)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        c = copy.deepcopy(cell)
        c["traffic"]["rate_req_s"] = rate
        run = harness.Run(c, args.seed + 1 + i, args.seconds, False)
        run.server = base.server
        run.make_traffic()
        run.window()
        rd = run.record()
        e2e = run.end_to_end(rd)
        q = [backlog(rd, rd["t0"] + f * args.seconds)
             for f in (0.25, 0.5, 0.75, 1.0)]
        print(json.dumps({"rate_req_s": rate, **e2e, "backlog": q,
                          "requests": len(rd["requests"]),
                          "failed": sum(r["failed"] for r in rd["requests"]),
                          "drain_s": run.t_end - rd["t_close"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
