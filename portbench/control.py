"""Readings for a cell's served-token limit: the program's widest gap
(``served_gap``) and the fp8 control's (``control_gap``) on the same
finished requests, a run of the cell a seed.  The control stands in the
program's place in the harness's own comparison, so each line's
``correct`` is the control's verdict, and has to read false.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n>,<n>,...

Each seed is one process of the cell at its own load (``run.py``'s
path, with the control judged beside the program); the benchmark's own
runs never compute the control.  Prints one JSON line a seed.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def one(workload: str, seed: int, seconds: float) -> int:
    import time
    t_proc0 = time.monotonic()
    sys.path.insert(0, HERE)
    import torch
    import harness
    import lib
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    run = harness.Run(lib.cell(workload), seed, seconds, False,
                      t_proc0=t_proc0)
    out = harness.result(run, control=True)
    print(json.dumps({"seed": seed, "correct": out["correct"],
                      **out["control"], "metrics": out["metrics"]}),
          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--one", action="store_true",
                    help="run a single seed in this process")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.one:
        return one(args.workload, seeds[0], args.seconds)
    rc = 0
    for s in seeds:
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__),
                               "--workload", args.workload, "--seconds",
                               str(args.seconds), "--seeds", str(s),
                               "--one"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
