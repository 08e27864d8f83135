"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell named in ``BENCHMARK.json`` (its configuration, traffic
mix and serving files), warms it up, measures for ``--seconds``, judges
what was served against the plain reference, and prints the result as
the last line of standard output (the numbers compared, with their
limits, as the last lines of standard error).  ``--trace 1`` reports the
cell's per-layer metrics instead of its end-to-end ones.  Exits non-zero
with no result without a CUDA card (it never falls back to the CPU), and
when JAX or the JAX package was loaded.
"""
import time

T_PROC0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    import lib
    cell = lib.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card for {args.workload} (needs {chips}; "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0})",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    import harness
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_proc0=T_PROC0)
    out = harness.result(run)
    bad = lib.forbidden_modules(list(sys.modules))
    if bad:
        print(f"loaded modules it must not: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
