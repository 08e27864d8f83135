"""What every part of the benchmark shares: where its files are, how a
cell's files are found by name, and the percentile arithmetic.

Nothing here imports the program.
"""
from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names no run may have loaded: JAX, its libraries and
#: the JAX package the program was ported from (compared whole, since
#: the program's own name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def percentile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (the arithmetic of the program's
    ``serving/metrics.py``, copied); NaN on empty input."""
    if not xs:
        return float("nan")
    xs = sorted(xs)
    k = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
    return xs[k]


def benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> Dict:
    """A cell of ``BENCHMARK.json`` with its files: the configuration
    (``configs/<config>.json``), the traffic mix (``traffic/<mix>.json``)
    and the serving set-up (``cells/<cell>.json``)."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"unknown workload {name!r}: one of "
                         f"{[w['name'] for w in bench['workloads']]}")
    return assemble(found[0], bench)


def assemble(w: Dict, bench: Optional[Dict] = None) -> Dict:
    """The cell of the workload entry ``w`` with its files, found by the
    names it gives."""
    bench = bench or benchmark()
    name = w["name"]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return {"workload": w,
            "config": read_json(ROOT / conf["file"]),
            "traffic": read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            "serve": read_json(BENCH / "cells" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])],
            "per_layer": [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]}


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """The ``read`` function of ``metrics/<metric>.py``; a name with a
    suffix after its first dot and no file of its own (``mfu_pct.batch``:
    the same quantity, moving another end-to-end metric) reads with the
    file of the name before the dot."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules) -> List[str]:
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


def finite(x: float) -> bool:
    return x is not None and not math.isnan(x) and not math.isinf(x)
