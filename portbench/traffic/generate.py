"""The one traffic generator: reads a mix's data file and makes requests.

A mix file (``traffic/<mix>.json``) names its ``kind`` and its parameters:

* ``open_poisson``: independent users at ``rate_req_s``.  A run of
  ``seconds`` gets ``round(rate * seconds)`` requests, due at the partial
  sums of exponential gaps rescaled to end inside the window.
* ``closed_loop``: ``clients`` callers, each sending its next request
  when its last one is done, from a shared pool of ``pool`` requests.

Every mix lists ``classes`` (a share and a length law for the prompt and
for the output) and may carry ``images`` (a vision request's patch
prefix).  The lengths and gaps are drawn once from the mix's own
``population_seed``: every run seed gets the same set of sizes and gaps,
in another order (a permutation drawn from the run seed), or, where the
mix says ``"order": "fixed"``, in the same order.  The run seed also
gives each request's token ids and patches.  The length and arrival
arithmetic (a lognormal clipped to a range, exponential gaps) is that of
the simulator's trace generators (``core/cluster_sim.py``:
``longtail_trace``, ``production_trace``), copied here so that the
yardstick does not move with the program.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclass
class Spec:
    """One request as the traffic makes it: its id, when it is due (an
    open loop; None for a closed loop), its lengths, and whether it
    carries an image (the model's patch prefix)."""
    rid: int
    prompt_len: int
    out_len: int
    due: Optional[float] = None
    image: bool = False
    cls: int = 0


def load(mix: str) -> Dict:
    with open(HERE / f"{mix}.json") as f:
        return json.load(f)


def _rng(*parts: int) -> np.random.Generator:
    return np.random.default_rng([int(p) & ((1 << 63) - 1) for p in parts])


def draw_length(law: Dict, rnd: np.random.Generator, n: int) -> np.ndarray:
    """``n`` lengths from ``law``: ``lognormal`` (``median``, ``sigma``)
    or ``uniform`` (inclusive), clipped to [``min``, ``max``]."""
    lo, hi = int(law["min"]), int(law["max"])
    if law["dist"] == "lognormal":
        x = rnd.lognormal(math.log(law["median"]), law["sigma"], n)
    elif law["dist"] == "uniform":
        x = rnd.integers(lo, hi + 1, n)
    else:
        raise ValueError(f"unknown length law {law['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def population(mix: Dict, n: int) -> List[Spec]:
    """``n`` requests of the mix from its population seed: each class
    gets ``round(share * n)`` of them (the last class takes the rest), in
    an order drawn from the same seed."""
    rnd = _rng(mix["population_seed"], n)
    classes = mix["classes"]
    counts = [int(round(c["share"] * n)) for c in classes[:-1]]
    counts.append(n - sum(counts))
    if min(counts) < 0:
        raise ValueError(f"class shares of {mix} do not fit {n} requests")
    by_class: List[List[Spec]] = []
    for ci, (c, k) in enumerate(zip(classes, counts)):
        p = draw_length(c["prompt"], rnd, k)
        o = draw_length(c["output"], rnd, k)
        img = rnd.random(k) < float(c.get("images", mix.get("images", 0)))
        by_class.append([Spec(0, int(a), int(b), image=bool(m), cls=ci)
                         for a, b, m in zip(p, o, img)][::-1])
    # the classes interleave in an order drawn from the population seed
    labels = rnd.permutation(np.repeat(np.arange(len(classes)), counts))
    return [by_class[ci].pop() for ci in labels]


def _order(mix: Dict, seed: int, stream: int, n: int) -> np.ndarray:
    """The order of a population: drawn from the run seed, or, where the
    mix says ``"order": "fixed"``, the population's own (every seed then
    gets the same schedule; its tokens, patches and weights still come
    from the seed)."""
    if mix.get("order", "permuted") == "fixed":
        return np.arange(n)
    return _rng(seed, stream).permutation(n)


def open_loop(mix: Dict, seed: int, seconds: float) -> List[Spec]:
    """The requests due in a window of ``seconds``, in due order."""
    n = max(1, int(round(mix["rate_req_s"] * seconds)))
    pop = population(mix, n)
    gaps = _rng(mix["population_seed"], n, 1).exponential(1.0, n + 1)
    order = _order(mix, seed, 2, n)
    gaps = gaps[_order(mix, seed, 3, n + 1)]
    due = np.cumsum(gaps)[:n] * (seconds / gaps.sum())
    specs = [pop[i] for i in order]
    for rid, (s, t) in enumerate(zip(specs, due)):
        s.rid, s.due = rid, float(t)
    return specs


def closed_loop(mix: Dict, seed: int) -> List[Spec]:
    """The shared pool of a closed loop, in the order clients take it."""
    pop = population(mix, int(mix["pool"]))
    specs = [pop[i] for i in _order(mix, seed, 2, len(pop))]
    for rid, s in enumerate(specs):
        s.rid = rid
    return specs


def prompt_tokens(seed: int, rid: int, n: int, vocab: int) -> List[int]:
    """The prompt's token ids, uniform over the vocabulary."""
    return _rng(seed, rid, 5).integers(0, vocab, n).tolist()


def patch_seed(seed: int, rid: int) -> int:
    h = hashlib.sha256(f"patches:{seed}:{rid}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def patches(seed: int, rid: int, n: int, d: int, device, dtype):
    """A vision request's stub patch embeddings (n, d): standard normal,
    made on ``device`` from the run seed and the request id."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(patch_seed(seed, rid))
    return torch.randn((n, d), generator=g, device=device, dtype=dtype)
