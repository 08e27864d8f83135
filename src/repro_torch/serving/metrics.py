"""Request-level serving metrics shared by the simulator and the live
cluster (paper §6 reporting: throughput, TTFT/TPOT percentiles,
transformation count).

``core.cluster_sim.Cluster.metrics`` and
``serving.cluster.ClusterEngine.metrics`` both return exactly
``summarize(...)`` so the two planes report a key-identical schema —
the sim-vs-live parity contract tested by tests/test_cluster_engine.py.

jax-free on purpose: the simulator and benchmark entry points import it
before any jax initialization.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

#: the schema every cluster (simulated or live) reports, in order.
#: queue_delay (submit -> first prefill work) is the head-of-line wait
#: the chunked-prefill policy bounds; TTFT = queue_delay + prefill time.
#: transform_s_* are PER-ACTION transformation latencies (live: wall
#: time from transform() to session drain; sim: the modeled duration);
#: transform_drift_frac is the median relative |measured - modeled|
#: drift of the executed schedule steps (StepReport.seconds, dispatch
#: -> resident; 0 in the sim, where measured IS the model).  Live,
#: overlapped steps' spans include the serving work the transfer hid
#: under, so the column UPPER-BOUNDS model error on this path; the
#: honest modeled-vs-measured drift is ``core.calibrate``'s ISOLATED
#: micro-spans (the gated ``calibration.*`` trajectory columns) — the
#: per-action log also carries exposed_s (dispatch + blocking wait,
#: the cost serving actually paid); merge_wall_s is the cumulative wall
#: time spent inside CROSS-DEVICE (merge/split) sessions — the window
#: that used to stall decode and now overlaps serving.
#: goodput_slo is the fraction of SLO-carrying requests whose TTFT and
#: TPOT deadlines were met (core.events.SLO.met); requests still queued
#: or in flight at trace end are CENSORED — counted in the denominator
#: as violating, never silently dropped.  NaN when no request carries
#: an SLO (the untimed lockstep paths).
#: spill_pages / partial_merges count the capacity-ladder rungs below a
#: full merge: KV pages spilled into neighbor pools (Infinite-LLM-style
#: distributed-pool serving) and merges satisfied by fractional device
#: loans with every member still serving.  Both planes feed them from
#: the shared PoolPartitionManager ledger.
METRIC_KEYS = ("throughput_tps", "finished", "total",
               "ttft_p50", "ttft_p99",
               "queue_delay_p50", "queue_delay_p99",
               "tpot_p50", "tpot_p99",
               "goodput_slo",
               "n_transforms",
               "transform_s_p50", "transform_s_p99",
               "transform_drift_frac", "merge_wall_s",
               "spill_pages", "partial_merges")


def percentile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (NaN on empty input)."""
    if not xs:
        return float("nan")
    xs = sorted(xs)
    k = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
    return xs[k]


def summarize(requests: Sequence, duration_s: float, total_tokens: float,
              n_transforms: int,
              transforms: Sequence[Dict] = (),
              spill_pages: int = 0,
              partial_merges: int = 0) -> Dict[str, float]:
    """Aggregate per-request latency metrics into the shared schema.

    ``requests`` may be trace records (``Request``) or live requests
    (``ServeRequest``) — anything exposing ``finished`` / ``ttft`` /
    ``queue_delay`` / ``tpot``.

    ``transforms`` is the per-action transformation record list both
    planes keep: dicts with ``wall_s`` (action latency), ``measured_s``
    / ``modeled_s`` (summed StepReport seconds vs the accounting-plane
    prediction) and ``cross`` (device assembly changed — merge/split).
    """
    fin = [r for r in requests if r.finished]
    # goodput under SLO: denominator is EVERY request carrying an SLO,
    # so a request still queued at trace end counts as violating
    # (censored) instead of being dropped with the latency percentiles
    slod = [r for r in requests if getattr(r, "slo", None) is not None]
    goodput = (sum(1 for r in slod if r.slo.met(r)) / len(slod)
               if slod else float("nan"))
    ttfts = [r.ttft for r in requests if r.ttft is not None]
    qdels = [r.queue_delay for r in requests
             if getattr(r, "queue_delay", None) is not None]
    tpots = [r.tpot for r in fin if r.tpot is not None]
    walls = [t["wall_s"] for t in transforms]
    drifts: List[float] = []
    for t in transforms:
        # per-step drift when the plane recorded it (live sessions —
        # action-level sums would let signed step errors cancel); the
        # sim records actions only, where measured IS the model
        if t.get("step_drifts") is not None:
            drifts.extend(t["step_drifts"])
        elif t.get("modeled_s", 0.0) > 0.0:
            drifts.append(abs(t["measured_s"] - t["modeled_s"])
                          / t["modeled_s"])
    return {
        "throughput_tps": total_tokens / max(duration_s, 1e-9),
        "finished": len(fin),
        "total": len(requests),
        "ttft_p50": percentile(ttfts, 50),
        "ttft_p99": percentile(ttfts, 99),
        "queue_delay_p50": percentile(qdels, 50),
        "queue_delay_p99": percentile(qdels, 99),
        "tpot_p50": percentile(tpots, 50),
        "tpot_p99": percentile(tpots, 99),
        "goodput_slo": goodput,
        "n_transforms": float(n_transforms),
        "transform_s_p50": percentile(walls, 50),
        "transform_s_p99": percentile(walls, 99),
        "transform_drift_frac": percentile(drifts, 50),
        "merge_wall_s": float(sum(t["wall_s"] for t in transforms
                                  if t.get("cross"))),
        "spill_pages": float(spill_pages),
        "partial_merges": float(partial_merges),
    }
