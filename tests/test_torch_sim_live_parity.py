"""Sim/live differential parity inside the port: the counterpart of
``tests/test_sim_live_parity.py``, between the port's simulator
(``repro_torch.core.cluster_sim.Cluster``) and the port's live
``ClusterEngine`` on CPU workers (reduced llama3-8b in float32).

The reference harness's four cases, on the same traces and geometry:

* 8 single-worker engines, quantum 16, under ``gyges``, ``llf`` and
  ``rr``: a long request forces a width-4 merge;
* the capacity ladder: 4 width-2 engines, ``spill`` and
  ``partial_merge``: one request spills, one takes a partial merge;
* the timed trace (``benchmarks.bench_e2e.timed_parity_trace`` at 8
  bursts) replayed through both planes on one virtual clock;
* elastic SP: one 4-worker engine under ``layouts=True`` re-factorizes
  TP4 to SP2xTP2 mid-decode;

and the ladder again with a ``CalibratedCostModel`` (one fit on CPU
workers, shared by the two planes) attached to both schedulers.
Placements and the executed action sequences must be equal, and both
planes' metrics carry exactly ``METRIC_KEYS``.  Port live = JAX live is
``test_torch_cluster.py``'s; port sim = JAX sim is
``test_torch_cluster_sim.py``'s.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.calibrate import CalibratedCostModel, calibrate
from repro_torch.core.cluster_sim import Cluster
from repro_torch.core.events import SLO, VirtualClock, replay
from repro_torch.core.scheduler import (SCHEDULERS, GygesScheduler,
                                        PrefillPolicy, ScaleUp,
                                        SchedulerConfig, Spill)
from repro_torch.serving.cluster import ClusterEngine, LiveReplayPlane
from repro_torch.serving.metrics import METRIC_KEYS
from repro_torch.serving.request import Request, ServeRequest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = 16

#: the reference harness's traces: (rid, prompt_len, out_len)
TRACE = [(0, 10, 4), (1, 12, 4), (2, 8, 4), (3, 40, 8), (4, 10, 4),
         (5, 6, 4)]
LADDER_TRACE = [(0, 10, 4), (1, 24, 16), (2, 40, 16), (3, 10, 4)]
LAYOUT_TRACE = [(0, 4, 8), (1, 4, 8), (2, 40, 24), (3, 4, 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="float32")


def _policy(budget=16):
    return PrefillPolicy(token_budget=budget, mode="mixed",
                         long_threshold=Q, order="sjf")


def _prompts(cfg, trace):
    rng = np.random.default_rng(0)
    return {rid: rng.integers(0, cfg.vocab_size, size=n).tolist()
            for rid, n, _ in trace}


def _act_key(a):
    return (type(a).__name__, a.iid, getattr(a, "tp_to", None),
            tuple(sorted(getattr(a, "donor_iids", ()) or ())),
            tuple(getattr(a, "donor_devices", ()) or ()),
            getattr(a, "host_iid", None), str(getattr(a, "layout", None)))


def _live_drained(live, trace, cfg, check=None):
    """Submit each request and drain the cluster (and its Alg-2 quiet
    window) before the next, as the reference harness does."""
    prompts = _prompts(cfg, trace)
    for rid, _, out in trace:
        live.submit(ServeRequest(rid=rid, prompt=list(prompts[rid]),
                                 max_new_tokens=out))
        live.run(max_steps=8000)
        assert all(e.tp == 1 and not e.parked for e in live.engines), rid
        if check is not None:
            check(live)
    return live.metrics()


def _sim_drained(sim, trace, dwell, advance=True):
    """The harness's sim loop: submit, then advance (or, for the first
    case, tick and scan Alg 2 by hand) until the request finished, every
    instance is back at TP1 and nothing waits."""
    sim.scale_down_dwell = dwell
    now, dt = 0.0, 0.25
    for rid, n, out in trace:
        sim.submit(Request(rid, now, n, out), now)
        for _ in range(20000):
            if advance:
                sim.advance(now, dt)
            else:
                sum(i.tick(now, dt) for i in sim.instances)
                eligible = [i for i in sim.instances if i.tp > 1 and
                            now > i.transform_until + sim.scale_down_dwell]
                by_iid = {i.iid: i for i in eligible}
                for act in sim.scheduler.schedule_parallelism(eligible,
                                                              False):
                    sim.execute_scale_down(by_iid[act.iid], now)
            now += dt
            # the reference's first case reads ``sim.all_requests``, which
            # only ``run`` fills: it waits for the scale-down alone
            done = (all(r.tokens_done >= r.out_len
                        for r in sim._req_by_rid.values())
                    if advance else True)
            if done and all(i.tp == 1 for i in sim.instances) \
                    and not sim.waiting and not sim.partition.spills():
                break
        else:
            raise RuntimeError(f"sim did not drain request {rid}")
        sim.partition.check_invariants()
    return sim.metrics(now)


def _same(live, sim, m_live, m_sim):
    assert live.placements == sim.placements, (live.placements,
                                               sim.placements)
    assert [_act_key(a) for a in live.actions] == \
        [_act_key(a) for a in sim.actions], (live.actions, sim.actions)
    assert list(m_live) == list(m_sim) == list(METRIC_KEYS)


@pytest.mark.parametrize("sched", ["gyges", "llf", "rr"])
def test_decision_parity_sim_vs_live(sched):
    """8 single-worker engines: the long request is a width-4 merge in
    both planes, with the same target and donors, and every request
    lands on the same instance."""
    cfg = _cfg()
    mk = lambda: SCHEDULERS[sched](SchedulerConfig(long_threshold=Q,
                                                   target_tp=4))
    live = ClusterEngine(cfg, ["cpu"] * 8, n_instances=8, max_batch=2,
                         max_seq=Q, page_tokens=Q, dwell_steps=4,
                         scheduler=mk(), prefill_policy=_policy())
    m_live = _live_drained(live, TRACE, cfg)
    sim = Cluster(cfg, n_hosts=1, gpus_per_host=8, scheduler=mk(),
                  target_tp=4, prefill_policy=_policy(), seq_quantum=Q,
                  max_batch=2)
    m_sim = _sim_drained(sim, TRACE, 5.0, advance=False)
    _same(live, sim, m_live, m_sim)
    assert sum(1 for a in live.actions
               if isinstance(a, ScaleUp) and a.donor_iids) >= 1


def _ladder_sched(cost=None):
    s = GygesScheduler(SchedulerConfig(
        long_threshold=Q, target_tp=4, spill=True, partial_merge=True,
        spill_slack=2.0))
    if cost is not None:
        s.attach_cost(cost)
    return s


def _no_spills(cl):
    assert not cl.partition.spills(), "a spill region outlived its request"


def _ladder(cost_of=None):
    """The ladder trace through 4 width-2 live engines and the matched
    sim; ``cost_of()`` gives each plane its own cost model."""
    cfg = _cfg()
    live = ClusterEngine(cfg, ["cpu"] * 8, n_instances=4, max_batch=2,
                         max_seq=2 * Q, page_tokens=Q, dwell_steps=4,
                         scheduler=_ladder_sched(cost_of and cost_of(cfg)),
                         prefill_policy=_policy())
    # width-2 engines construct at tp=2; the ladder serves shorts at tp=1
    for e in live.engines:
        e.transform(1)
    live.run(max_steps=4000)
    assert not live.actions and live.n_transforms == 0
    m_live = _live_drained(live, LADDER_TRACE, cfg, check=_no_spills)
    live.partition.check_invariants()
    cm = cost_of(cfg) if cost_of else None
    sim = Cluster(cfg, n_hosts=1, gpus_per_host=8,
                  scheduler=_ladder_sched(cm), target_tp=4,
                  prefill_policy=_policy(), seq_quantum=Q, max_batch=2,
                  widths=[2, 2, 2, 2], page_tokens=Q, cost_model=cm)
    m_sim = _sim_drained(sim, LADDER_TRACE, 5.0)
    _same(live, sim, m_live, m_sim)
    assert any(isinstance(a, Spill) for a in live.actions), live.actions
    assert any(isinstance(a, ScaleUp) and a.donor_devices
               for a in live.actions), live.actions
    assert m_live["spill_pages"] == m_sim["spill_pages"] > 0
    assert m_live["partial_merges"] == m_sim["partial_merges"] >= 1
    return live


def test_ladder_decision_parity_partial_merge_and_spill():
    _ladder()


def test_calibrated_ladder_parity_sim_vs_live():
    """One calibration on CPU workers; each plane attaches its own
    ``CalibratedCostModel`` over the shared fitted link; the decisions
    stay equal and the live plane fed realized wall times into its
    EWMA."""
    link = calibrate(_cfg(), devices=["cpu"] * 2, repeats=2).link
    live = _ladder(lambda cfg: CalibratedCostModel(cfg, link=link))
    assert sum(live.scheduler.cost_model.measured._count.values()) >= 1


def _timed_trace():
    """``benchmarks.bench_e2e.timed_parity_trace``, in the port's types:
    every 20 virtual seconds a burst of 8-16 short prompts (4/8/12
    tokens, 4 out), every 4th burst a lone long request (40 in, 8 out)
    that forces a width-4 merge."""
    reqs, rid = [], 0
    for k in range(8):
        t = 20.0 * k
        if k % 4 == 3:
            reqs.append(Request(rid, t, 40, 8,
                                slo=SLO(ttft_s=15.0, tpot_s=2.0)))
            rid += 1
        else:
            for j in range(8 + (k % 9)):
                reqs.append(Request(rid, t, (4, 8, 12)[j % 3], 4,
                                    slo=SLO(ttft_s=15.0, tpot_s=2.0)))
                rid += 1
    return reqs


def test_timed_trace_equals_reference():
    sys.path.insert(0, REPO)
    try:
        from benchmarks.bench_e2e import timed_parity_trace
    finally:
        sys.path.remove(REPO)
    key = lambda r: (r.rid, r.arrive, r.in_len, r.out_len, r.slo.ttft_s,
                     r.slo.tpot_s)
    assert [key(r) for r in _timed_trace()] == \
        [key(r) for r in timed_parity_trace(8)]


def test_timed_trace_decision_parity():
    """The event clock: the bursty timed trace through both planes on
    one virtual clock gives the same routing and actions, every request
    finishes and both planes report positive goodput."""
    cfg = _cfg()
    mk = lambda: GygesScheduler(SchedulerConfig(long_threshold=Q,
                                                target_tp=4))
    clock = VirtualClock()
    live = ClusterEngine(cfg, ["cpu"] * 8, n_instances=8, max_batch=2,
                         max_seq=Q, page_tokens=Q, dwell_steps=4,
                         scheduler=mk(), prefill_policy=_policy(),
                         clock=clock)
    replay(LiveReplayPlane(live), _timed_trace(), dt=0.5, settle_steps=60,
           clock=clock)
    m_live = live.metrics()
    sim = Cluster(cfg, n_hosts=1, gpus_per_host=8, scheduler=mk(),
                  target_tp=4, prefill_policy=_policy(), seq_quantum=Q,
                  max_batch=2)
    sim.scale_down_dwell = 2.0
    m_sim = sim.run_timed(_timed_trace(), dt=0.5, settle_steps=60)
    _same(live, sim, m_live, m_sim)
    n = len(_timed_trace())
    assert m_live["finished"] == m_sim["finished"] == n
    assert m_live["goodput_slo"] > 0.0 and m_sim["goodput_slo"] > 0.0
    assert any(getattr(a, "donor_iids", None) for a in live.actions)


def test_layout_decision_parity_sim_vs_live():
    """One 4-worker engine: the long request grows it to TP4 in place,
    and the ``layouts=True`` scan re-factorizes it to SP2xTP2 in both
    planes before the split back to TP1."""
    cfg = _cfg()
    mk = lambda: GygesScheduler(SchedulerConfig(
        long_threshold=Q, target_tp=4, partial_merge=True, layouts=True))
    live = ClusterEngine(cfg, ["cpu"] * 4, n_instances=1, max_batch=4,
                         max_seq=4 * Q, page_tokens=Q, dwell_steps=4,
                         scheduler=mk(), prefill_policy=_policy(Q))
    _live_drained(live, LAYOUT_TRACE, cfg)
    m_live = live.run(max_steps=8000)
    sim = Cluster(cfg, n_hosts=1, gpus_per_host=4, widths=[4],
                  scheduler=mk(), target_tp=4, prefill_policy=_policy(Q),
                  seq_quantum=Q, max_batch=4)
    m_sim = _sim_drained(sim, LAYOUT_TRACE, 0.0)
    _same(live, sim, m_live, m_sim)
    assert any(str(getattr(a, "layout", None)) == "SP2xTP2"
               for a in live.actions), live.actions
