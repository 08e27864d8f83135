"""The port's cluster simulator (``repro_torch.core.cluster_sim``)
against the reference's (``repro.core.cluster_sim``), run for run.

Short runs (60-120 s of virtual time) of the four trace generators
under ``gyges``, ``llf`` and ``rr``, then the capacity-ladder
configuration (``spill``, ``partial_merge`` on width-2 instances over
a linear capacity contract), ``layouts=True`` on width-4 instances, and
the ladder with a cost model attached to the scheduler (the prior and a
``CalibratedCostModel`` with a fitted-looking link).  Both packages'
generators must give the same trace for a seed; the runs must give the
same ``actions``, ``placements`` and ``transform_log``, and ``metrics()``
key for key, with NaN in the same places and floats within 1e-9
relative.  Pure Python.
"""
import dataclasses
import math

import pytest

from repro.configs import get_config as ref_config
from repro.core import calibrate as RK
from repro.core import cluster_sim as RS
from repro.core import costmodel as RC
from repro.core import kv_transform as RKT
from repro.core import scheduler as RSch
from repro_torch.configs import get_config
from repro_torch.core import calibrate as TK
from repro_torch.core import cluster_sim as TS
from repro_torch.core import costmodel as TC
from repro_torch.core import kv_transform as TKT
from repro_torch.core import scheduler as TSch

REL = 1e-9

#: trace name -> (generator keywords, model, how the run is driven)
TRACES = {
    "hybrid": (dict(duration=90.0, short_qpm=300.0, long_qpm=2.0,
                    out_len=300, seed=1), "qwen2.5-32b", "run"),
    "longtail": (dict(duration=120.0, qps=2.0, seed=1), "qwen2.5-32b",
                 "run"),
    "burst": (dict(duration=60.0, burst_at=20.0, burst_n=4,
                   burst_len=20_000, seed=2), "qwen2.5-32b", "policy"),
    "production": (dict(duration=60.0, burst_period=30.0, seed=3),
                   "qwen2.5-32b", "timed"),
}


def _trace(pkg, name):
    kw = TRACES[name][0]
    return getattr(pkg, f"{name}_trace")(**kw)


def _req_key(r):
    slo = r.slo
    return (r.rid, r.arrive, r.in_len, r.out_len,
            None if slo is None else (slo.ttft_s, slo.tpot_s))


def _act_key(a):
    d = dataclasses.asdict(a)
    d["layout"] = str(getattr(a, "layout", None))
    return type(a).__name__, sorted(d.items(), key=lambda kv: kv[0])


def _same_metrics(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and math.isnan(x):
            assert isinstance(y, float) and math.isnan(y), (k, x, y)
        else:
            assert math.isclose(x, y, rel_tol=REL, abs_tol=0.0), (k, x, y)


def _same_runs(ref, port, m_ref, m_port):
    assert [_act_key(a) for a in ref.actions] == \
        [_act_key(a) for a in port.actions]
    assert ref.placements == port.placements
    assert ref.transform_log == port.transform_log
    _same_metrics(m_ref, m_port)


def _run(pkg, cfg_of, name, sched):
    """``policy``: a token-budgeted decode-priority ``PrefillPolicy`` (the
    burst case's); ``timed``: the event-driven ``run_timed``."""
    kw, model, how = TRACES[name]
    trace = _trace(pkg, name)
    pol = None
    if how == "policy":
        pol = (RSch if pkg is RS else TSch).PrefillPolicy(
            token_budget=2048, mode="decode", order="sjf")
    c = pkg.Cluster(cfg_of(model), n_hosts=1, scheduler=sched,
                    prefill_policy=pol)
    m = (c.run_timed(trace, dt=0.25, settle_steps=40) if how == "timed"
         else c.run(trace, dt=0.25))
    return c, m


@pytest.mark.parametrize("name", sorted(TRACES))
def test_traces_equal(name):
    ref, port = _trace(RS, name), _trace(TS, name)
    assert len(ref) > 10
    assert [_req_key(r) for r in ref] == [_req_key(r) for r in port]


@pytest.mark.parametrize("sched", ["gyges", "llf", "rr"])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_runs_equal(name, sched):
    ref, m_ref = _run(RS, ref_config, name, RSch.SCHEDULERS[sched]())
    port, m_port = _run(TS, get_config, name, TSch.SCHEDULERS[sched]())
    _same_runs(ref, port, m_ref, m_port)
    assert m_ref["finished"] > 0


def _ladder(pkg_s, **kw):
    return pkg_s.GygesScheduler(pkg_s.SchedulerConfig(
        long_threshold=2048, target_tp=4, spill=True, partial_merge=True,
        spill_slack=2.0, **kw))


LADDER = dict(widths=[2, 2, 2, 2], seq_quantum=2048, max_batch=2,
              page_tokens=64, gpus_per_host=8)


def _ladder_trace(pkg):
    """Shorts, and longs whose totals fall on each rung of width-2
    instances at quantum 2048: spill (4097-6144), partial merge
    (6145-8192)."""
    reqs = pkg.hybrid_trace(duration=90.0, short_qpm=40.0, long_qpm=1e-6,
                            short_len=600, out_len=48, seed=5)
    rid = len(reqs)
    for t, n in ((10.0, 4500), (30.0, 7000), (50.0, 4800), (70.0, 6500)):
        reqs.append(pkg.Request(rid, t, n, 48))
        rid += 1
    return reqs


def _ladder_runs(attach=None):
    out = []
    for pkg, pkg_s, cfg_of, cost in ((RS, RSch, ref_config, "ref"),
                                     (TS, TSch, get_config, "port")):
        sched = _ladder(pkg_s)
        cm = None
        if attach is not None:
            cm = attach(cost, cfg_of("llama3-8b"))
            sched.attach_cost(cm)
        c = pkg.Cluster(cfg_of("llama3-8b"), n_hosts=1, scheduler=sched,
                        cost_model=cm, **LADDER)
        out.append((c, c.run(_ladder_trace(pkg), dt=0.25)))
    return out


def test_ladder_runs_equal():
    (ref, m_ref), (port, m_port) = _ladder_runs()
    _same_runs(ref, port, m_ref, m_port)
    kinds = {type(a).__name__ for a in ref.actions}
    assert "Spill" in kinds and m_ref["partial_merges"] >= 1, ref.actions
    assert m_ref["spill_pages"] > 0


def _prior(which, cfg):
    return (RC if which == "ref" else TC).CostModel(cfg)


def _fitted(which, cfg):
    kt, k = (RKT, RK) if which == "ref" else (TKT, TK)
    link = kt.LinkModel(bandwidth=1.7e11, segment_overhead=2.5e-6,
                        overlap_fraction=0.0)
    return k.CalibratedCostModel(cfg, link=link)


@pytest.mark.parametrize("attach", [_prior, _fitted],
                         ids=["prior", "calibrated"])
def test_ladder_runs_equal_with_cost_model(attach):
    (ref, m_ref), (port, m_port) = _ladder_runs(attach)
    _same_runs(ref, port, m_ref, m_port)
    assert ref.actions
    if attach is _fitted:
        # the sim fed its transform records into both models' EWMAs
        assert ref.scheduler.cost_model.measured._count == \
            port.scheduler.cost_model.measured._count
        assert ref.scheduler.cost_model.measured._ewma == \
            port.scheduler.cost_model.measured._ewma


def test_layout_runs_equal():
    out = []
    for pkg, pkg_s, cfg_of in ((RS, RSch, ref_config),
                               (TS, TSch, get_config)):
        sched = pkg_s.GygesScheduler(pkg_s.SchedulerConfig(
            long_threshold=2048, target_tp=4, partial_merge=True,
            layouts=True))
        reqs = pkg.hybrid_trace(duration=60.0, short_qpm=30.0,
                                long_qpm=1e-6, short_len=400, out_len=32,
                                seed=6)
        reqs += [pkg.Request(len(reqs), 5.0, 7000, 400),
                 pkg.Request(len(reqs) + 1, 30.0, 3000, 200)]
        c = pkg.Cluster(cfg_of("llama3-8b"), n_hosts=1, gpus_per_host=8,
                        widths=[4, 4], scheduler=sched, seq_quantum=2048,
                        max_batch=4, page_tokens=64)
        out.append((c, c.run(reqs, dt=0.25)))
    (ref, m_ref), (port, m_port) = out
    _same_runs(ref, port, m_ref, m_port)
    assert any(getattr(a, "layout", None) is not None
               and a.layout.sp > 1 for a in ref.actions), ref.actions
