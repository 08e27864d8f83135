"""The port's §5 scheduler (``repro_torch.core.scheduler``) against the
reference's, decision for decision.

Seeded random ``InstanceView`` stubs and request lengths go to both
packages' ``gyges``, ``rr`` and ``llf`` schedulers (the same stub
objects: the protocol is duck-typed), with the capacity-ladder rungs
(spill, partial merge) off and on, SP layouts off and on, with and
without an arrival-pressure estimator, with a stub cost model and with
both packages' real ``CostModel`` (the Table-1 prior, and a
``CalibratedCostModel`` over a fitted-looking link with a warm EWMA).
Every
decision (``pick``, ``decide_scale_up``, ``decide_seed_scale_up``,
``decide_merge``, ``decide_capacity``, ``decide_partial_merge``,
``decide_spill``, ``decide_layout``, ``schedule_parallelism``) must be
equal field by field.  Pure Python, no model.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from repro.core import events as RE
from repro.core import scheduler as RS
from repro_torch.core import events as TE
from repro_torch.core import scheduler as TS

N_TRIALS = 150


class Stub:
    """A random instance: width 1, 2 or 4, at TP1 or its full width."""

    def __init__(self, rng, iid):
        self.iid = iid
        self.width = int(rng.choice([1, 2, 4]))
        self.tp = int(rng.choice([1, self.width]))
        self.max_tp = self.width
        self.quantum = int(rng.choice([16, 32, 64]))
        self.reserved = bool(rng.random() < 0.3)
        self._used = float(rng.choice([0.0, 0.1, 0.3, 0.5, 0.9, 0.97]))
        self._queue = int(rng.integers(0, 3))
        self._long = bool(rng.random() < 0.2)

    def max_seq_at(self, tp):
        return self.quantum * tp

    def max_seq(self):
        return self.max_seq_at(self.tp)

    def kv_used_fraction(self):
        return self._used

    def kv_free_tokens(self):
        return int(4 * self.max_seq() * (1 - self._used))

    def load(self):
        return self._used + 0.05 * self._queue

    def has_long_request(self):
        return self._long


class StubCost:
    """Cost-model stand-in with the two methods the ladder prices by."""

    def spill_time(self, tokens, page_tokens=64):
        return 0.001 * -(-tokens // page_tokens)

    def transform_time(self, kind, tp_from=1, tp_to=2):
        return 0.02 * tp_to / tp_from

    def layout_tps(self, layout, long_context):
        return 100.0 * layout.tp + (60.0 * layout.sp if long_context
                                    else -layout.sp)


def _fields(x):
    """A comparable image of an action, an instance or a list of them."""
    if x is None:
        return None
    if isinstance(x, list):
        return [_fields(a) for a in x]
    if isinstance(x, Stub):
        return ("inst", x.iid)
    d = dataclasses.asdict(x)
    if d.get("layout") is not None:
        d["layout"] = (x.layout.sp, x.layout.tp)
    return (type(x).__name__, d)


def _pair(name, rng_cfg, pressure, costs):
    """The reference's and the port's scheduler; ``costs`` is None or
    the (reference, port) cost models to attach."""
    out = []
    for k, (S, E) in enumerate(((RS, RE), (TS, TE))):
        sched = S.SCHEDULERS[name](S.SchedulerConfig(**rng_cfg))
        if costs is not None:
            sched.attach_cost(costs[k])
        if pressure:
            est = E.ArrivalPressure(tau_s=5.0)
            for t, long_ in pressure:
                est.observe(t, long_)
            with warnings.catch_warnings():
                # a zero horizon is one of the cases compared
                warnings.simplefilter("ignore", RuntimeWarning)
                sched.attach_pressure(est)
        out.append(sched)
    return out


def _real_costs(kind):
    """Both packages' cost models for reduced llama3-8b: the Table-1
    prior, or a ``CalibratedCostModel`` over one fitted-looking link
    whose EWMA is warm for TP1 -> 2 and for spills."""
    from repro.configs import get_config as ref_config
    from repro.core import calibrate as RK
    from repro.core import costmodel as RC
    from repro.core import kv_transform as RKT
    from repro_torch.configs import get_config
    from repro_torch.core import calibrate as TK
    from repro_torch.core import costmodel as TC
    from repro_torch.core import kv_transform as TKT
    out = []
    for cfg, C, K, KT in ((ref_config, RC, RK, RKT),
                          (get_config, TC, TK, TKT)):
        cfg = cfg("llama3-8b").reduced()
        if kind == "prior":
            out.append(C.CostModel(cfg))
            continue
        cm = K.CalibratedCostModel(cfg, link=KT.LinkModel(
            bandwidth=1.7e11, segment_overhead=2.5e-6,
            overlap_fraction=0.0))
        for w in (0.8, 1.1, 0.9):
            cm.observe_transform({"kind": "transform", "tp_from": 1,
                                  "tp_to": 2, "wall_s": w, "bytes": 1e8})
            cm.observe_transform({"kind": "spill", "tp_from": 0,
                                  "tp_to": 0, "wall_s": w / 50,
                                  "bytes": 1e6})
        out.append(cm)
    return tuple(out)


def _trials(name, ladder, seed, costs=None):
    """N_TRIALS random clusters and requests through both schedulers;
    without ``costs`` half the ladder trials attach ``StubCost``."""
    rng = np.random.default_rng(seed)
    for trial in range(N_TRIALS):
        insts = [Stub(rng, i) for i in range(int(rng.integers(1, 6)))]
        cfg = dict(long_threshold=int(rng.choice([32, 64, 4096])),
                   target_tp=int(rng.choice([2, 4])),
                   spill=ladder, partial_merge=ladder,
                   layouts=ladder and bool(rng.random() < 0.5),
                   transform_cost_s=float(rng.choice([0.0, 1.0])),
                   page_tokens=16)
        pressure = ([(float(t), bool(rng.random() < 0.5))
                     for t in np.sort(rng.random(6) * 4)]
                    if rng.random() < 0.3 else None)
        stub = ladder and bool(rng.random() < 0.5)
        ref, port = _pair(name, cfg, pressure,
                          costs if costs is not None else
                          (StubCost(), StubCost()) if stub else None)
        for _ in range(3):
            inp = int(rng.integers(1, 300))
            out = int(rng.integers(1, 64))
            total = inp + out
            seed = insts[int(rng.integers(len(insts)))]
            for method, args in (
                    ("pick", (insts, inp, out)),
                    ("decide_scale_up", (insts, inp, out)),
                    ("decide_seed_scale_up", (insts, seed, total)),
                    ("decide_merge", (insts, total)),
                    ("decide_capacity", (insts, total)),
                    ("decide_partial_merge", (insts, total)),
                    ("decide_spill", (insts, total)),
                    ("decide_layout", (insts,)),
                    ("schedule_parallelism",
                     (insts, bool(rng.random() < 0.3)))):
                want = getattr(ref, method)(*args)
                got = getattr(port, method)(*args)
                assert _fields(got) == _fields(want), (trial, method)
            assert port.pressure_high() == ref.pressure_high()
            assert port.transform_horizon_s() == ref.transform_horizon_s()


@pytest.mark.parametrize("name", ["gyges", "rr", "llf"])
@pytest.mark.parametrize("ladder", [False, True])
def test_decisions_equal_reference(name, ladder):
    _trials(name, ladder, 7 if ladder else 3)


@pytest.mark.parametrize("kind", ["prior", "calibrated"])
@pytest.mark.parametrize("name", ["gyges", "rr", "llf"])
@pytest.mark.parametrize("ladder", [False, True])
def test_decisions_equal_reference_with_cost_model(name, ladder, kind):
    """Both packages' real cost models attached (one pair, every trial):
    the ladder is ordered by their costs, the layout rung scored by
    their hardware constants, the pressure horizon derived from them."""
    from repro_torch.core.scheduler import Layout
    costs = _real_costs(kind)
    assert costs[1].layout_tps(Layout(2, 2), True) == \
        costs[0].layout_tps(RS.Layout(2, 2), True)
    _trials(name, ladder, 11 if ladder else 5, costs=costs)


def test_min_tp_for_and_layout_model_equal_reference():
    rng = np.random.default_rng(0)
    for i in range(200):
        s = Stub(rng, i)
        total = int(rng.integers(1, 400))
        assert TS.min_tp_for(s, total) == RS.min_tp_for(s, total)
    from repro.core.costmodel import layout_decode_tps
    for sp in (1, 2):
        for tp in (1, 2, 4, 8):
            for long_ in (False, True):
                assert TS.layout_decode_tps(TS.Layout(sp, tp), long_) == \
                    layout_decode_tps(RS.Layout(sp, tp), long_)


def test_round_robin_state_advances_alike():
    rng = np.random.default_rng(1)
    insts = [Stub(rng, i) for i in range(4)]
    ref, port = RS.RoundRobinScheduler(), TS.RoundRobinScheduler()
    picks = [(_fields(ref.pick(insts, 8, 8)), _fields(port.pick(insts, 8, 8)))
             for _ in range(12)]
    assert all(a == b for a, b in picks) and ref._i == port._i
