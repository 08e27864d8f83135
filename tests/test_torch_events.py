"""The port's event-driven serving clock (``repro_torch.core.events``)
against the reference's.

One seeded trace is replayed by both packages' ``replay`` over a stub
plane (each request needs as many advances as its output length; a
departure hook reports it done), in the event-driven mode with idle
jumps and settle steps, without jumps, and at a fixed horizon: the
event order, the virtual timestamps and the plane's own call log must
be equal.  ``SLO.met``, ``summarize``'s goodput, the ``EventQueue``
pop order and ``ArrivalPressure`` give equal numbers.  Finally the
port's ``LiveReplayPlane`` replays a short trace over a live CPU
cluster on a ``VirtualClock``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import events as RE
from repro.serving import metrics as RM
from repro.serving import request as RR
from repro_torch.core import events as TE
from repro_torch.serving import metrics as TM
from repro_torch.serving import request as TR


class StubPlane:
    """A request takes ``out_len`` advances once submitted; the plane
    logs every call it gets."""

    def __init__(self):
        self.active = {}
        self.done = []
        self.log = []

    def submit(self, req, now):
        self.log.append(("submit", req.rid, now))
        self.active[req.rid] = [req, req.out_len]

    def advance(self, now, dt):
        self.log.append(("advance", now, dt))
        for rid in sorted(self.active):
            self.active[rid][1] -= 1
            if self.active[rid][1] <= 0:
                self.done.append(self.active.pop(rid)[0])

    def poll_departures(self):
        out, self.done = self.done, []
        return out

    @property
    def idle(self):
        return not self.active


def _trace(module):
    rng = np.random.default_rng(4)
    t = np.cumsum(rng.exponential(3.0, size=24))
    t[5] = t[4]                                  # a same-time arrival
    return [module.Request(i, float(t[i]), int(rng.integers(4, 64)),
                           int(rng.integers(1, 9))) for i in range(24)]


MODES = {"event-driven": dict(settle_steps=3),
         "no-jump": dict(idle_jump=False),
         "horizon": dict(until=40.0)}


@pytest.mark.parametrize("mode", list(MODES))
def test_replay_equal_reference(mode):
    runs = []
    for E, R in ((RE, RR), (TE, TR)):
        plane = StubPlane()
        departs = []
        out = E.replay(plane, _trace(R), dt=0.5,
                       on_depart=lambda r, t: departs.append((r.rid, t)),
                       **MODES[mode])
        events = [(e.t, e.seq, e.kind, e.rid) for e in out["events"]]
        runs.append((out["t_end"], out["steps"], events, plane.log,
                     departs))
    assert runs[0] == runs[1]
    kinds = [e[2] for e in runs[1][2]]
    if mode == "horizon":
        assert 0 < kinds.count(TE.ARRIVE) < 24
    else:                          # every arrival served and departed
        assert kinds.count(TE.ARRIVE) == kinds.count(TE.DEPART) == 24


def test_event_queue_order_equal_reference():
    rng = np.random.default_rng(9)
    items = [(float(rng.integers(0, 20)), int(rng.integers(0, 99)))
             for _ in range(200)]
    pops = []
    for E in (RE, TE):
        q = E.EventQueue()
        for t, rid in items:
            q.push(t, E.ARRIVE, rid)
        pops.append([(e.t, e.seq, e.kind, e.rid)
                     for e in (q.pop() for _ in range(len(q)))])
    assert pops[0] == pops[1]


def _requests(module, rng):
    """Finished and unfinished live requests with stamps and SLOs."""
    E = RE if module is RR else TE
    reqs = []
    for i in range(30):
        r = module.ServeRequest(prompt=[1] * 8, max_new_tokens=6, rid=i,
                                slo=E.SLO(ttft_s=float(rng.choice([0.5, 2])),
                                          tpot_s=float(rng.choice([0.1, 1])))
                                if i % 4 else None)
        r.t_submit = float(i)
        if i % 7:
            r.t_first_token = r.t_submit + float(rng.random() * 3)
            r.generated = [0] * int(rng.integers(1, 7))
            if i % 5:
                r.state = module.State.DONE
                r.t_done = r.t_first_token + float(rng.random() * 2)
        reqs.append(r)
    return reqs


def test_slo_and_goodput_equal_reference():
    got = []
    for R, M in ((RR, RM), (TR, TM)):
        reqs = _requests(R, np.random.default_rng(2))
        met = [r.slo.met(r) if r.slo else None for r in reqs]
        m = M.summarize(reqs, 30.0, 120.0, 2)
        got.append((met, m))
    assert got[0][0] == got[1][0] and any(got[1][0])
    a, b = got[0][1], got[1][1]
    assert list(a) == list(b)
    for k in a:
        assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), k
    assert 0.0 < b["goodput_slo"] < 1.0


def test_clock_and_pressure_equal_reference():
    vals = []
    for E in (RE, TE):
        clock, est = E.VirtualClock(1.0), E.ArrivalPressure(tau_s=7.0)
        seq = []
        r = np.random.default_rng(5)
        for _ in range(50):
            clock.advance(float(r.random()))
            if r.random() < 0.6:
                est.observe(clock(), bool(r.random() < 0.3))
            else:
                est.advance_to(clock.now())
            seq.append((clock(), est.rate(), est.long_rate(),
                        est.long_fraction(), est.expected_longs(4.0)))
        clock.jump_to(clock() + 10)
        seq.append(clock.now())
        vals.append(seq)
    assert vals[0] == vals[1]


def test_live_replay_plane_serves_a_trace_on_virtual_time():
    from repro_torch.configs import get_config
    from repro_torch.serving.cluster import ClusterEngine, LiveReplayPlane

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    clock = TE.VirtualClock()
    cl = ClusterEngine(cfg, ["cpu"] * 2, n_instances=2, max_batch=2,
                       max_seq=64, page_tokens=16, clock=clock)
    plane = LiveReplayPlane(cl, seed=1)
    slo = TE.SLO(ttft_s=5.0, tpot_s=1.0)
    trace = [TR.Request(i, 2.0 * i, 6 + i, 3, slo=slo) for i in range(4)]
    out = TE.replay(plane, trace, dt=0.25, settle_steps=2, clock=clock)
    assert sorted(plane.served) == [0, 1, 2, 3]
    assert all(r.finished and len(r.generated) == 3
               for r in plane.served.values())
    assert [e.kind for e in out["events"]].count(TE.ARRIVE) == 4
    m = cl.metrics()
    assert m["finished"] == 4 and m["goodput_slo"] == 1.0
    # request times are on the virtual axis
    assert all(r.t_submit == 2.0 * r.rid for r in plane.served.values())
