"""Event-driven serving clock: the port's copy of ``repro.core.events``
(pure Python, kept whole so the port imports nothing of the JAX
package).  Everything here is the time layer:

* ``EventQueue`` — a heapq-driven arrival/departure queue (the
  Firmament ``ReplaySimulation`` shape: ``(t, seq, kind, payload)``
  entries, a monotone pop clock, FIFO tie-breaks via ``seq``);
* ``VirtualClock`` — the virtual now.  The live plane's engines stamp
  request timestamps through an injected clock callable, so a replay
  drives them in virtual time while data-plane measurements
  (``StepReport`` spans, ``transform_log.wall_s``) stay wall-clock;
* ``SLO`` — per-request TTFT/TPOT deadlines; ``met()`` is the goodput
  predicate both planes aggregate (``serving.metrics`` ``goodput_slo``);
* ``ArrivalPressure`` — the short-horizon arrival-rate × long-fraction
  EWMA the §5 scheduler weighs transformations against (see
  ``core.scheduler.BaseScheduler.observe_arrival``);
* ``replay()`` — THE serving loop, shared verbatim by both planes.  A
  plane is anything with ``submit(req, now)`` / ``advance(now, dt)`` /
  ``idle``: ``serving.cluster.LiveReplayPlane`` adapts a live
  ``ClusterEngine``, and ``core.cluster_sim.Cluster`` implements it.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Tuple

ARRIVE = "arrive"
DEPART = "depart"

__all__ = ["ARRIVE", "DEPART", "Event", "EventQueue", "VirtualClock",
           "SLO", "ArrivalPressure", "replay"]


@dataclass(frozen=True)
class Event:
    """One timed event.  Ordering is ``(t, seq)``: ``seq`` is the push
    order, so same-timestamp events pop FIFO and no comparison ever
    touches the payload (the Firmament counter trick)."""
    t: float
    seq: int
    kind: str
    rid: int
    payload: object = None

    def sort_key(self) -> Tuple[float, int]:
        return (self.t, self.seq)


class EventQueue:
    """heapq arrival/departure queue with a monotone pop clock.

    Invariants (property-tested in tests/test_events.py):

    * no event is lost or duplicated: every push is popped exactly once;
    * pop order is nondecreasing in time, FIFO within a timestamp;
    * the clock never runs backwards: pushing an event earlier than the
      last popped timestamp raises (the producer is trying to schedule
      work in the past).
    """

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0
        self._popped_t = -math.inf
        self.n_pushed = 0
        self.n_popped = 0

    def push(self, t: float, kind: str, rid: int,
             payload: object = None) -> Event:
        if not (t >= self._popped_t):    # NaN also rejected
            raise ValueError(
                f"event at t={t} is in the past (clock at "
                f"{self._popped_t})")
        ev = Event(float(t), self._seq, kind, rid, payload)
        heapq.heappush(self._heap, (ev.t, ev.seq, ev))
        self._seq += 1
        self.n_pushed += 1
        return ev

    def pop(self) -> Event:
        t, _, ev = heapq.heappop(self._heap)
        assert t >= self._popped_t, "heap violated time order"
        self._popped_t = t
        self.n_popped += 1
        return ev

    def peek_t(self) -> float:
        return self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class VirtualClock:
    """The replay's virtual now.  Callable so it can be handed directly
    to ``Engine``/``ClusterEngine`` as their timestamp source."""

    def __init__(self, t0: float = 0.0) -> None:
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    __call__ = now

    def advance(self, dt: float) -> float:
        assert dt >= 0.0, dt
        self._t += dt
        return self._t

    def jump_to(self, t: float) -> float:
        """Skip idle time forward (never backward) to ``t``."""
        assert t >= self._t, (t, self._t)
        self._t = float(t)
        return self._t


@dataclass(frozen=True)
class SLO:
    """Per-request latency deadlines (seconds).  A request is *good* iff
    it FINISHED and met both deadlines; a request still queued or
    in-flight at trace end is censored — counted as violating, never
    silently dropped (``serving.metrics.summarize`` aggregates this
    predicate into ``goodput_slo``)."""

    ttft_s: float = math.inf
    tpot_s: float = math.inf

    def met(self, req) -> bool:
        """Goodput predicate over anything exposing ``finished`` /
        ``ttft`` / ``tpot`` (both request shapes do)."""
        if not req.finished:
            return False                 # censored: violating by decree
        ttft = req.ttft
        if ttft is None or ttft > self.ttft_s:
            return False
        tpot = req.tpot
        # single-token outputs have no TPOT; trivially within deadline
        return tpot is None or tpot <= self.tpot_s


class ArrivalPressure:
    """Exponentially-decayed arrival-pressure estimate.

    On each arrival the estimator accumulates ``exp(-(now-t_i)/tau)``
    weights; at a constant rate λ the decayed count converges to λ·τ,
    so ``rate() = count / tau`` is a short-horizon arrivals-per-second
    estimate and ``long_rate()`` the same restricted to LONG requests.
    ``expected_longs(h)`` — predicted long arrivals over the next ``h``
    seconds — is the number the scheduler weighs a transformation's
    modeled wall time against (``core.scheduler``).

    Event-driven and deterministic: time only enters through
    ``observe``/``advance_to`` timestamps, never a wall clock.
    """

    def __init__(self, tau_s: float = 30.0) -> None:
        assert tau_s > 0.0
        self.tau_s = tau_s
        self._t: Optional[float] = None
        self._count = 0.0
        self._long = 0.0

    def _decay_to(self, now: float) -> None:
        if self._t is None:
            self._t = now
            return
        if now > self._t:
            w = math.exp(-(now - self._t) / self.tau_s)
            self._count *= w
            self._long *= w
            self._t = now

    def observe(self, now: float, is_long: bool) -> None:
        self._decay_to(now)
        self._count += 1.0
        if is_long:
            self._long += 1.0

    def advance_to(self, now: float) -> None:
        """Decay the estimate to ``now`` with no arrival — called by the
        serving loops so pressure releases during quiet periods."""
        self._decay_to(now)

    def rate(self) -> float:
        return self._count / self.tau_s

    def long_rate(self) -> float:
        return self._long / self.tau_s

    def long_fraction(self) -> float:
        return self._long / self._count if self._count > 0 else 0.0

    def expected_longs(self, horizon_s: float) -> float:
        return self.long_rate() * max(horizon_s, 0.0)


def replay(plane, trace: Iterable, dt: float = 0.25,
           until: Optional[float] = None, idle_jump: bool = True,
           settle_steps: int = 0, max_steps: int = 2_000_000,
           clock: Optional[VirtualClock] = None,
           on_depart: Optional[Callable] = None) -> dict:
    """THE event-driven serving loop, shared verbatim by both planes.

    ``plane`` is anything implementing the replay-plane protocol:

    * ``submit(req, now)`` — admit one trace request at its arrival;
    * ``advance(now, dt)`` — one serving step covering ``dt`` virtual
      seconds (the sim ticks its cost model; the live plane runs one
      ``ClusterEngine.step`` while its injected clock reads ``now``);
    * ``idle`` — nothing queued, in flight, or mid-transformation.

    Arrivals are heap-ordered events (``Request.arrival_s``); a DEPART
    event is recorded for every request observed finishing (via the
    optional ``plane.poll_departures()`` hook), so the returned event
    log is the full arrival/departure history.

    Two modes:

    * ``until`` set — fixed-horizon lockstep: advance every ``dt`` until
      the horizon, idle or not.  ``Cluster.run`` uses this to reproduce
      its legacy fixed-window semantics exactly.
    * ``until=None`` — event-driven: while idle, the clock JUMPS to the
      next arrival instead of burning ticks; ``settle_steps`` extra
      advances run at each idle boundary first (and once more at trace
      end) so dwell-gated scale-downs (Alg 2) execute before the jump
      in BOTH planes.

    Returns ``{"t_end", "steps", "events"}``.  The same ``clock``
    object the caller injected into the live plane must be passed here,
    so request timestamps and the loop share one virtual time axis.
    """
    clock = clock or VirtualClock()
    evq = EventQueue()
    for r in sorted(trace, key=lambda r: (r.arrival_s, r.rid)):
        evq.push(r.arrival_s, ARRIVE, r.rid, r)
    events: List[Event] = []
    poll = getattr(plane, "poll_departures", None)
    steps = 0
    settled = 0

    def _advance() -> None:
        nonlocal steps
        now = clock.now()
        plane.advance(now, dt)
        clock.advance(dt)
        if poll is not None:
            for req in poll():
                events.append(Event(clock.now(), len(events), DEPART,
                                    req.rid, req))
                if on_depart is not None:
                    on_depart(req, clock.now())
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"replay exceeded max_steps={max_steps} at virtual "
                f"t={clock.now():.2f} ({len(evq)} events pending)")

    while True:
        now = clock.now()
        while evq and evq.peek_t() <= now + 1e-12:
            ev = evq.pop()
            events.append(ev)
            plane.submit(ev.payload, ev.t)
        if until is not None:
            if now >= until - 1e-12:
                break
            _advance()
            continue
        if not plane.idle:
            settled = 0
            _advance()
            continue
        # idle: settle (give Alg 2 its dwell window), then jump or stop
        if settle_steps and settled < settle_steps:
            settled += 1
            _advance()
            continue
        if evq:
            if idle_jump:
                clock.jump_to(evq.peek_t())
            else:
                _advance()
            continue
        break
    return {"t_end": clock.now(), "steps": steps, "events": events}
