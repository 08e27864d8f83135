"""Request objects shared by the live serving path and the simulator.

Two request shapes, one metrics contract:

* ``ServeRequest`` — a live token-level request (prompt ids, sampling
  params, generated ids) served by ``serving.engine.Engine`` /
  ``serving.cluster.ClusterEngine``;
* ``Request`` — a trace record (arrival time + input/output lengths)
  consumed by ``core.cluster_sim.Cluster`` and produced by the trace
  generators.

Both expose ``finished`` / ``ttft`` / ``tpot`` so that
``serving.metrics.summarize`` reports the *identical* schema for a
simulated cluster and a live one.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, List, Optional


class State(Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclass
class ServeRequest:
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0            # 0 = greedy
    eos_id: Optional[int] = None
    rid: int = field(default_factory=itertools.count().__next__)

    # lifecycle
    state: State = State.WAITING
    slot: int = -1
    generated: List[int] = field(default_factory=list)
    t_submit: float = field(default_factory=time.monotonic)
    t_prefill_start: Optional[float] = None   # first prefill chunk ran
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    #: latency deadlines (an object with ``met(request)``, as the
    #: reference's core.events.SLO, not ported yet) aggregated into
    #: goodput_slo; None = no deadline, excluded from goodput accounting
    slo: Optional[Any] = None

    @property
    def done(self) -> bool:
        return self.state == State.DONE

    @property
    def arrival_s(self) -> float:
        """Arrival timestamp on the serving clock (the event-driven
        replay contract; for a live request, submission time)."""
        return self.t_submit

    @property
    def finished(self) -> bool:
        return self.t_done is not None

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def total_tokens(self) -> int:
        """Final context footprint (admission-control unit): the prompt
        plus the full generation budget."""
        return len(self.prompt) + self.max_new_tokens

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first_token is None else (
            self.t_first_token - self.t_submit)

    @property
    def queue_delay(self) -> Optional[float]:
        """Submit -> first prefill work (the head-of-line wait chunked
        prefill exists to bound); TTFT = queue_delay + prefill time."""
        return None if self.t_prefill_start is None else (
            self.t_prefill_start - self.t_submit)

    @property
    def tpot(self) -> Optional[float]:
        if self.t_done is None or self.t_first_token is None \
                or len(self.generated) <= 1:
            return None
        return (self.t_done - self.t_first_token) / (len(self.generated) - 1)


@dataclass
class Request:
    """Trace record: a request as the simulator and the trace generators
    see it (lengths and arrival time, no token ids)."""
    rid: int
    arrive: float
    in_len: int
    out_len: int
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    tokens_done: float = 0.0
    prefilled: float = 0.0
    t_prefill_start: Optional[float] = None
    #: latency deadlines (an object with ``met(request)``, as the
    #: reference's core.events.SLO, not ported yet) aggregated into
    #: goodput_slo; None = no deadline, excluded from goodput accounting
    slo: Optional[Any] = None

    @property
    def finished(self) -> bool:
        return self.t_finish is not None

    @property
    def arrival_s(self) -> float:
        """Arrival timestamp on the serving clock (the event-driven
        replay contract)."""
        return self.arrive

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first_token is None else (
            self.t_first_token - self.arrive)

    @property
    def queue_delay(self) -> Optional[float]:
        """Arrival -> first prefill work (same contract as
        ``ServeRequest.queue_delay``, so both planes report it)."""
        return None if self.t_prefill_start is None else (
            self.t_prefill_start - self.arrive)

    @property
    def tpot(self) -> Optional[float]:
        if self.t_finish is None or self.t_first_token is None \
                or self.out_len <= 1:
            return None
        return (self.t_finish - self.t_first_token) / (self.out_len - 1)
