"""Transformation-aware scheduler (paper §5, Algorithms 1 and 2) plus
the RR / LLF baselines, and the chunked-prefill policy: the port's copy
of ``repro.core.scheduler``, kept whole (pure Python) so the port
imports nothing of the JAX package and its decisions can be held
against the reference's field by field.

The scheduler sees a narrow ``InstanceView`` protocol (load, tp,
max_seq, has_long_request, reserved, width), which the port's live
``serving.engine.Engine`` implements; ``serving.cluster.ClusterEngine``
is the control plane that executes its declarative ``ScaleUp`` /
``ScaleDown`` actions.  A ``ScaleUp`` with ``donor_iids`` is a
cross-instance merge (paper Fig. 3).  The opt-in rungs (``Spill``,
partial merges, SP layouts) are decided here as in the reference; their
data plane is not ported, and the port's ``ClusterEngine`` refuses a
``SchedulerConfig`` that enables them.

``layout_decode_tps`` is the reference's Table-1 throughput model
(``repro.core.costmodel``, H20 constants from the paper), copied for
the layout rung's scoring; the rest of the cost model is not ported."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence, Tuple, Union

from repro_torch.launch.mesh import Layout

MAX = float("inf")

# the paper's Table-1 fit (4x H20, Qwen2.5-32B): single-GPU decode tps,
# the TP all-reduce penalty 1/(1 + a(tp-1) + b(tp-1)^2) and the SP
# combine penalty 1/(1 + g(sp-1)) (``repro.core.costmodel.H20``)
BASE_TPS, ALPHA, BETA, SP_GAMMA = 448.0, 0.283, 0.054, 0.06


def layout_decode_tps(layout, long_context: bool = False) -> float:
    """Modeled decode tokens/s of one instance at ``layout`` (the
    reference's ``costmodel.layout_decode_tps`` at its H20 default)."""
    lay = Layout.of(layout)
    eff = 1.0 / (1.0 + ALPHA * (lay.tp - 1) + BETA * (lay.tp - 1) ** 2)
    tps = BASE_TPS * lay.tp * eff
    if lay.sp > 1 and long_context:
        tps *= lay.sp / (1.0 + SP_GAMMA * (lay.sp - 1))
    return tps


# --------------------------------------------------------------------------
# Chunked-prefill policy (shared verbatim by the live engine and the sim)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PrefillPolicy:
    """Token-budgeted chunked prefill with an explicit prefill/decode
    priority (the LoongServe / Sarathi-style scheduling layer under the
    §5 scheduler).

    ONE policy object drives both planes: ``serving.engine.Engine``
    consumes ``chunk_sizes`` + ``step_quota`` per engine step, and
    ``cluster_sim.SimInstance`` consumes the same methods (aggregated
    over the engine steps a tick models via ``tokens_over_steps``), so
    simulated TTFT/queue-delay behavior is policy-identical to live.

    * ``token_budget`` — prefill tokens an engine step may process
      (``None`` = unbounded: classic whole-prompt prefill);
    * ``mode`` — who wins when prefill work and active decodes compete:

        - ``"prefill"``: prefill first; decodes effectively wait behind
          prompt processing (vLLM's legacy prefill-prioritized step);
        - ``"decode"``:  active decodes run every step; prefill is
          deferred while any request is decoding, but never more than
          ``max_defer_steps`` consecutive steps (bounded starvation);
        - ``"mixed"``:   every step carries up to ``token_budget``
          prefill tokens alongside the decodes (Sarathi-style
          chunked-prefill piggybacking);

    * ``long_threshold`` — chunking is MANDATORY above this many prompt
      tokens even when ``token_budget`` is None: one monolithic prefill
      of a paper-Fig.-2 long prompt is exactly the head-of-line stall
      this policy exists to remove;
    * ``order`` — which partially-prefilled request gets budget first:
      ``"fcfs"`` (arrival order) or ``"sjf"`` (fewest remaining prompt
      tokens first — short prompts slip between a long prompt's chunks,
      which is what fixes burst TTFT p99).

    Chunk boundaries are PAGE boundaries (``chunk_sizes``): a partially
    prefilled slot is always a whole number of full pages plus at most
    one trailing partial page written by the final chunk, so
    ``copy_page_slices`` migration and transform sessions remain valid
    mid-prefill.
    """

    token_budget: Optional[int] = None
    mode: str = "prefill"            # "prefill" | "decode" | "mixed"
    long_threshold: int = 4096
    max_defer_steps: int = 4
    order: str = "fcfs"              # "fcfs" | "sjf"

    def effective_chunk(self, page_tokens: int) -> Optional[int]:
        """Largest chunk this policy emits (page-aligned ``token_budget``
        rounded down, never below one page), or None when unbudgeted
        (the ``long_threshold`` mandate still applies)."""
        if self.token_budget is None:
            return None
        return max(page_tokens,
                   self.token_budget - self.token_budget % page_tokens)

    def chunk_sizes(self, prompt_len: int, page_tokens: int) -> List[int]:
        """Partition ``prompt_len`` into prefill chunks.

        Invariants (property-tested in tests/test_scheduler.py):
        the chunks sum to ``prompt_len`` exactly; every chunk except the
        last is a whole number of pages; no chunk exceeds
        ``effective_chunk`` (when budgeted) nor the page-aligned
        ``long_threshold`` (when the prompt is long)."""
        assert prompt_len >= 0 and page_tokens >= 1
        if prompt_len == 0:
            return []
        limit = self.effective_chunk(page_tokens)
        if prompt_len > self.long_threshold:
            # chunking mandatory for long prompts, budget or not
            mandatory = max(page_tokens, self.long_threshold
                            - self.long_threshold % page_tokens)
            limit = mandatory if limit is None else min(limit, mandatory)
        if limit is None or prompt_len <= limit:
            return [prompt_len]
        n_full, rem = divmod(prompt_len, limit)
        return [limit] * n_full + ([rem] if rem else [])

    def step_quota(self, decoding: int, deferred_steps: int) -> float:
        """Prefill tokens permitted THIS engine step, given ``decoding``
        active decode requests and ``deferred_steps`` consecutive steps
        prefill work has already been deferred.  ``inf`` = unbounded."""
        budget = MAX if self.token_budget is None else self.token_budget
        if self.mode == "decode" and decoding > 0 \
                and deferred_steps < self.max_defer_steps:
            return 0.0
        return float(budget)

    def tokens_over_steps(self, decoding: int, steps: int,
                          deferred: int = 0) -> Tuple[float, int]:
        """Prefill tokens ``steps`` consecutive engine steps admit — the
        sim's per-tick aggregate of ``step_quota`` (literally the same
        decision function live engines run, summed).

        ``deferred`` is the caller's carried consecutive-deferral count
        and the updated count is returned alongside the total: the
        bounded-starvation guarantee of decode-priority spans tick
        boundaries only if the caller persists it (a tick that models
        fewer than ``max_defer_steps`` steps would otherwise defer
        forever)."""
        total = 0.0
        for _ in range(max(steps, 0)):
            q = self.step_quota(decoding, deferred)
            if q <= 0:
                deferred += 1
            else:
                deferred = 0
                total += q
        return total, deferred

    def decode_share(self, prefill_fraction: float) -> float:
        """Fraction of an instance's decode rate that survives while a
        ``prefill_fraction`` of its compute is prefilling — the sim's
        head-of-line model.  Prefill-priority stalls decodes behind the
        prompt (the classic whole-prompt pathology); decode-priority
        protects them fully; mixed splits the difference."""
        f = min(max(prefill_fraction, 0.0), 1.0)
        if self.mode == "prefill":
            return 1.0 - f
        if self.mode == "mixed":
            return 1.0 - 0.5 * f
        return 1.0

    def service_order(self, items: List, remaining_of) -> List:
        """Order partially-prefilled requests for budget service:
        ``remaining_of(item)`` -> outstanding prompt tokens."""
        if self.order == "sjf":
            return sorted(items, key=remaining_of)
        return list(items)

    def chunkable(self, prompt_len: int, page_tokens: int = 1) -> bool:
        """True iff this policy splits ``prompt_len`` into more than one
        chunk — the mid-transform-session admission predicate BOTH
        planes apply (``Engine._admittable_now`` and the simulator's
        tick): a whole-prompt prefill cannot interleave with schedule
        steps, so single-chunk prompts wait for the session to drain."""
        return len(self.chunk_sizes(prompt_len, page_tokens)) > 1


class InstanceView(Protocol):
    """The narrow protocol the scheduler sees (units in comments).

    Both ``cluster_sim.SimInstance`` and the live ``serving.Engine``
    implement it, so one policy object drives both planes.
    """

    iid: int                         # stable instance id
    tp: int                          # current tensor-parallel degree
    reserved: bool                   # earmarked as a merge member
                                     # (Alg 2 line 9 update_reserve)
    max_tp: int                      # largest IN-PLACE TP degree (== tp
                                     # if the instance only grows by
                                     # merging, e.g. SimInstance)
    width: int                       # devices the instance spans; what a
                                     # merge donor contributes

    def load(self) -> float: ...                 # unitless pressure score
    def kv_used_fraction(self) -> float: ...     # [0, 1]
    def max_seq(self) -> int: ...                # tokens, policy ceiling
    def max_seq_at(self, tp: int) -> int: ...    # tokens at degree tp;
                                                 # tp may exceed max_tp
                                                 # (merge prospecting)
    def kv_free_tokens(self) -> int: ...         # tokens
    def has_long_request(self) -> bool: ...


# --------------------------------------------------------------------------
# Declarative parallelism actions (executed by the owning control plane)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ScaleUp:
    """Grow instance ``iid`` to TP degree ``tp_to`` (Alg 1 lines 14-16,
    execute_scale_up).

    Two execution forms, distinguished by ``donor_iids``:

    * empty (default): an IN-PLACE re-factorization of the instance's
      own devices (``tp_to <= max_tp``);
    * non-empty: a CROSS-INSTANCE MERGE (paper Fig. 3) — the owning
      control plane drains and parks each donor, hands its devices to
      instance ``iid``, migrates the donors' live KV into the target's
      pool, and transforms the target to ``tp_to`` across the widened
      device set.  Invariant: target and donors are all at TP1 and
      ``tp_to`` equals the combined device width.

    ``donor_devices`` refines a merge into a PARTIAL one (LoongServe's
    elastic move): entry k is how many devices donor k loans.  Empty
    means every donor loans its whole width (the classic park).  When a
    donor loans fewer devices than it spans, the control plane shrinks
    it in place (``Engine.transform(devices=)``) and it KEEPS SERVING on
    its retained devices — no park, no drain.

    ``layout`` names the FULL target parallelism factorization (a
    ``launch.mesh.Layout`` with ``degree == tp_to``); None means pure
    TP.  A ``ScaleUp`` with ``tp_to == inst.tp`` and a different
    ``layout`` is a same-degree LAYOUT CHANGE (``decide_layout`` — e.g.
    TP4 -> SP2xTP2 for long-context decode), executed live via
    ``Engine.transform(tp_to, layout=...)``.
    """
    iid: int
    tp_to: int
    reason: str = ""
    donor_iids: Tuple[int, ...] = ()
    donor_devices: Tuple[int, ...] = ()
    layout: Optional[Layout] = None


@dataclass(frozen=True)
class ScaleDown:
    """Shrink instance ``iid`` to TP degree ``tp_to`` (Alg 2 line 7).

    On a previously merged instance the control plane also releases the
    borrowed devices back to the pool and revives the parked donors —
    the declarative action itself stays width-agnostic."""
    iid: int
    tp_to: int = 1
    reason: str = ""


@dataclass(frozen=True)
class Spill:
    """Serve a pool-ceiling-busting request on instance ``iid`` by
    spilling its overflow KV pages (``tokens`` beyond the guest's
    ceiling) into instance ``host_iid``'s pool — the Infinite-LLM /
    DistAttention move: no transformation at all, decode attention
    gathers across the distributed pool.  Rung 1 of the capacity
    ladder (spill < partial merge < full merge)."""
    iid: int
    host_iid: int
    tokens: int
    reason: str = ""


Action = Union[ScaleUp, ScaleDown, Spill]


def min_tp_for(inst: InstanceView, total_tokens: int) -> int:
    """Smallest TP degree (doubling from the current one, capped at
    ``max_tp``) whose admission ceiling fits ``total_tokens``."""
    hi = getattr(inst, "max_tp", inst.tp)
    tp = max(inst.tp, 1)
    while tp < hi and inst.max_seq_at(tp) < total_tokens:
        tp *= 2
    return min(tp, hi)


@dataclass
class SchedulerConfig:
    long_threshold: int = 4096       # router-side long-request classifier
                                     # (§5.1): inputs above this are long
    scale_down_load: float = 0.35    # Alg 2 THRESHOLD
    reserve_fraction: float = 0.10   # capacity reserved on candidate
                                     # scale-up groups (check_reserve)
    target_tp: int = 4
    # -- arrival-pressure weighting (only active when an estimator is
    #    attached via BaseScheduler.attach_pressure) ------------------
    transform_cost_s: float = 0.0    # wall time of one merge / split;
                                     # sets the prediction horizon.  0.0
                                     # means DERIVE it from the attached
                                     # cost model (transform_horizon_s)
                                     # — pressure with neither attached
                                     # warns: the horizon would be zero
                                     # and holds silently never fire
    page_tokens: int = 64            # the owning plane's pool page
                                     # geometry (tokens per KV page);
                                     # both control planes overwrite it
                                     # at construction so spill rung
                                     # costs count REAL overflow pages
    pressure_hold: float = 0.5       # hold a scale-down (and widen
                                     # merges) when the expected LONG
                                     # arrivals within 2x the transform
                                     # cost reach this many requests
    # -- capacity ladder (both rungs strictly OPT-IN, like pressure:
    #    defaults preserve every pre-existing trace byte-for-byte) ------
    spill: bool = False              # rung 1: overflow KV pages spill to
                                     # a neighbor's pool (no transform)
    partial_merge: bool = False      # rung 2: donors loan a FRACTION of
                                     # their devices and keep serving
    spill_slack: float = 1.0         # max overflow a spill may carry, as
                                     # a fraction of the guest's ceiling
                                     # (beyond that a merge is cheaper)
    # -- elastic sequence parallelism (OPT-IN like the ladder rungs:
    #    default preserves every pre-existing trace byte-for-byte) ------
    layouts: bool = False            # let decide_layout re-factorize a
                                     # wide instance between pure TP and
                                     # SPxTP by workload mix (long-
                                     # context decode -> SP shards win)
    max_sp: int = 2                  # deepest sp factor proposed: sp
                                     # shards replicate weights, so deep
                                     # sp is weight-memory-bound — one
                                     # sequence split keeps the memory
                                     # model honest


class BaseScheduler:
    """Routing + parallelism policy skeleton.

    Subclasses override ``pick`` (Alg 1 routing).  The resource-manager
    half — ``want_scale_down`` / ``schedule_parallelism`` (Alg 2) and
    ``decide_scale_up`` / ``decide_merge`` (Alg 1 lines 14-16) — lives
    here so every scheduler, transformation-aware or not, manages
    instance parallelism the same way; what differs across schedulers is
    how often their routing *forces* an avoidable transformation
    (Fig. 13).  All token quantities are final context footprints
    (prompt + full generation budget), the admission-control unit."""

    name = "base"

    def __init__(self, cfg: Optional[SchedulerConfig] = None):
        self.cfg = cfg or SchedulerConfig()
        #: optional core.events.ArrivalPressure; when attached, the
        #: scheduler becomes transformation-aware IN TIME: a modeled
        #: transform cost (cfg.transform_cost_s) is weighed against the
        #: predicted long-request pressure, not just the current queue
        self.pressure = None
        #: optional core.costmodel.CostModel; when attached, the
        #: capacity ladder (spill < partial merge < full merge) is
        #: ordered by the Table-1 model instead of rung index
        self.cost_model = None

    def attach_cost(self, cost_model) -> None:
        """Attach a ``core.costmodel.CostModel`` so ``decide_capacity``
        compares rungs by modeled wall time (spill transfer vs partial
        vs full transform), not just by the natural rung order."""
        self.cost_model = cost_model

    # --- arrival-pressure plumbing (no-ops without an estimator) ---------
    def attach_pressure(self, estimator) -> None:
        """Attach a ``core.events.ArrivalPressure`` estimator; both
        control planes then feed it via ``observe_arrival`` (submit
        path) and ``observe_time`` (serving loop).

        Warns when the prediction horizon would be ZERO — i.e.
        ``cfg.transform_cost_s`` was left at its 0.0 default and no
        cost model is attached to derive it from — because then
        ``pressure_high`` can never hold a scale-down and the estimator
        silently does nothing (the pre-calibration footgun)."""
        self.pressure = estimator
        if estimator is not None and self.transform_horizon_s() <= 0.0:
            import warnings
            warnings.warn(
                "ArrivalPressure attached with a zero transform-cost "
                "horizon: set SchedulerConfig.transform_cost_s or "
                "attach_cost() a CostModel so the horizon can be "
                "derived — otherwise pressure never holds a scale-down",
                RuntimeWarning, stacklevel=2)

    def observe_arrival(self, now: float, total_tokens: int) -> None:
        """Serving-clock arrival hook, called by BOTH control planes on
        every submit (sim ``Cluster.submit``, live
        ``ClusterEngine.submit``) with the same classification the
        router uses."""
        if self.pressure is not None:
            self.pressure.observe(now, self.is_long(total_tokens))

    def observe_time(self, now: float) -> None:
        """Serving-clock tick hook: decays the pressure estimate during
        quiet periods so holds release when a burst passes."""
        if self.pressure is not None:
            self.pressure.advance_to(now)

    def transform_horizon_s(self) -> float:
        """The transform-cost horizon the arrival-pressure signal is
        weighed over: ``cfg.transform_cost_s`` when the caller set it,
        else DERIVED from the attached cost model as the cost of one
        TP1 -> target_tp transformation (which, for a
        ``CalibratedCostModel``, is the measured EWMA estimate once
        warm — the horizon tracks the clock it schedules against).
        0.0 with neither attached (``attach_pressure`` warns)."""
        if self.cfg.transform_cost_s > 0.0:
            return self.cfg.transform_cost_s
        if self.cost_model is not None:
            return self.cost_model.transform_time(
                "gyges", tp_from=1, tp_to=max(self.cfg.target_tp, 2))
        return 0.0

    def pressure_high(self) -> bool:
        """Predicted long-arrival pressure over the transformation
        horizon.  The horizon is 2x the transform wall time
        (``transform_horizon_s`` — configured, modeled, or measured) —
        a scale-down now that must be undone costs one split PLUS one
        merge before the predicted long can be served — and the
        threshold is ``cfg.pressure_hold`` expected long arrivals.
        Always False without an estimator (every pre-existing caller)."""
        if self.pressure is None:
            return False
        horizon = 2.0 * self.transform_horizon_s()
        return self.pressure.expected_longs(horizon) \
            >= self.cfg.pressure_hold

    def is_long(self, total_len: int,
                inst: Optional[InstanceView] = None) -> bool:
        """Router-side long-request classifier (paper §5.1): a request is
        long if its context footprint exceeds ``cfg.long_threshold``, or
        — when judged against a concrete instance — that instance's
        current admission ceiling."""
        if total_len > self.cfg.long_threshold:
            return True
        return inst is not None and total_len > inst.max_seq()

    # hooks implemented by subclasses -------------------------------------
    def pick(self, instances: Sequence[InstanceView], input_len: int,
             output_len_hint: int) -> Optional[InstanceView]:
        raise NotImplementedError

    def want_scale_down(self, inst: InstanceView,
                        any_long_waiting: bool) -> bool:
        """Alg 2 applies to every scheduler (it is the instance-side
        resource manager, not the router): scale down at low load when no
        long request is in service.  What differs across schedulers is how
        often their *routing* forces a new scale-up right after."""
        if inst.tp > 1 and not inst.has_long_request() \
                and not any_long_waiting:
            if inst.kv_used_fraction() < self.cfg.scale_down_load:
                # transformation-aware in time: keep the wide instance
                # when the arrival estimate predicts longs within the
                # split+re-merge horizon (paying the transform twice
                # costs more than briefly idling the extra devices)
                return not self.pressure_high()
        return False

    # declarative decisions ------------------------------------------------
    def schedule_parallelism(self, instances: Sequence[InstanceView],
                             any_long_waiting: bool) -> List[Action]:
        """Alg 2 as declarative actions.  ``instances`` is the caller's
        dwell-gated candidate set; every instance passing the scale-down
        predicate yields a ``ScaleDown`` the control plane executes."""
        return [ScaleDown(iid=i.iid, tp_to=1,
                          reason="low load, no long requests")
                for i in instances
                if i.tp > 1 and self.want_scale_down(i, any_long_waiting)]

    # --- elastic sequence parallelism (layout rungs) ---------------------

    def _layout_tps(self, layout: Layout, long_context: bool) -> float:
        """Modeled decode tokens/s of one instance at ``layout``; the
        attached cost model's hardware constants when present, the
        Table-1 defaults otherwise."""
        if self.cost_model is not None:
            return self.cost_model.layout_tps(layout, long_context)
        return layout_decode_tps(layout, long_context)

    def best_layout(self, degree: int, long_context: bool) -> Layout:
        """The throughput-winning ``(sp, tp)`` factorization of
        ``degree`` devices for the given workload mix.  Candidates are
        every divisor split with ``sp <= cfg.max_sp``; ties break
        toward pure TP (smaller sp) so the legacy layout is the
        deterministic default."""
        cands = [Layout(sp, degree // sp)
                 for sp in range(1, min(self.cfg.max_sp, degree) + 1)
                 if degree % sp == 0]
        return max(cands,
                   key=lambda l: (self._layout_tps(l, long_context),
                                  -l.sp))

    def decide_layout(self, instances: Sequence[InstanceView]
                      ) -> List[ScaleUp]:
        """Per-instance layout scan (opt-in via ``cfg.layouts``): for
        every wide instance, pick the ``best_layout`` of its CURRENT
        degree for its CURRENT workload mix (long-context work in
        service -> SP shards split the context and win; shorts only ->
        pure TP wins) and emit a same-degree ``ScaleUp`` carrying the
        target ``layout`` when it differs from the instance's.  Both
        control planes run this scan decision-for-decision — the
        simulator charges the modeled re-partition duration, the live
        plane opens a §4.3 layer-coherent session."""
        if not self.cfg.layouts:
            return []
        acts: List[ScaleUp] = []
        for inst in instances:
            d = inst.tp
            if d < 2 or getattr(inst, "reserved", False):
                continue
            cur = Layout.of(getattr(inst, "par_layout", None) or d)
            long_ctx = inst.has_long_request()
            best = self.best_layout(d, long_ctx)
            if best != cur:
                acts.append(ScaleUp(
                    iid=inst.iid, tp_to=d, layout=best,
                    reason=(f"layout {cur} -> {best} "
                            f"({'long' if long_ctx else 'short'}-context "
                            "mix)")))
        return acts

    def decide_scale_up(self, instances: Sequence[InstanceView],
                        input_len: int, output_len_hint: int
                        ) -> Optional[ScaleUp]:
        """Alg 1 lines 14-16: when routing found no valid instance for a
        LONG request (``input_len + output_len_hint`` tokens), return the
        cheapest ``ScaleUp`` that creates the capacity.

        Preference order: (1) IN-PLACE — the least-loaded instance whose
        own devices can reach the needed ceiling, at the smallest TP
        degree that fits (``min_tp_for``); (2) CROSS-INSTANCE MERGE
        (``decide_merge``) when no instance can grow enough alone.  Short
        requests never trigger a transformation — they wait for capacity
        (returns None)."""
        total = input_len + output_len_hint
        if not instances:
            return None
        if not self.is_long(total) \
                and any(total <= i.max_seq() for i in instances):
            return None
        best = None
        for inst in instances:
            hi = getattr(inst, "max_tp", inst.tp)
            if hi <= inst.tp or inst.max_seq_at(hi) < total:
                continue
            tp_to = min_tp_for(inst, total)
            key = (inst.load(), tp_to)
            if best is None or key < best[0]:
                best = (key, ScaleUp(iid=inst.iid, tp_to=tp_to,
                                     reason=f"long request ({total} tok)"))
        if best:
            return best[1]
        return self.decide_capacity(instances, total)

    def decide_seed_scale_up(self, instances: Sequence[InstanceView],
                             seed: InstanceView, total_tokens: int
                             ) -> Optional[ScaleUp]:
        """The Fig. 13 pathology as ONE shared policy: a
        transformation-unaware router picked ``seed`` but it cannot
        admit ``total_tokens``, so capacity must grow AROUND the pick —
        in place when the seed's own devices reach the needed ceiling,
        else as a merge that must include the seed as a member.  Both
        the simulator (``Cluster.execute_scale_up(seed=...)``) and the
        live plane (``ClusterEngine._place``) execute exactly this
        decision, which is what makes their RR/LLF action sequences
        comparable in the differential parity harness."""
        hi = getattr(seed, "max_tp", seed.tp)
        if hi > seed.tp and seed.max_seq_at(hi) >= total_tokens:
            return ScaleUp(iid=seed.iid,
                           tp_to=min_tp_for(seed, total_tokens),
                           reason="unaware routing")
        return self.decide_merge(instances, total_tokens, require=seed)

    def decide_merge(self, instances: Sequence[InstanceView],
                     total_tokens: int, min_width: Optional[int] = None,
                     require: Optional[InstanceView] = None
                     ) -> Optional[ScaleUp]:
        """Compose a cross-instance merge (paper Fig. 3): pick TP1
        instances, idlest first, until their combined device width both
        reaches ``min_width`` (default ``cfg.target_tp``) and yields an
        admission ceiling that fits ``total_tokens``.

        The busiest chosen member becomes the merge TARGET (it keeps its
        state in place — fewest live-KV exports); the rest are DONORS the
        control plane parks.  Donor choice is the one policy shared by
        the simulator (``Cluster.execute_scale_up``) and the live plane
        (``ClusterEngine``), so sim and live merge identically.

        Only widths that DIVIDE the pool width (the summed width of
        ``instances``) are proposed: padding plans are built for the
        full pool, so exactly its divisors keep weight shards aligned —
        a width-6 merge on an 8-wide pool is not executable and the
        loop keeps accumulating instead.  Returns None when fewer than
        two TP1 instances exist or even merging every one cannot reach
        the needed ceiling.

        ``require`` forces one TP1 instance into the member set (the
        seed of an unaware routing pick — ``decide_seed_scale_up``)."""
        min_w = self.cfg.target_tp if min_width is None else min_width
        if self.pressure is not None and not self.pressure_high():
            # low predicted pressure: build the NARROWEST adequate
            # merge (cheapest transformation, fewest parked donors);
            # the accumulation loop still widens until the ceiling
            # fits, so capacity is never compromised
            min_w = 2
        pool = sum(getattr(i, "width", i.tp) for i in instances)
        members: List[InstanceView] = []
        width = 0
        if require is not None:
            if require.tp != 1:
                return None
            members.append(require)
            width = getattr(require, "width", require.tp)
        for inst in sorted((i for i in instances
                            if i.tp == 1 and i is not require),
                           key=lambda i: i.kv_used_fraction()):
            members.append(inst)
            width += getattr(inst, "width", inst.tp)
            if (len(members) >= 2 and width >= min_w
                    and pool % width == 0
                    and members[0].max_seq_at(width) >= total_tokens):
                target = max(members, key=lambda i: i.kv_used_fraction())
                donors = tuple(i.iid for i in members if i is not target)
                return ScaleUp(
                    iid=target.iid, tp_to=width, donor_iids=donors,
                    reason=f"merge x{len(members)} ({total_tokens} tok)")
        return None

    # --- capacity ladder: spill < partial merge < full merge -------------

    def donor_loanable(self, inst: InstanceView) -> int:
        """Devices ``inst`` can loan to a partial merge while CONTINUING
        TO SERVE on the remainder — the relaxed merge-admissibility
        predicate (the old rule hard-required TP1 whole-engine donors).
        An instance must retain enough width that its live KV still fits
        the shrunken pool, and an instance holding a long request cannot
        shrink at all (its context already needs its full ceiling)."""
        w = getattr(inst, "width", inst.tp)
        if w <= 1 or inst.has_long_request():
            return 0
        used = min(max(inst.kv_used_fraction(), 0.0), 1.0)
        keep = max(1, -(-int(used * w * 1000) // 1000))  # ceil(used * w)
        return max(0, w - keep)

    def decide_partial_merge(self, instances: Sequence[InstanceView],
                             total_tokens: int,
                             min_width: Optional[int] = None
                             ) -> Optional[ScaleUp]:
        """Rung 2: widen one TP1 target onto devices LOANED a fraction
        at a time by donors that keep serving (``donor_loanable``).
        Nothing is exported and nobody parks, so the target is simply
        the least-loaded TP1 instance (it will host the long request);
        donors contribute device by device, idlest first, until the
        widened degree divides the pool and its ceiling fits.  Opt-in
        via ``cfg.partial_merge``."""
        if not self.cfg.partial_merge or len(instances) < 2:
            return None
        min_w = self.cfg.target_tp if min_width is None else min_width
        pool = sum(getattr(i, "width", i.tp) for i in instances)
        targets = [i for i in instances if i.tp == 1]
        if not targets:
            return None
        target = min(targets, key=lambda i: (i.kv_used_fraction(), i.iid))
        width = getattr(target, "width", target.tp)
        donors: List[Tuple[InstanceView, int]] = []
        for inst in sorted((i for i in instances if i is not target),
                           key=lambda i: (i.kv_used_fraction(), i.iid)):
            avail = self.donor_loanable(inst)
            take = 0
            while take < avail:
                take += 1
                width += 1
                if (width >= max(min_w, 2) and pool % width == 0
                        and target.max_seq_at(width) >= total_tokens):
                    donors.append((inst, take))
                    return ScaleUp(
                        iid=target.iid, tp_to=width,
                        donor_iids=tuple(i.iid for i, _ in donors),
                        donor_devices=tuple(n for _, n in donors),
                        reason=f"partial merge ({total_tokens} tok)")
            if take:
                donors.append((inst, take))
        return None

    def decide_spill(self, instances: Sequence[InstanceView],
                     total_tokens: int) -> Optional[Spill]:
        """Rung 1: no transformation at all — pick a guest with a free
        slot's worth of KV headroom and a host with whole free slots to
        carry the overflow; the guest serves the request with decode
        attention gathering across the distributed pool.  Opt-in via
        ``cfg.spill``."""
        if not self.cfg.spill or len(instances) < 2:
            return None
        for guest in sorted((i for i in instances if i.tp == 1),
                            key=lambda i: (i.kv_used_fraction(), i.iid)):
            ceiling = guest.max_seq()
            overflow = total_tokens - ceiling
            if overflow <= 0 or overflow > self.cfg.spill_slack * ceiling:
                continue
            if guest.kv_free_tokens() < ceiling:
                continue  # the local part needs a whole free slot
            best = None
            for host in instances:
                if host is guest:
                    continue
                # hosting reserves WHOLE slots in the host's pool
                slots = -(-overflow // max(host.max_seq(), 1))
                need = slots * host.max_seq()
                if host.kv_free_tokens() < need:
                    continue
                key = (-host.kv_free_tokens(), host.iid)
                if best is None or key < best[0]:
                    best = (key, host)
            if best is not None:
                return Spill(iid=guest.iid, host_iid=best[1].iid,
                             tokens=overflow,
                             reason=f"kv spill ({total_tokens} tok)")
        return None

    def decide_capacity(self, instances: Sequence[InstanceView],
                        total_tokens: int,
                        min_width: Optional[int] = None
                        ) -> Optional[Action]:
        """The three-rung capacity ladder (spill < partial merge < full
        merge).  Without an attached CostModel the rungs order naturally
        — a spill moves only overflow pages, a partial merge transforms
        without draining anyone, a full merge drains and parks donors.
        With ``attach_cost`` the candidates are ordered by the Table-1
        model instead (modeled transfer time vs transform wall time)."""
        cands: List[Tuple[Tuple[float, int], Action]] = []
        act = self.decide_spill(instances, total_tokens)
        if act is not None:
            cands.append((self._rung_cost(act, 0), act))
        act = self.decide_partial_merge(instances, total_tokens, min_width)
        if act is not None:
            cands.append((self._rung_cost(act, 1), act))
        act = self.decide_merge(instances, total_tokens, min_width)
        if act is not None:
            cands.append((self._rung_cost(act, 2), act))
        if not cands:
            return None
        return min(cands, key=lambda c: c[0])[1]

    def _rung_cost(self, act: Action, rung: int) -> Tuple[float, int]:
        """(estimated seconds, rung index): the rung index breaks ties
        and is the WHOLE ordering when no cost model is attached.

        The estimate prices the action's REAL shape: a spill counts its
        overflow pages at the plane's configured ``cfg.page_tokens``,
        and a transform is costed at its actual degree pair (merge
        targets sit at TP1, so ``1 -> tp_to``).  With a
        ``CalibratedCostModel`` attached, both estimates come from the
        per-(kind, degree-pair) EWMA of realized wall times once it is
        warm — the modeled value is only the cold-start prior."""
        cm = self.cost_model
        if cm is None:
            return (0.0, rung)
        if isinstance(act, Spill):
            return (cm.spill_time(act.tokens,
                                  page_tokens=self.cfg.page_tokens), rung)
        t = cm.transform_time("gyges", tp_from=1, tp_to=act.tp_to)
        if act.donor_devices and sum(act.donor_devices) < act.tp_to:
            # partial: only the loaned fraction of the target's widened
            # pool re-shards, and no donor KV is exported
            return (t * sum(act.donor_devices) / max(act.tp_to, 1), rung)
        return (t, rung)


class RoundRobinScheduler(BaseScheduler):
    """Baseline (1): round-robin, *transformation-unaware* (paper §6.2.4):
    it does not consider input length, so a long request routinely lands
    on a TP1 instance which must then scale up around itself (Fig. 13)."""
    name = "rr"

    def __init__(self, cfg=None):
        super().__init__(cfg)
        self._i = 0

    def pick(self, instances, input_len, output_len_hint):
        n = len(instances)
        for k in range(n):
            inst = instances[(self._i + k) % n]
            if inst.kv_used_fraction() < 0.95:
                self._i = (self._i + k + 1) % n
                return inst
        return None


class LeastLoadScheduler(BaseScheduler):
    """Baseline (2): least-load-first, transformation-unaware.  Idle TP1
    instances look least loaded, so long requests flow to them and trigger
    avoidable transformations — the paper's Fig. 13 pathology."""
    name = "llf"

    def pick(self, instances, input_len, output_len_hint):
        best, best_load = None, MAX
        for inst in instances:
            if inst.kv_used_fraction() < 0.95 and inst.load() < best_load:
                best, best_load = inst, inst.load()
        return best


class GygesScheduler(BaseScheduler):
    """Paper Algorithm 1 (schedule_request) + Algorithm 2
    (schedule_parallelism).  Line-by-line mapping in comments."""
    name = "gyges"

    # --- Algorithm 1 -------------------------------------------------------
    def pick(self, instances, input_len, output_len_hint):
        total = input_len + output_len_hint
        # §5.1 long classification: the configured router threshold, or
        # not fitting the cluster's TP1 instances
        long_req = self.is_long(total) or any(
            total > i.max_seq() for i in instances if i.tp == 1)

        t_load, t_instance = MAX, None            # line 2
        for inst in instances:                    # line 3
            if not inst.has_long_request():       # line 4 no_long_req()
                # long-context-aware scheduling: skip instances whose
                # headroom is reserved for a potential transformation
                if self._check_reserve(inst, long_req):      # lines 6-8
                    continue
            self._check_and_update(inst, total, long_req)
            score = self._score(inst, total, long_req)
            if score < t_load:                    # line 9 check_and_update
                t_load, t_instance = score, inst
        if t_instance is not None and self._valid(
                t_instance, input_len, total):    # line 10 valid()
            return t_instance                     # line 12 directly serve
        return None  # caller runs execute_scale_up (lines 14-16)

    def _check_reserve(self, inst: InstanceView, long_req: bool) -> bool:
        """check_reserve: a TP1 instance earmarked as a future merge
        member keeps `reserve_fraction` KV headroom free for the
        transformation; short requests that would eat it are diverted."""
        if long_req:
            return False
        if inst.reserved and inst.kv_used_fraction() > (
                1.0 - self.cfg.reserve_fraction):
            return True
        return False

    def _check_and_update(self, inst, total, long_req):
        # bookkeeping hook (kept for pseudocode fidelity; scoring below)
        return None

    def _score(self, inst: InstanceView, total: int, long_req: bool
               ) -> float:
        """Expected-performance score (lower = better).  Implements the
        paper's two stated preferences: long requests go to instances
        already at high TP (minimize #transformations); short requests
        prefer TP1 (4xTP1 = 2.33x TP4 throughput)."""
        if total > inst.max_seq() or inst.kv_free_tokens() < total:
            return MAX
        load = inst.load()
        if long_req:
            return load - 10.0 * (inst.tp > 1)    # prefer existing TP>1
        return load + 2.0 * (inst.tp - 1)         # short: prefer TP1

    def _valid(self, inst: InstanceView, input_len: int, total: int) -> bool:
        return (total <= inst.max_seq()
                and inst.kv_free_tokens() >= input_len)

    # --- Algorithm 2 -------------------------------------------------------
    def want_scale_down(self, inst: InstanceView,
                        any_long_waiting: bool) -> bool:
        cur_tp = inst.tp                                   # line 2
        if cur_tp > 1 and not inst.has_long_request() \
                and not any_long_waiting:                  # line 3
            cur_load = inst.kv_used_fraction()             # line 4
            if cur_load < self.cfg.scale_down_load:        # line 6 safe
                # weigh the modeled transform cost against predicted
                # arrival pressure (no-op without an estimator)
                return not self.pressure_high()            # line 7-9
        return False


SCHEDULERS = {c.name: c for c in (RoundRobinScheduler, LeastLoadScheduler,
                                  GygesScheduler)}
