"""Event/tick-driven cluster simulator for scheduler & e2e benchmarks
(paper §6.2.4 Fig. 12/13 and §6.3 Fig. 14): the port's copy of
``repro.core.cluster_sim``, pure Python on the port's ``events``,
``partition``, ``scheduler``, ``metrics`` and ``request`` modules.  One
seed gives the same trace in both packages (``random.Random``), and the
same trace the same decisions and metrics
(``tests/test_torch_cluster_sim.py``); against the port's live
``ClusterEngine`` the decisions are equal on the reference's parity
traces (``tests/test_torch_sim_live_parity.py``).

The simulator advances in fixed ticks.  Each instance prefills queued
requests and decodes active ones at rates given by the Table-1-calibrated
``CostModel``; parallelism transformations take method-dependent wall time
(from the §4 accounting) during which the instance is degraded.

Baselines:
  * method="gyges" | "gyges-" | "basic" | "seesaw": TP transformation with
    the corresponding §4 mechanism cost;
  * method="kunserve" / "loongserve": dynamic PP / SP — cheap
    reconfiguration but the scaled-up instance keeps PP/SP efficiency
    (only ~1/N workers active per time slot, paper §2/§7: 43.5% extra
    throughput degradation vs TP);
  * static=True: fixed hybrid deployment (no transformation; the paper's
    production baseline of §3.3).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import CostModel, Hardware, H20
from repro_torch.core.events import SLO, replay
from repro_torch.core.partition import PoolPartitionManager
from repro_torch.core.scheduler import (Action, BaseScheduler,
                                        GygesScheduler, PrefillPolicy,
                                        ScaleDown, ScaleUp, SchedulerConfig,
                                        Spill)
from repro_torch.launch.mesh import Layout
from repro_torch.serving.metrics import summarize
from repro_torch.serving.request import Request

__all__ = ["Request", "SimInstance", "Cluster", "hybrid_trace",
           "longtail_trace", "burst_trace", "production_trace"]

# PP/SP keep only ~1/N workers busy; calibrated so that the e2e gap matches
# the paper's reported 43.5% extra degradation vs TP transformation.
ENGINE_EFFICIENCY = {"gyges": 1.0, "gyges-": 1.0, "basic": 1.0,
                     "seesaw": 1.0, "kunserve": 0.565, "loongserve": 0.565}
# reconfiguration wall-time multiplier vs gyges- (kunserve/loongserve move
# no KV head shards; seesaw bounces via host memory: §6.2.3 "41x")
TRANSFORM_TIME_FACTOR = {"gyges": 1.0, "gyges-": 1.0, "basic": 1.0,
                         "seesaw": 1.0, "kunserve": 0.3, "loongserve": 0.3}
# Decode/prefill rate fraction that survives INSIDE a transformation
# window (paper Fig. 11).  Gyges overlaps the session with serving —
# the live plane's staged per-layer assemblies + double-buffered
# transfers keep decode running through merges and splits with zero
# full-stall steps (bench_e2e --merge-smoke asserts it), so the model
# charges <1%; every non-overlapping method stalls to a trickle.
TRANSFORM_OVERLAP = {"gyges": 0.99}
TRANSFORM_STALL = 0.05


class SimInstance:
    _ids = itertools.count()

    def __init__(self, tp: int, cm: CostModel, method: str,
                 iid: Optional[int] = None,
                 prefill_policy: Optional[PrefillPolicy] = None,
                 seq_quantum: Optional[int] = None, slots: int = 1,
                 width: Optional[int] = None):
        """``prefill_policy`` is the SAME ``core.scheduler.PrefillPolicy``
        the live engine consumes — the tick model runs its decisions
        (``tokens_over_steps`` / ``service_order`` / ``decode_share``)
        rather than a re-implementation.  ``seq_quantum`` (tokens per
        GPU) switches the capacity model from the Table-1 memory curve
        to the live engine's linear contract ``max_seq_at(tp) ==
        seq_quantum * tp`` — the configuration the sim/live differential
        parity harness replays; ``slots`` mirrors the live engine's
        ``max_batch`` for the KV-capacity denominator."""
        self.iid = next(SimInstance._ids) if iid is None else iid
        self.tp = tp
        # parallelism layout of the tp devices (elastic sequence
        # parallelism): pure TP unless a decide_layout action
        # re-factorized it; degree always equals self.tp
        self.par_layout = Layout.of(tp)
        # devices this instance spans; legacy sims run width == tp (an
        # instance IS its parallel degree), the live-parity geometries
        # decouple them (a width-2 engine serving at TP1 can grow in
        # place or loan its idle device to a partial merge)
        self._width = width if width is not None else tp
        # tokens of a neighbor's overflow KV hosted in this instance's
        # pool (whole reserved slots — the sim mirror of
        # Engine.host_spilled)
        self.hosted_tokens = 0.0
        self.cm = cm
        self.method = method
        self.prefill_policy = prefill_policy
        self.seq_quantum = seq_quantum
        self.slots = slots
        self.active: List[Request] = []
        self.prefill_q: List[Request] = []
        self.reserved = False
        self._kv_cache = None          # memoized kv_used (dirtied per tick)
        self.transform_until = -1.0
        # end of the transform SESSION (live parity): the §4.3 schedule
        # runs one step per decode iteration, so the session OCCUPIES
        # ~2*n_layers decode iterations even when the overlapped
        # transfer cost (transform_until) is near zero.  Whole-prompt
        # prefill admission blocks until it drains (_admittable_now).
        self.session_until = -1.0
        self.n_transforms = 0
        self.tokens_out = 0.0
        self.member_iids: List[int] = []   # merge members (split restores)
        self._prefill_deferred = 0    # decode-priority deferral carry,
                                      # persisted ACROSS ticks (bounded
                                      # starvation spans tick boundaries)

    # ---- InstanceView protocol -------------------------------------------
    def max_seq(self) -> int:
        return self.max_seq_at(self.tp)

    def max_seq_at(self, tp: int) -> int:
        if self.seq_quantum is not None:
            return self.seq_quantum * tp
        return self.cm.max_seq(tp)

    @property
    def max_tp(self) -> int:
        # an instance can widen in place up to the devices it spans
        # (live Engine.max_tp == W).  Legacy sims run width == tp, so
        # they still never grow in place — decide_scale_up skips them.
        return self._width

    @property
    def width(self) -> int:
        # GPUs this instance spans: what it contributes to a merge
        # (InstanceView.width)
        return self._width

    def kv_capacity(self) -> int:
        if self.seq_quantum is not None:
            return self.max_seq() * self.slots
        return self.cm.kv_capacity_tokens(self.tp)

    def kv_used(self) -> float:
        if self._kv_cache is None:
            self._kv_cache = (
                sum(r.in_len + r.tokens_done for r in self.active)
                + sum(r.in_len for r in self.prefill_q)
                + self.hosted_tokens)
        return self._kv_cache

    def dirty(self) -> None:
        self._kv_cache = None
        self._long_cache = None

    def kv_used_fraction(self) -> float:
        cap = max(self.kv_capacity(), 1)
        return self.kv_used() / cap

    def kv_free_tokens(self) -> int:
        return max(0, int(self.kv_capacity() - self.kv_used()))

    def load(self) -> float:
        return self.kv_used_fraction() + 0.05 * len(self.prefill_q)

    _long_cache = None

    def has_long_request(self) -> bool:
        if self._long_cache is None:
            tp1_cap = self.max_seq_at(1)
            self._long_cache = any(r.in_len + r.out_len > tp1_cap
                                   for r in self.active + self.prefill_q)
        return self._long_cache

    # ---- dynamics ----------------------------------------------------------
    def effective_tps(self, now: float) -> float:
        """Decode rate at the instance's CURRENT parallelism layout:
        SP shards split the context, so their speedup only materializes
        while long-context work is in service (the same workload
        predicate ``decide_layout`` scores layouts by)."""
        lay = self.par_layout
        base = self.cm.instance_tps(
            lay.tp, lay.sp, long_context=self.has_long_request()) \
            * ENGINE_EFFICIENCY[self.method]
        if now < self.transform_until:
            # Gyges overlaps; others stall (paper Fig. 11: <1% vs stalls)
            return base * TRANSFORM_OVERLAP.get(self.method,
                                                TRANSFORM_STALL)
        return base

    def tick(self, now: float, dt: float) -> float:
        """Advance dt seconds; returns tokens generated.

        Prefill runs under the shared ``PrefillPolicy``: the hardware
        prefill rate is further capped by the policy's per-step token
        budget aggregated over the engine steps this tick models
        (``tokens_over_steps`` — the very function the live engine sums
        one step at a time), served in the policy's order; the decode
        half is then scaled by ``decode_share`` — prefill-priority
        stalls decodes behind prompt processing (the live whole-prompt
        head-of-line pathology), decode-priority protects them.  With
        no policy the legacy behavior is preserved exactly (FCFS,
        hardware-rate-limited, no decode coupling)."""
        pol = self.prefill_policy
        prefill_fraction = 0.0
        if self.prefill_q:
            eff = ENGINE_EFFICIENCY[self.method]
            stall = (now < self.transform_until
                     and self.method not in TRANSFORM_OVERLAP)
            rate = self.cm.hw.prefill_tps * self.tp * eff * (
                TRANSFORM_STALL if stall else 1.0)
            capacity = rate * dt
            budget = capacity
            if pol is not None:
                # one modeled engine step per decode iteration the tick
                # covers (the per-request decode cadence)
                steps = max(1, int(round(self.cm.hw.per_req_tps * dt)))
                allowed, self._prefill_deferred = pol.tokens_over_steps(
                    len(self.active), steps, self._prefill_deferred)
                budget = min(capacity, allowed)
            queue = (pol.service_order(self.prefill_q,
                                       lambda r: r.in_len - r.prefilled)
                     if pol is not None else list(self.prefill_q))
            consumed = 0.0
            # live-engine parity (Engine._admittable_now /
            # _advanceable_now): whole-prompt prefills no longer wait
            # out transform sessions — mid-session they run as one
            # first-chunk call through the per-layer path, so no
            # request is skipped here
            for r in queue:
                if budget <= 0:
                    break
                adv = min(r.in_len - r.prefilled, budget)
                if adv > 0 and r.t_prefill_start is None:
                    r.t_prefill_start = now
                r.prefilled += adv
                budget -= adv
                consumed += adv
                if r.prefilled >= r.in_len:
                    r.t_first_token = now + dt
                    r.tokens_done = 1.0
                    self.active.append(r)
                    self.prefill_q.remove(r)
            prefill_fraction = consumed / max(capacity, 1e-9)
        else:
            self._prefill_deferred = 0    # no backlog (live-engine parity)
        if not self.active:
            self._kv_cache = None
            self._long_cache = None
            return 0.0
        tps = self.effective_tps(now)
        scale = (pol.decode_share(prefill_fraction)
                 if pol is not None else 1.0)
        # per-request decode rate is latency-bound (TPOT floor ~ 25 tok/s
        # at TP1, faster at higher TP); instance tps is the batch ceiling
        per_req = self.cm.hw.per_req_tps * (1.0 + 0.25 * (self.tp - 1))
        share = min(tps * dt * scale / len(self.active),
                    per_req * dt * scale)
        out = 0.0
        done = []
        for r in self.active:
            adv = min(share, r.out_len - r.tokens_done)
            r.tokens_done += adv
            out += adv
            if r.tokens_done >= r.out_len:
                r.t_finish = now + dt
                done.append(r)
        for r in done:
            self.active.remove(r)
        self.tokens_out += out
        self._kv_cache = None
        self._long_cache = None
        return out


class Cluster:
    """Hosts of `gpus_per_host` GPUs; instances live within a host."""

    def __init__(self, cfg: ModelConfig, n_hosts: int = 1,
                 gpus_per_host: int = 8, hw: Hardware = H20,
                 method: str = "gyges",
                 scheduler: Optional[BaseScheduler] = None,
                 static_layout: Optional[List[int]] = None,
                 target_tp: int = 4,
                 prefill_policy: Optional[PrefillPolicy] = None,
                 seq_quantum: Optional[int] = None, max_batch: int = 1,
                 widths: Optional[List[int]] = None,
                 page_tokens: int = 16,
                 cost_model: Optional[CostModel] = None):
        """``prefill_policy`` / ``seq_quantum`` / ``max_batch`` mirror
        the live ``ClusterEngine`` configuration (see ``SimInstance``):
        with them set, the sim serves the same chunked-prefill policy
        over the same linear capacity contract, which is what lets the
        differential parity harness diff decisions plane-against-plane.
        Instance iids are the stable construction indexes (matching the
        live plane's); a merge keeps the TARGET's iid and a split
        restores the members' — identity follows what the live plane
        does with parked/revived engines."""
        # ``cost_model`` lets both planes share ONE fitted model (e.g. a
        # ``core.calibrate.CalibratedCostModel``) so sim/live parity
        # extends to costs; default stays the Table-1 prior.
        self.cm = cost_model if cost_model is not None \
            else CostModel(cfg, hw)
        self.cfg = cfg
        self.method = method
        self.scheduler = scheduler or GygesScheduler()
        # the scheduler's rung costing prices spill segments against the
        # pool geometry this plane actually configures
        if hasattr(self.scheduler, "cfg") \
                and hasattr(self.scheduler.cfg, "page_tokens"):
            self.scheduler.cfg.page_tokens = page_tokens
        self.gpus_per_host = gpus_per_host
        self.target_tp = target_tp
        self.prefill_policy = prefill_policy
        self.seq_quantum = seq_quantum
        self.max_batch = max_batch
        self.static = static_layout is not None
        self.page_tokens = page_tokens
        self.hosts: List[List[SimInstance]] = []
        iid = itertools.count()
        for _ in range(n_hosts):
            tps = static_layout if static_layout else (
                [1] * (len(widths) if widths else gpus_per_host))
            ws = widths if widths else [None] * len(tps)
            self.hosts.append([self._new_instance(tp, next(iid), width=w)
                               for tp, w in zip(tps, ws)])
        # the shared pool-partition ledger (core.partition): sim devices
        # are synthetic ints.  Mutated on the identity-preserving
        # merge/split/loan/spill paths; an identity-LOSING split (a
        # static tp>1 instance decomposing into fresh iids) leaves the
        # old registration holding its devices — the ledger stays
        # single-owner, it just no longer names the fresh instances.
        self.partition = PoolPartitionManager()
        dev = itertools.count()
        for h in self.hosts:
            for i in h:
                self.partition.register(
                    i.iid, [next(dev) for _ in range(i.width)])
        self.spill_pages = 0
        self.partial_merges = 0
        self._req_by_rid: Dict[int, Request] = {}
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self.all_requests: List[Request] = []
        self.n_transforms = 0
        self.total_tokens = 0.0
        self.actions: List[Action] = []         # executed, in order
        self.placements: Dict[int, int] = {}    # rid -> instance iid
        # per-action transform records, schema-shared with the live
        # plane's Engine.transform_log (wall_s / measured_s / modeled_s
        # / cross); in the sim measured IS the model, so drift == 0 —
        # the live column measures how honest the Table-1 model is
        self.transform_log: List[Dict[str, float]] = []
        self.scale_down_dwell = 20.0   # s at high TP before decomposing
        self.timeline: List[Tuple[float, float]] = []  # (t, cluster tps)
        self._now = 0.0                # virtual clock of the last advance

    def _new_instance(self, tp: int, iid: Optional[int] = None,
                      width: Optional[int] = None) -> SimInstance:
        return SimInstance(tp, self.cm, self.method, iid=iid,
                           prefill_policy=self.prefill_policy,
                           seq_quantum=self.seq_quantum,
                           slots=self.max_batch, width=width)

    def _session_window(self, tp: int) -> float:
        """Wall time a §4.3 transform SESSION occupies: ~2 schedule
        steps per layer (weights + KV assemblies), one step per decode
        iteration, at the tp-dependent per-request decode cadence.  For
        overlapped methods this far exceeds ``transform_time`` (the
        transfers hide under serving) and is the window during which
        whole-prompt prefills wait (Engine._admittable_now parity)."""
        steps = 2 * self.cfg.num_layers + 2
        rate = self.cm.hw.per_req_tps * (1.0 + 0.25 * (tp - 1))
        return steps / rate

    def _transform_dur(self, tp_from: int, tp_to: int) -> float:
        """Modeled wall time of the REAL degree pair this action moves
        between (satellite fix: a TP1->2 merge no longer prices — or
        dwells — like TP2->4)."""
        return self.cm.transform_time(self.method, tp_from=tp_from,
                                      tp_to=tp_to) \
            * TRANSFORM_TIME_FACTOR[self.method]

    def _log_transform(self, dur: float, tp_from: int, tp_to: int,
                       cross: bool, layout_from: Optional[Layout] = None,
                       layout_to: Optional[Layout] = None) -> None:
        """Append a transform record AND feed it to the attached cost
        model's measured-EWMA when it has one (CalibratedCostModel) —
        the sim's feedback loop mirrors ``ClusterEngine.step``'s, except
        measured IS modeled here, so a sim-warmed EWMA converges back to
        the model it was seeded from (decisions stay parity-safe)."""
        rec = {"wall_s": dur, "measured_s": dur, "modeled_s": dur,
               "tp_from": tp_from, "tp_to": tp_to, "cross": cross,
               "kind": "transform",
               "layout_from": str(layout_from or Layout.of(tp_from)),
               "layout_to": str(layout_to or Layout.of(tp_to))}
        self.transform_log.append(rec)
        cm = getattr(self.scheduler, "cost_model", None)
        if cm is not None and hasattr(cm, "observe_transform"):
            cm.observe_transform(rec)

    # ------------------------------------------------------------------
    @property
    def instances(self) -> List[SimInstance]:
        """All instances in stable iid order — the order the live
        plane's engine list has, so tie-breaks in pick/decide policies
        (first-wins) resolve identically in both planes regardless of
        merge/split history."""
        return sorted((i for h in self.hosts for i in h),
                      key=lambda i: i.iid)

    def _host_of(self, inst: SimInstance) -> List[SimInstance]:
        for h in self.hosts:
            if inst in h:
                return h
        raise KeyError

    # ---- transformation actions ------------------------------------------
    def _merge_members(self, host: List[SimInstance],
                       members: List[SimInstance], now: float,
                       target_iid: Optional[int] = None) -> SimInstance:
        """Replace ``members`` on ``host`` with one merged instance that
        absorbs their queues (the sim analog of the live plane's
        park-donors / adopt-devices / migrate-KV sequence).  The merged
        instance KEEPS the target's iid — like the live plane, where the
        target engine transforms in place and the donors park — and
        remembers its members so a later split restores their
        identities (``Engine.revive`` parity)."""
        if target_iid is None:
            target_iid = max(members,
                             key=lambda i: i.kv_used_fraction()).iid
        # a merge spans the members' summed WIDTH (== summed tp for
        # legacy width==tp sims; wider when members had idle devices)
        merged = self._new_instance(sum(m.width for m in members),
                                    iid=target_iid)
        merged.member_iids = [target_iid] + [
            m.iid for m in members if m.iid != target_iid]
        registered = set(self.partition.partitions())
        for m in members:
            merged.active += m.active
            merged.prefill_q += m.prefill_q
            host.remove(m)
            # ledger: donors lend their whole width and park (the live
            # plane's park/adopt sequence); identity-losing instances
            # (fresh iids from a static split) are not registered
            if m.iid != target_iid and m.iid in registered \
                    and target_iid in registered:
                devs = self.partition.held_devices(m.iid)
                if devs:
                    loan = self.partition.lend(m.iid, target_iid, devs,
                                               whole=True)
                    self.partition.park(m.iid)
                    self.partition.adopt(target_iid, loan)
        merged.dirty()
        dur = self._transform_dur(1, merged.tp)
        merged.transform_until = now + dur
        merged.session_until = now + max(dur,
                                         self._session_window(merged.tp))
        merged.n_transforms = 1
        self.n_transforms += 1
        # sim instances always merge across device assemblies: every
        # transform record is cross, with wall == measured == modeled
        self._log_transform(dur, 1, merged.tp, cross=True)
        self.actions.append(ScaleUp(
            iid=merged.iid, tp_to=merged.tp,
            donor_iids=tuple(merged.member_iids[1:]),
            reason=f"merge x{len(members)}"))
        host.append(merged)
        return merged

    def execute_scale_up(self, now: float, total_tokens: int,
                         seed: Optional[SimInstance] = None
                         ) -> Optional[SimInstance]:
        """Merge TP1 instances on one host into one TP-N instance (paper
        Fig. 3).  With ``seed`` (transformation-unaware baselines) the
        merge grows around the chosen instance via the SAME
        ``decide_seed_scale_up`` policy the live plane executes;
        otherwise donor choice is delegated to
        ``scheduler.decide_merge`` — so sim and live merge identically
        (host with the idlest members preferred)."""
        if self.static:
            return None
        if seed is not None and seed.tp > 1:
            return None  # already scaled; cannot grow further here
        if seed is not None:
            host = self._host_of(seed)
            act = self.scheduler.decide_seed_scale_up(
                sorted(host, key=lambda i: i.iid), seed, total_tokens)
            if act is None:
                return None
            if not act.donor_iids:
                # width > tp seeds grow in place (live Engine.transform);
                # legacy width==tp sims never reach here
                return self._execute_grow(act, now)
            chosen = {act.iid, *act.donor_iids}
            members = [i for i in host if i.iid in chosen]
            return self._merge_members(host, members, now,
                                       target_iid=act.iid)
        best = None
        for h in self.hosts:
            act = self.scheduler.decide_merge(
                sorted(h, key=lambda i: i.iid), total_tokens,
                min_width=self.target_tp)
            if act is None:
                continue
            chosen = {act.iid, *act.donor_iids}
            members = [i for i in h if i.iid in chosen]
            score = sum(i.kv_used_fraction() for i in members)
            if best is None or score < best[0]:
                best = (score, h, members, act.iid)
        if best is None:
            return None
        _, host, members, target_iid = best
        return self._merge_members(host, members, now,
                                   target_iid=target_iid)

    # ---- capacity ladder (spill < partial merge < full merge) ------------

    def _execute_grow(self, act: ScaleUp, now: float
                      ) -> Optional[SimInstance]:
        """In-place growth: a width>tp instance widens onto its own
        devices (live ``Engine.transform(tp_to)``); no ledger motion."""
        inst = next((i for i in self.instances if i.iid == act.iid), None)
        if inst is None or act.tp_to > inst.width:
            return None
        tp_prev = inst.tp
        dur = self._transform_dur(tp_prev, act.tp_to)
        inst.tp = act.tp_to
        inst.par_layout = Layout.of(act.layout or act.tp_to)
        inst.transform_until = now + dur
        inst.session_until = now + max(dur, self._session_window(inst.tp))
        inst.n_transforms += 1
        self.n_transforms += 1
        self._log_transform(dur, tp_prev, act.tp_to, cross=False)
        self.actions.append(act)
        self._update_reserve()
        return inst

    def _execute_partial(self, act: ScaleUp, now: float
                         ) -> Optional[SimInstance]:
        """Partial merge: donors shed a fraction of their devices (they
        keep serving at reduced width, nothing parks, no KV moves) and
        the target widens onto the loaned devices.  The live plane runs
        this in two phases (donor shrink sessions drain, then the
        target adopts); the sim executes atomically at the modeled cost
        — parity is at the decision/action level."""
        by_iid = {i.iid: i for i in self.instances}
        target = by_iid.get(act.iid)
        if target is None or target.tp != 1:
            return None
        dur = self._transform_dur(1, act.tp_to)
        # only the loaned fraction of the widened pool re-shards
        dur *= sum(act.donor_devices) / max(act.tp_to, 1)
        for iid, n in zip(act.donor_iids, act.donor_devices):
            d = by_iid[iid]
            held = self.partition.held_devices(iid)
            loan = self.partition.lend(iid, target.iid, held[-n:],
                                       whole=False)
            self.partition.adopt(target.iid, loan)
            d._width -= n
            d.tp = min(d.tp, d._width)
            d.par_layout = Layout.of(d.tp)
            d.transform_until = now + dur
            d.session_until = now + max(dur, self._session_window(d.tp))
            d.dirty()
        target._width += sum(act.donor_devices)
        target.tp = act.tp_to
        target.par_layout = Layout.of(act.layout or act.tp_to)
        target.transform_until = now + dur
        target.session_until = now + max(dur,
                                         self._session_window(act.tp_to))
        target.n_transforms += 1
        target.dirty()
        self.n_transforms += 1
        self.partial_merges += 1
        self._log_transform(dur, 1, act.tp_to, cross=True)
        self.actions.append(act)
        self._update_reserve()
        return target

    def _execute_spill(self, act: Spill, req: Request, now: float) -> bool:
        """KV spill: the host reserves whole slots for the overflow and
        the guest serves the request across the distributed pool — no
        transformation at all.  Returns False when the host cannot
        grant the reservation (the caller falls down the ladder)."""
        by_iid = {i.iid: i for i in self.instances}
        guest, host = by_iid.get(act.iid), by_iid.get(act.host_iid)
        if guest is None or host is None or guest is host:
            return False
        slots = -(-act.tokens // max(host.max_seq(), 1))
        grant = slots * host.max_seq()
        if host.kv_free_tokens() < grant:
            return False
        pages = -(-act.tokens // self.page_tokens)
        self.partition.open_spill(guest.iid, host.iid, req.rid, pages,
                                  tuple(range(slots)), tokens=grant)
        host.hosted_tokens += grant
        host.dirty()
        self.placements[req.rid] = guest.iid
        guest.prefill_q.append(req)
        guest.dirty()
        self.actions.append(act)
        self.spill_pages += pages
        self._update_reserve()
        return True

    def _place_ladder(self, req: Request, total: int, now: float) -> bool:
        """Mirror of the live plane's capacity ladder (the tail of
        ``ClusterEngine._place``): ask ``decide_scale_up`` for the
        cheapest rung and execute it — in-place growth, spill, partial
        merge, or full merge — falling one rung down when a spill grant
        fails.  Only reached when the ladder is opted into
        (``cfg.spill`` / ``cfg.partial_merge``), so legacy sims never
        enter."""
        spill_parties = {r.guest for r in self.partition.spills().values()}
        spill_parties |= {r.host for r in self.partition.spills().values()}
        for h in self.hosts:
            insts = [i for i in sorted(h, key=lambda i: i.iid)
                     if i.iid not in spill_parties
                     and now >= max(i.transform_until, i.session_until)]
            act = self.scheduler.decide_scale_up(insts, req.in_len,
                                                 req.out_len)
            while act is not None:
                if isinstance(act, Spill):
                    if self._execute_spill(act, req, now):
                        return True
                    act = (self.scheduler.decide_partial_merge(insts,
                                                               total)
                           or self.scheduler.decide_merge(insts, total))
                    continue
                if act.donor_devices:
                    inst = self._execute_partial(act, now)
                elif act.donor_iids:
                    members = [i for i in h
                               if i.iid in {act.iid, *act.donor_iids}]
                    inst = self._merge_members(h, members, now,
                                               target_iid=act.iid)
                else:
                    inst = self._execute_grow(act, now)
                if inst is None:
                    return False
                self.placements[req.rid] = inst.iid
                inst.prefill_q.append(req)
                inst.dirty()
                return True
        return False

    def _execute_layout(self, act: ScaleUp, now: float
                        ) -> Optional[SimInstance]:
        """Same-degree layout change (elastic sequence parallelism):
        re-factorize ``act.iid``'s devices to ``act.layout`` at the
        modeled re-partition cost.  Capacity is untouched — only the
        decode-rate model (``SimInstance.effective_tps``) changes.  The
        live plane runs the same action as a §4.3 layer-coherent
        session (``Engine.transform(tp_to, layout=...)``)."""
        inst = next((i for i in self.instances if i.iid == act.iid), None)
        if (inst is None or act.layout is None or inst.tp != act.tp_to
                or Layout.of(act.layout) == inst.par_layout):
            return None
        lay_from, lay_to = inst.par_layout, Layout.of(act.layout)
        dur = self.cm.transform_time(
            self.method, tp_from=inst.tp, tp_to=act.tp_to,
            layout_from=lay_from, layout_to=lay_to) \
            * TRANSFORM_TIME_FACTOR[self.method]
        inst.par_layout = lay_to
        inst.transform_until = now + dur
        inst.session_until = now + max(dur, self._session_window(inst.tp))
        inst.n_transforms += 1
        inst.dirty()
        self.n_transforms += 1
        self._log_transform(dur, inst.tp, inst.tp, cross=False,
                            layout_from=lay_from, layout_to=lay_to)
        self.actions.append(act)
        return inst

    def execute_scale_down(self, inst: SimInstance, now: float) -> None:
        host = self._host_of(inst)
        tp1_cap = inst.max_seq_at(1)
        if any(r.in_len + r.out_len > tp1_cap
               for r in inst.active + inst.prefill_q):
            return
        loans = self.partition.loans_to(inst.iid)
        if loans and not any(ln.whole for ln in loans):
            # partial-merge target: shed the loaned devices back to the
            # still-serving donors (they widen in place); nobody parks
            # or revives and the target keeps its own work
            by_iid = {i.iid: i for i in self.instances}
            tp_prev = inst.tp
            dur = self._transform_dur(tp_prev, 1)
            for ln in list(loans):
                d = by_iid[ln.lender]
                d._width += len(self.partition.return_loan(ln))
                d.transform_until = now + dur
                d.session_until = now + max(dur,
                                            self._session_window(d.tp))
                d.dirty()
            inst._width = len(self.partition.held_devices(inst.iid))
            inst.tp = 1
            inst.par_layout = Layout.of(1)
            inst.transform_until = now + dur
            inst.session_until = now + max(dur, self._session_window(1))
            self.n_transforms += 1
            self._log_transform(dur, tp_prev, 1, cross=True)
            self.actions.append(ScaleDown(iid=inst.iid, tp_to=1,
                                          reason="low load"))
            self._update_reserve()
            return
        # whole-engine loans: return each and revive the parked lender
        # (live _finalize_releases parity); partial loans mixed in also
        # return (their lenders widen silently)
        for ln in list(loans):
            self.partition.return_loan(ln)
            if ln.whole:
                self.partition.revive(ln.lender)
        host.remove(inst)
        # split restores the merge members' identities (live parity:
        # the target shrinks in place, the parked donors revive), each
        # on its registered home width
        iids = (list(inst.member_iids) if inst.member_iids
                else [None] * inst.tp)
        registered = set(self.partition.partitions())
        parts = [self._new_instance(
            1, iid=i,
            width=(len(self.partition.home_devices(i))
                   if i in registered else None))
            for i in iids]
        for j, r in enumerate(inst.active):
            parts[j % len(parts)].active.append(r)
        for j, r in enumerate(inst.prefill_q):
            parts[j % len(parts)].prefill_q.append(r)
        dur = self._transform_dur(inst.tp, 1)
        for p in parts:
            p.transform_until = now + dur
            p.session_until = now + max(dur, self._session_window(1))
        self.n_transforms += 1
        self._log_transform(dur, inst.tp, 1, cross=True)
        self.actions.append(ScaleDown(iid=inst.iid, tp_to=1,
                                      reason="low load"))
        host.extend(parts)
        self._update_reserve()

    def _update_reserve(self) -> None:
        """Alg 2 line 9 update_reserve(): on each host, earmark one group
        of target_tp TP1 instances as the next merge candidates."""
        if not isinstance(self.scheduler, GygesScheduler):
            return
        for h in self.hosts:
            tp1 = sorted([i for i in h if i.tp == 1],
                         key=lambda i: i.kv_used_fraction())
            for i in h:
                i.reserved = False
            for i in tp1[:self.target_tp]:
                i.reserved = True

    # ---- main loop ----------------------------------------------------
    def _place(self, req: Request, now: float) -> bool:
        total = req.in_len + req.out_len
        if self.static:
            # static hybrid deployment: fit-aware least-load routing
            fit = [i for i in self.instances
                   if total <= i.max_seq() and i.kv_free_tokens()
                   >= req.in_len]
            inst = min(fit, key=lambda i: i.load(), default=None)
        else:
            inst = self.scheduler.pick(self.instances, req.in_len,
                                       req.out_len)
            if inst is not None and (total > inst.max_seq()
                                     or inst.kv_free_tokens() < req.in_len):
                # transformation-unaware pick: the chosen instance must
                # scale up around itself (paper Fig. 13 pathology)
                inst = self.execute_scale_up(now, total, seed=inst)
            if inst is None:
                scfg = getattr(self.scheduler, "cfg", None)
                if scfg is not None and (getattr(scfg, "spill", False)
                                         or getattr(scfg, "partial_merge",
                                                    False)):
                    # opted-in capacity ladder (live ``_place`` tail)
                    return self._place_ladder(req, total, now)
                inst = self.execute_scale_up(now, total)  # Alg1 l.15
            if inst is not None and (total > inst.max_seq()
                                     or inst.kv_free_tokens() < req.in_len):
                inst = None
        if inst is None:
            return False
        self.placements[req.rid] = inst.iid
        inst.prefill_q.append(req)
        inst.dirty()
        return True

    def submit(self, req: Request, now: float) -> None:
        self.scheduler.observe_arrival(now, req.in_len + req.out_len)
        self._req_by_rid[req.rid] = req
        if not self._place(req, now):
            self.waiting.append(req)

    # ---- replay-plane protocol (core.events.replay) -------------------
    def advance(self, now: float, dt: float) -> None:
        """One serving step covering ``dt`` virtual seconds: retry the
        waiting queue (throttled), tick every instance, then run the
        Alg 2 scale-down scan over the dwell-gated candidates.  This is
        the exact body of the legacy ``run`` loop — ``run`` now drives
        it through ``core.events.replay`` in fixed-horizon mode."""
        self.scheduler.observe_time(now)
        # retry waiting requests (throttled; FCFS: stop at first
        # request that still cannot be placed)
        if self.waiting and int(now / dt) % max(1, int(0.5 / dt)) == 0:
            while self.waiting:
                if not self._place(self.waiting[0], now):
                    break
                self.waiting.pop(0)
        out = sum(i.tick(now, dt) for i in self.instances)
        self.total_tokens += out
        self.timeline.append((now, out / dt))
        # Alg 2: periodic scale-down scan — the scheduler returns
        # declarative actions; the sim control plane executes them
        cap1 = max(i.max_seq_at(1) for i in self.instances)
        any_long_wait = any(
            r.in_len + r.out_len > cap1 for r in self.waiting)
        if not self.static:
            # dwell counts from SESSION end (live parity: a transforming
            # engine is never Alg-2 eligible and dwell restamps until
            # the schedule drains)
            eligible = [
                i for i in self.instances if i.tp > 1
                and now > max(i.transform_until, i.session_until)
                + self.scale_down_dwell]
            by_iid = {i.iid: i for i in eligible}
            for act in self.scheduler.schedule_parallelism(
                    eligible, any_long_wait):
                self.execute_scale_down(by_iid[act.iid], now)
            # elastic-SP layout scan (opt-in via SchedulerConfig.layouts;
            # decision-for-decision with ClusterEngine.step): any wide
            # instance outside a transform window may re-factorize its
            # degree to the layout that wins its current workload mix
            lay_eligible = [
                i for i in self.instances if i.tp > 1
                and now > max(i.transform_until, i.session_until)]
            for act in self.scheduler.decide_layout(lay_eligible):
                self._execute_layout(act, now)
        # close spill regions whose guest request finished: the host's
        # reserved slots return to its free pool (live
        # ``_finalize_spills`` / ``release_hosted``)
        for region_id, region in list(self.partition.spills().items()):
            r = self._req_by_rid.get(region.rid)
            if r is not None and r.tokens_done >= r.out_len:
                self.partition.close_spill(region_id)
                host = next((i for i in self.instances
                             if i.iid == region.host), None)
                if host is not None:
                    host.hosted_tokens -= region.meta.get("tokens", 0)
                    host.dirty()
        self._now = now + dt

    @property
    def idle(self) -> bool:
        """Nothing queued, in flight, or inside a transform window —
        the replay loop's idle-jump predicate (the live plane's
        ``ClusterEngine.idle`` contract)."""
        if self.waiting:
            return False
        for i in self.instances:
            if i.active or i.prefill_q or self._now < max(
                    i.transform_until, i.session_until):
                return False
        return True

    def run(self, requests: Sequence[Request], dt: float = 0.05,
            drain: float = 60.0) -> Dict[str, float]:
        """Legacy fixed-horizon entry point: replay the trace with the
        shared event-driven loop pinned to lockstep mode (advance every
        ``dt`` until ``max(arrive) + drain``, idle or not) — bit-equal
        with the pre-event-queue tick loop."""
        reqs = sorted(requests, key=lambda r: r.arrive)
        self.all_requests = list(reqs)
        t_end = max(r.arrive for r in reqs) + drain
        self._update_reserve()
        replay(self, reqs, dt=dt, until=t_end, idle_jump=False)
        return self.metrics(t_end)

    def run_timed(self, requests: Sequence[Request], dt: float = 0.25,
                  settle_steps: int = 120, max_steps: int = 2_000_000
                  ) -> Dict[str, float]:
        """Event-driven entry point: serve the trace to completion under
        the virtual clock, jumping over idle gaps (``settle_steps``
        advances first, so dwell-gated scale-downs execute before each
        jump).  Requests carrying an ``SLO`` feed ``goodput_slo``."""
        reqs = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        self.all_requests = list(reqs)
        self._update_reserve()
        res = replay(self, reqs, dt=dt, settle_steps=settle_steps,
                     max_steps=max_steps)
        return self.metrics(res["t_end"])

    def metrics(self, t_end: float) -> Dict[str, float]:
        """Shared schema (serving.metrics): key-identical with the live
        ``ClusterEngine.metrics()``."""
        return summarize(self.all_requests, t_end, self.total_tokens,
                         self.n_transforms, transforms=self.transform_log,
                         spill_pages=self.spill_pages,
                         partial_merges=self.partial_merges)


# ---------------------------------------------------------------------------
# Trace generation (paper §6.2.4 hybrid workload + Fig. 2 long-tail trace)
# ---------------------------------------------------------------------------

def hybrid_trace(duration: float = 300.0, short_qpm: float = 60.0,
                 long_qpm: float = 1.0, short_len: int = 1000,
                 long_len: int = 50_000, out_len: int = 200,
                 seed: int = 0) -> List[Request]:
    """§6.2.4: short 1K-input requests at 60 qpm + long 50K-input at 1 qpm."""
    import random
    rnd = random.Random(seed)
    reqs: List[Request] = []
    rid = 0
    for qpm, ilen in ((short_qpm, short_len), (long_qpm, long_len)):
        t = rnd.expovariate(qpm / 60.0)
        while t < duration:
            reqs.append(Request(rid, t, ilen, out_len))
            rid += 1
            t += rnd.expovariate(qpm / 60.0)
    return reqs


def burst_trace(duration: float = 240.0, bg_qps: float = 3.0,
                bg_len: int = 800, bg_out: int = 250,
                burst_at: float = 60.0, burst_n: int = 8,
                burst_len: int = 100_000, burst_out: int = 200,
                seed: int = 0) -> List[Request]:
    """Long-prompt burst over a decoding background (bench_e2e --burst):
    a steady stream of short requests (the background — each prefills
    briefly then decodes for a while) plus ``burst_n`` long prompts
    arriving together at ``burst_at``.  Under whole-prompt
    prefill-priority scheduling the burst's prompts monopolize the
    engines and the background's TTFT p99 explodes (head-of-line
    blocking, paper Fig. 2 context-length variance); a token-budgeted
    decode-priority policy bounds it."""
    import random
    rnd = random.Random(seed)
    reqs: List[Request] = []
    rid = 0
    t = rnd.expovariate(bg_qps)
    while t < duration:
        reqs.append(Request(rid, t, bg_len, bg_out))
        rid += 1
        t += rnd.expovariate(bg_qps)
    for _ in range(burst_n):
        reqs.append(Request(rid, burst_at, burst_len, burst_out))
        rid += 1
    return reqs


def longtail_trace(duration: float = 300.0, qps: float = 0.6,
                   seed: int = 0) -> List[Request]:
    """§6.3: long-tail input-length distribution following Fig. 2a
    (lognormal body + heavy tail) at the paper's 0.6 QPS operating point."""
    import random
    rnd = random.Random(seed)
    reqs: List[Request] = []
    t, rid = 0.0, 0
    while t < duration:
        u = rnd.random()
        if u < 0.92:
            ilen = int(min(3500, max(64, rnd.lognormvariate(6.5, 0.8))))
        elif u < 0.985:
            ilen = rnd.randint(4_000, 30_000)
        else:
            ilen = rnd.randint(30_000, 100_000)
        out = int(max(16, min(2000, rnd.lognormvariate(4.8, 0.9))))
        reqs.append(Request(rid, t, ilen, out))
        rid += 1
        t += rnd.expovariate(qps)
    return reqs


def production_trace(duration: float = 600.0, base_qps: float = 2.0,
                     burst_period: float = 90.0, burst_dur: float = 12.0,
                     burst_qps: float = 6.0, burst_long_frac: float = 0.3,
                     long_len: Tuple[int, int] = (6_000, 40_000),
                     ttft_scale: float = 3.0, ttft_floor: float = 4.0,
                     tpot_slo: float = 0.12,
                     seed: int = 0) -> List[Request]:
    """Paper-Fig.-2-shaped synthetic production trace for the timed
    replay: a Poisson MIXTURE of a steady short-dominated background
    (``base_qps``, lognormal body lengths) and periodic bursts (every
    ``burst_period`` s, for ``burst_dur`` s, at ``base_qps +
    burst_qps``) whose requests are long with probability
    ``burst_long_frac`` — the bursty-arrival + context-length-variance
    regime (Fig. 2a/2b) the transformation-aware scheduler must ride.

    Every request carries an ``SLO``: TTFT within ``ttft_floor`` plus
    ``ttft_scale``x the ideal TP1 prefill time of its prompt (longer
    prompts legitimately wait longer), TPOT within ``tpot_slo``.
    Durations are virtual seconds; at the defaults a 600 s trace is
    ~1.4k requests."""
    import random
    rnd = random.Random(seed)
    reqs: List[Request] = []
    t, rid = 0.0, 0
    prefill_tps = float(H20.prefill_tps)
    while t < duration:
        in_burst = (t % burst_period) < burst_dur
        qps = base_qps + (burst_qps if in_burst else 0.0)
        if in_burst and rnd.random() < burst_long_frac:
            ilen = rnd.randint(*long_len)
        else:
            ilen = int(min(3500, max(64, rnd.lognormvariate(6.2, 0.8))))
        out = int(max(16, min(600, rnd.lognormvariate(4.2, 0.8))))
        slo = SLO(ttft_s=ttft_floor + ttft_scale * ilen / prefill_tps,
                  tpot_s=tpot_slo)
        reqs.append(Request(rid, t, ilen, out, slo=slo))
        rid += 1
        t += rnd.expovariate(qps)
    return reqs
