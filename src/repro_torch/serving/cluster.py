"""Multi-instance serving control plane: the §5 scheduler drives live
engines.  The counterpart of ``repro.serving.cluster``.

``ClusterEngine`` runs N live ``Engine`` instances on disjoint worker
subsets of one device pool (``launch.mesh.Worker`` identities; on one
card the pool is ``["cuda"] * N*W``, on the CPU ``["cpu"] * N*W``) and
drives them with one ``core.scheduler`` policy:

* **routing** (Alg 1): ``submit`` asks ``scheduler.pick`` for an
  instance; every engine implements the ``InstanceView`` protocol;
* **scale-up** (Alg 1 lines 14-16): a long request no instance can
  admit yields a ``ScaleUp`` from ``scheduler.decide_scale_up``, run as
  ``Engine.transform(tp_to)``: one §4.3 schedule step per decode
  iteration, serving throughout;
* **scale-down** (Alg 2): each cluster step, ``schedule_parallelism``
  scans the dwell-gated instances;
* **cross-instance merge** (paper Fig. 3): a ``ScaleUp`` naming
  ``donor_iids`` drains and parks each donor, exports its in-flight KV
  (the gather kernel), lends its workers to the target
  (``Engine.adopt_devices`` grows the pool), imports the donors'
  requests (the scatter kernel) and runs the target's session across the
  widened assembly, layer by layer, while decode and chunked prefill go
  on (``stall_steps`` / ``tokens_during_session`` measure that).  A
  later ``ScaleDown`` of the merged engine transforms it back onto its
  home workers, returns the loan and revives the donors.

* **KV spill** (rung 1 of the reference's capacity ladder, opt-in with
  ``SchedulerConfig(spill=True)``): a ``Spill`` from the scheduler
  serves a request above its guest's ceiling with no transformation: the
  host engine reserves whole free slots for the overflow pages
  (``Engine.host_spilled``) and the guest serves the request on an
  extended view of its slot and those pages (``Engine.admit_spilled``).
  A host that cannot grant falls back down the ladder to a partial
  merge, then a full one.

* **partial merge** (rung 2, opt-in with
  ``SchedulerConfig(partial_merge=True)``): a ``ScaleUp`` naming
  ``donor_devices`` has each donor shed that many workers in place (a
  same-degree move, or a narrower degree, onto the workers it keeps:
  it keeps serving and never parks), lends them to the target, and once
  every donor's move has landed the target adopts them and widens to
  the action's degree (``_advance_partials``).  The split returns the
  loans and the donors widen back onto them.

* **elastic SP layouts** (opt-in with ``SchedulerConfig(layouts=True)``):
  each cluster step, ``scheduler.decide_layout`` scans the wide engines
  outside a transform and re-factorizes an engine's degree to the
  ``(sp, tp)`` layout that wins its workload mix (long context in
  service: sequence parallel, e.g. a merged TP2 -> SP2xTP1; shorts only:
  pure TP), a same-degree ``ScaleUp`` carrying ``layout``, run as
  ``Engine.transform(tp_to, layout=...)``: a §4.3 session that serves
  throughout.  A merged engine's split (``ScaleDown``) leaves from
  whichever layout it holds.

``metrics()`` is key-for-key ``serving.metrics.METRIC_KEYS``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.padding import make_plan
from repro_torch.core.partition import Loan, PoolPartitionManager
from repro_torch.core.scheduler import (Action, BaseScheduler,
                                        GygesScheduler, PrefillPolicy,
                                        ScaleDown, ScaleUp, SchedulerConfig,
                                        Spill)
from repro_torch.core.weight_transform import relayout_block_mlp
from repro_torch.launch.mesh import Worker, workers_of
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, live_change_refusal
from repro_torch.serving.metrics import summarize
from repro_torch.serving.request import ServeRequest, State


class ClusterEngine:
    """N live transformable engines over one shared worker pool, driven
    by one scheduler policy.

    Invariants the control plane keeps:

    * every pool worker is held by exactly one non-parked engine, or is
      on loan to a merge target (``self.partition``);
    * at most one transformation session per engine;
    * the padding plan is built for the FULL pool width, so every merged
      TP degree keeps the Eq. 2 MLP layout (callers passing ``params``
      build them with ``self.plan``).

    ``devices`` is required: ``["cuda"] * k`` for k workers of the card,
    ``["cpu"] * k`` for the plain PyTorch path.  Weights: ``params`` (a
    ``Model`` planned for ``self.plan``, its MLP in that plan's Eq. 2
    layout) or random from ``seed`` on the first worker's device.  The
    first engine's first worker takes the model's tensors; every other
    worker copies engine 0's replica, and a revived donor copies the
    split engine's (weights are identical cluster-wide), so the cluster
    keeps no extra copy of the weights.  ``transform_attn=False`` reaches
    every engine (the reference's faithful mode: attention replicas stay
    whole, a merge copies a whole one to each adopted worker and a split
    returns its loans without gathering any)."""

    def __init__(self, cfg: ModelConfig, devices: Sequence,
                 n_instances: int = 2, max_batch: int = 2,
                 max_seq: int = 64, page_tokens: int = 16,
                 scheduler: Optional[BaseScheduler] = None, seed: int = 0,
                 params: Optional[M.Model] = None, dwell_steps: int = 8,
                 prefill_policy: Optional[PrefillPolicy] = None,
                 clock=None, transform_attn: bool = True):
        if n_instances < 1 or len(devices) < n_instances:
            raise ValueError(f"{n_instances} instances need at least "
                             f"{n_instances} of {len(devices)} devices")
        workers = workers_of(devices)
        W = len(workers) // n_instances
        self.cfg = cfg
        self._clock = clock if clock is not None else time.monotonic
        self.dwell_steps = dwell_steps
        self.total_width = n_instances * W
        # plan for the FULL pool width: a merge may spread any engine
        # over every worker of the pool, and the MLP layout must hold
        self.plan = make_plan(cfg, self.total_width, mode="page")
        if params is None:
            params = M.build(cfg, self.plan, seed, device=workers[0].device)
            for blk in params.layers:
                relayout_block_mlp(blk.mlp, cfg.d_ff, self.total_width,
                                   cfg.activation)
        self.prefill_policy = prefill_policy or PrefillPolicy()
        self.engines: List[Engine] = []
        for k in range(n_instances):
            self.engines.append(Engine(
                cfg, params=params if k == 0 else self.engines[0],
                max_batch=max_batch, max_seq=max_seq,
                page_tokens=page_tokens,
                devices=workers[k * W:(k + 1) * W], iid=k, plan=self.plan,
                prefill_policy=self.prefill_policy, clock=self._clock,
                transform_attn=transform_attn))
        del params
        if scheduler is None:
            scheduler = GygesScheduler(SchedulerConfig(
                long_threshold=self.engines[0].max_seq_at(1), target_tp=W,
                page_tokens=page_tokens))
        elif hasattr(scheduler, "cfg") \
                and hasattr(scheduler.cfg, "page_tokens"):
            scheduler.cfg.page_tokens = page_tokens
        self.scheduler = scheduler
        # measured-cost feedback cursors (engine iid -> transform and
        # spill records already fed to an attached cost model)
        self._cost_fed: Dict[int, Tuple[int, int]] = {}

        self.waiting: List[ServeRequest] = []   # router-level queue
        self.requests: List[ServeRequest] = []  # everything submitted
        self.actions: List[Action] = []         # executed, in order
        self.placements: Dict[int, int] = {}    # rid -> engine iid
        self.steps = 0
        self.n_transforms = 0
        self.total_tokens = 0
        # overlap accounting: engine steps taken while a cross-assembly
        # session was open, tokens emitted in them, and full stalls
        # (decode slots active, zero decode tokens)
        self.session_steps = 0
        self.tokens_during_session = 0
        self.stall_steps = 0
        self._last_transform_step = {e.iid: -(10 ** 9) for e in self.engines}
        self.partition = PoolPartitionManager()
        for e in self.engines:
            self.partition.register(e.iid, list(e.devices))
        self._releasing: Set[int] = set()       # splits awaiting drain
        # partial merges whose donors are still shedding their loans
        self._pending_partials: List[Dict] = []
        # the merges this cluster ran: target, donors, cluster step and
        # the (rid, target slot) of each imported request
        self.merge_log: List[Dict] = []
        self.spill_pages = 0
        self.partial_merges = 0
        self.t_start: Optional[float] = None
        self._update_reserve()

    # ------------------------------------------------------------------
    def _engine(self, iid: int) -> Engine:
        return next(e for e in self.engines if e.iid == iid)

    def _active_engines(self) -> List[Engine]:
        """Engines that own workers (parked donors are invisible to
        routing and scheduling until revived)."""
        return [e for e in self.engines if not e.parked]

    def _transformable(self) -> List[Engine]:
        """Scale actions target engines with no session in flight;
        routing sees every non-parked engine (a transforming one
        advertises its target capacity).  Engines with open spill
        regions (guest or host) cannot transform until they close: a
        pool resize would move hosted or overflow pages out from under
        the extended views; a partial-merge target awaiting its loaned
        workers is already committed."""
        return [e for e in self.engines
                if not e.transforming and not e.parked
                and not e.awaiting_devices
                and not e._spills and not e._hosted]

    def _update_reserve(self) -> None:
        """update_reserve() (Alg 2 line 9): earmark the least-loaded TP1
        engine as the next scale-up candidate."""
        if not isinstance(self.scheduler, GygesScheduler):
            return
        for e in self.engines:
            e.reserved = False
        tp1 = sorted((e for e in self._active_engines()
                      if e.tp == 1 and not e.transforming),
                     key=lambda e: e.kv_used_fraction())
        if tp1:
            tp1[0].reserved = True

    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        """Route one request (Alg 1).  Rejects only requests above the
        whole pool's merged capacity."""
        total = req.total_tokens
        if total > max(e.max_seq_at(self.total_width)
                       for e in self._active_engines()):
            raise ValueError(
                f"request {req.rid}: {total} tokens exceeds the device "
                f"pool's merged capacity")
        if self.t_start is None:
            self.t_start = self._clock()
        req.t_submit = self._clock()
        self.scheduler.observe_arrival(req.t_submit, total)
        self.requests.append(req)
        if not self._place(req):
            self.waiting.append(req)

    def _place(self, req: ServeRequest) -> bool:
        total = req.total_tokens
        inst = self.scheduler.pick(self._active_engines(),
                                   len(req.prompt), req.max_new_tokens)
        if inst is not None and total > inst.max_seq():
            # transformation-unaware pick (RR/LLF): capacity must grow
            # around the chosen instance (the Fig. 13 pathology)
            if inst.transforming:
                return False
            act = self.scheduler.decide_seed_scale_up(
                self._transformable(), inst, total)
            if act is not None and self._execute(act):
                self.placements[req.rid] = act.iid
                self._engine(act.iid).submit(req)
                return True
            inst = None
        if inst is not None:
            self.placements[req.rid] = inst.iid
            inst.submit(req)
            return True
        act = self.scheduler.decide_scale_up(self._transformable(),
                                             len(req.prompt),
                                             req.max_new_tokens)
        while act is not None:
            if isinstance(act, Spill):
                if self._execute_spill(req, act):
                    self.placements[req.rid] = act.iid
                    return True
                # the host is out of free slots (a stale view): fall one
                # rung DOWN the ladder, to a partial merge, then a full
                # one, instead of failing the placement
                act = (self.scheduler.decide_partial_merge(
                           self._transformable(), total)
                       or self.scheduler.decide_merge(
                           self._transformable(), total))
                continue
            if self._execute(act):
                # the request rides the transforming engine's queue
                self.placements[req.rid] = act.iid
                self._engine(act.iid).submit(req)
                return True
            return False
        return False

    # ---- action execution ---------------------------------------------
    def _refuse_live_change(self, act: Action) -> None:
        """A model whose engines keep their degree and slots (an encoder
        or vision model: ``engine.live_change_refusal``) takes no scale
        action, merge or spill: it serves on static-degree instances."""
        reason = live_change_refusal(self.cfg)
        if reason is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: {type(act).__name__} on instance "
                f"{act.iid}: {reason}")

    def _execute(self, act: Action) -> bool:
        """Execute one declarative action.  False when a merge's
        preconditions fail; nothing is mutated then."""
        self._refuse_live_change(act)
        eng = self._engine(act.iid)
        if isinstance(act, ScaleUp) and act.donor_devices:
            n_steps = self._merge_partial(act, eng)
            if n_steps is None:
                return False
        elif isinstance(act, ScaleUp) and act.donor_iids:
            n_steps = self._merge(act, eng)
            if n_steps is None:
                return False
        elif isinstance(act, ScaleDown) and self.partition.loans_to(act.iid):
            n_steps = self._split(act, eng)
        else:
            # a ScaleUp may carry the target layout (the elastic-SP rung:
            # a same-degree re-factorization such as TP4 -> SP2xTP2); a
            # ScaleDown has none, and a bare degree is pure TP
            n_steps = eng.transform(act.tp_to,
                                    layout=getattr(act, "layout", None))
        self.actions.append(act)
        self.n_transforms += 1
        self._last_transform_step[eng.iid] = self.steps
        self._update_reserve()
        assert n_steps > 0 or act.tp_to == eng.tp or act.donor_devices, act
        return True

    def _merge(self, act: ScaleUp, eng: Engine) -> Optional[int]:
        """Cross-instance merge (Fig. 3): park the donors, lend their
        workers to ``eng``, move the donors' live KV into its grown pool,
        then transform across the widened assembly.  Returns the
        session's step count, or None if preconditions fail."""
        donors = [self._engine(i) for i in act.donor_iids]
        if eng.transforming or eng.parked or eng.tp != 1:
            return None
        if any(d.transforming or d.parked or d.tp != 1 for d in donors):
            return None
        n_inflight = sum(1 for d in donors for s in d.slots
                         if s is not None)
        if n_inflight > eng.slots.count(None):
            return None
        assert all(d.seq_quantum == eng.seq_quantum for d in donors), (
            "merging requires uniform per-worker admission quanta")
        exported = []
        adopted: List[Worker] = []
        for d in donors:
            # the donor's queue goes back to the router, at its head
            self.waiting[:0] = d.waiting
            d.waiting = []
            exported += d.export_active()
            workers = d.park()
            loan = self.partition.lend(d.iid, eng.iid, workers, whole=True)
            self.partition.park(d.iid)
            self.partition.adopt(eng.iid, loan)
            adopted += workers
        eng.adopt_devices(adopted)
        slots = []
        for req, sub, progress in exported:
            eng.import_request(req, sub, progress=progress)
            slots.append((req.rid, req.slot))
        del exported
        self.merge_log.append({"iid": eng.iid, "donors": act.donor_iids,
                               "step": self.steps, "slots": slots})
        return eng.transform(act.tp_to)

    def _merge_partial(self, act: ScaleUp, eng: Engine) -> Optional[int]:
        """Partial merge (LoongServe-style fractional elasticity): each
        donor sheds ``act.donor_devices`` of its workers in place, onto
        the workers it keeps, at the largest degree they carry: it keeps
        serving, nothing parks and no KV is exported.  The target widens
        onto the loaned workers once every donor has landed
        (``_advance_partials``).  Returns the donors' summed session
        steps (0 for same-degree moves), or None when preconditions fail
        (nothing mutated)."""
        donors = [self._engine(i) for i in act.donor_iids]
        if eng.transforming or eng.parked or eng.tp != 1 \
                or eng.awaiting_devices:
            return None
        if any(d.transforming or d.parked or d is eng
               or d.awaiting_devices for d in donors):
            return None
        if any(n <= 0 or n >= d.W
               for d, n in zip(donors, act.donor_devices)):
            return None        # a donor keeps at least one worker
        assert all(d.seq_quantum == eng.seq_quantum for d in donors), (
            "partial merges require uniform per-worker admission quanta")
        n_steps = 0
        loans: List[Loan] = []
        for d, n in zip(donors, act.donor_devices):
            keep = list(d.devices[:d.W - n])
            lent = list(d.devices[d.W - n:])
            new_tp = max(t for t in range(1, min(d.tp, len(keep)) + 1)
                         if len(keep) % t == 0)
            n_steps += d.transform(new_tp, devices=keep)
            loans.append(self.partition.lend(d.iid, eng.iid, lent,
                                             whole=False))
            self._last_transform_step[d.iid] = self.steps
        eng.awaiting_devices = True
        self._pending_partials.append(
            {"iid": eng.iid, "tp_to": act.tp_to, "loans": loans,
             "donors": [d.iid for d in donors]})
        return n_steps

    def _advance_partials(self) -> None:
        """Second half of a partial merge: once every donor's move has
        landed (the loaned workers hold nothing of the donor), the target
        adopts them and widens across the grown assembly, serving its
        own work throughout."""
        for p in list(self._pending_partials):
            donors = [self._engine(i) for i in p["donors"]]
            eng = self._engine(p["iid"])
            if any(d.transforming for d in donors) or eng.transforming:
                continue
            self._pending_partials.remove(p)
            eng.adopt_devices([w for loan in p["loans"]
                               for w in loan.devices])
            for loan in p["loans"]:
                self.partition.adopt(eng.iid, loan)
            eng.transform(p["tp_to"])
            eng.awaiting_devices = False
            self.partial_merges += 1
            self._last_transform_step[eng.iid] = self.steps
            self._update_reserve()

    def _execute_spill(self, req: ServeRequest, act: Spill) -> bool:
        """Rung 1 of the capacity ladder: serve a request above its
        guest's ceiling with NO transformation: the host engine reserves
        whole free slots for the overflow pages and the guest serves the
        request on an extended view of both pools.  Returns False
        (nothing mutated) when the host cannot grant the reservation;
        the caller falls back to a merge."""
        self._refuse_live_change(act)
        guest = self._engine(act.iid)
        host = self._engine(act.host_iid)
        if guest is host or guest.transforming or guest.parked \
                or host.transforming or host.parked:
            return False
        if guest._free_slot() is None:
            return False
        pt = guest.page_tokens
        n_pages = -(-max(req.total_tokens - guest._local_page_cap(), 1)
                    // pt)
        hosting = host.host_spilled(n_pages)
        if hosting is None:
            return False
        guest.admit_spilled(req, host, hosting)
        self.partition.open_spill(guest.iid, host.iid, req.rid,
                                  hosting["pages"], hosting["slots"],
                                  handle=hosting["handle"])
        self.actions.append(act)
        self.spill_pages += -(-act.tokens // pt)
        self._update_reserve()
        return True

    def _finalize_spills(self) -> None:
        """Close spill regions whose request has finished (the engines
        already freed the slots and released the hosting reservation)."""
        done = {r.rid for r in self.requests if r.finished}
        for region_id, region in list(self.partition.spills().items()):
            if region.rid in done:
                self.partition.close_spill(region_id)

    def _split(self, act: ScaleDown, eng: Engine) -> int:
        """Undo a merge: transform back onto the engine's home workers;
        the loans are returned and the donors revived once the session
        drains (``_finalize_releases``)."""
        assert act.tp_to == 1, "merged engines decompose fully (Alg 2)"
        n_steps = eng.transform(act.tp_to, devices=eng.home_devices)
        self._releasing.add(eng.iid)
        return n_steps

    def _finalize_releases(self) -> None:
        """Second half of a split: once the session has drained (the
        engine's tensors live on its home workers only), return each
        loan: a parked whole-engine donor revives from the split engine's
        replica, a partial donor (which never stopped serving) widens
        back onto its returned workers at its degree."""
        for iid in list(self._releasing):
            eng = self._engine(iid)
            if eng.transforming:
                continue
            self._releasing.discard(iid)
            by_lender: Dict[int, list] = {}
            for loan in self.partition.loans_to(iid):
                by_lender.setdefault(loan.lender, []).append(loan)
            for lender_iid, loans in by_lender.items():
                workers = [w for ln in loans
                           for w in self.partition.return_loan(ln)]
                donor = self._engine(lender_iid)
                if any(ln.whole for ln in loans):
                    self.partition.revive(lender_iid)
                    donor.revive(workers, eng)
                else:
                    donor.transform(donor.tp,
                                    devices=list(donor.devices) + workers)
                self._last_transform_step[lender_iid] = self.steps
            self._update_reserve()

    # ------------------------------------------------------------------
    def _any_long_waiting(self) -> bool:
        cap1 = max(e.max_seq_at(1) for e in self._active_engines())
        return any(self.scheduler.is_long(r.total_tokens)
                   or r.total_tokens > cap1 for r in self.waiting)

    def step(self) -> Dict[str, int]:
        """One control-plane iteration: retry routing, run Alg 2, one
        engine iteration each (a transforming engine executes one §4.3
        schedule step around its decode), then finalize any drained
        splits (return the loans, revive the donors)."""
        self.scheduler.observe_time(self._clock())
        # FCFS retry of the router queue (pop before placing: a merge
        # inside _place prepends the donors' queues to self.waiting)
        while self.waiting:
            req = self.waiting.pop(0)
            if not self._place(req):
                self.waiting.insert(0, req)
                break
        # Alg 2 over dwell-gated, non-transforming instances (spill
        # participants cannot transform while their regions are open)
        eligible = [
            e for e in self._active_engines()
            if e.tp > 1 and not e.transforming
            and not e._spills and not e._hosted
            and not e.awaiting_devices
            and self.steps - self._last_transform_step[e.iid]
            >= self.dwell_steps]
        for act in self.scheduler.schedule_parallelism(
                eligible, self._any_long_waiting()):
            self._execute(act)
        # the elastic-SP layout scan (opt-in: SchedulerConfig.layouts):
        # a wide engine outside a transform may re-factorize its degree
        # to the layout that wins its current workload mix
        lay_eligible = [
            e for e in self._active_engines()
            if e.tp > 1 and not e.transforming
            and not e._spills and not e._hosted
            and not e.awaiting_devices]
        for act in self.scheduler.decide_layout(lay_eligible):
            self._execute(act)
        emitted = active = queued = 0
        for e in self._active_engines():
            # stall detection from control-plane-visible state before the
            # step, not from the engine's own report
            cross = e.transforming and e._session_cross
            decoding = (sum(1 for r in e.slots if r is not None
                            and r.state == State.DECODE) if cross else 0)
            s = e.step()
            emitted += s["emitted"]
            active += s["active"]
            queued += s["waiting"]
            if cross:
                self.session_steps += 1
                self.tokens_during_session += s["emitted"]
                if decoding > 0 and s.get("decode_emitted", 0) == 0:
                    self.stall_steps += 1
            if e.transforming:
                # dwell counts from the END of a transformation
                self._last_transform_step[e.iid] = self.steps
        self._advance_partials()
        self._finalize_releases()
        self._finalize_spills()
        self._feed_measured_costs()
        self.total_tokens += emitted
        self.steps += 1
        return {"active": active, "emitted": emitted,
                "engine_waiting": queued, "router_waiting":
                len(self.waiting),
                "transforming": sum(e.transforming for e in self.engines),
                "parked": sum(e.parked for e in self.engines)}

    def _feed_measured_costs(self) -> None:
        """Stream every new transform and spill record into an attached
        cost model's ``observe_transform`` (``core.calibrate.
        CalibratedCostModel``'s measured EWMA; a no-op without one)."""
        cm = getattr(self.scheduler, "cost_model", None)
        if cm is None or not hasattr(cm, "observe_transform"):
            return
        for e in self.engines:
            t_fed, s_fed = self._cost_fed.get(e.iid, (0, 0))
            for rec in e.transform_log[t_fed:]:
                cm.observe_transform(rec)
            for rec in e.spill_log[s_fed:]:
                cm.observe_transform(rec)
            self._cost_fed[e.iid] = (len(e.transform_log),
                                     len(e.spill_log))

    # ------------------------------------------------------------------
    @property
    def idle(self) -> bool:
        return (not self.waiting and not self._releasing
                and not self._pending_partials
                and all(not e.transforming and not e.waiting
                        and all(s is None for s in e.slots)
                        for e in self.engines))

    def run(self, requests: Sequence[ServeRequest] = (),
            max_steps: int = 10_000,
            drain_steps: Optional[int] = None) -> Dict[str, float]:
        """Submit ``requests`` and step until the cluster drains, then
        through a quiet window (default one dwell period) so Alg 2 can
        return scaled-up instances to TP1."""
        for r in requests:
            self.submit(r)
        drain = self.dwell_steps + 2 if drain_steps is None else drain_steps
        quiet = 0
        for _ in range(max_steps):
            if self.idle:
                if quiet >= drain:
                    return self.metrics()
                quiet += 1
            else:
                quiet = 0
            self.step()
        raise RuntimeError("cluster did not drain")

    def metrics(self) -> Dict[str, float]:
        """``serving.metrics.METRIC_KEYS``, key for key; the transform
        columns aggregate every engine's ``transform_log``."""
        elapsed = 0.0 if self.t_start is None else (
            self._clock() - self.t_start)
        logs = [t for e in self.engines for t in e.transform_log]
        return summarize(self.requests, elapsed, self.total_tokens,
                         self.n_transforms, transforms=logs,
                         spill_pages=self.spill_pages,
                         partial_merges=self.partial_merges)


class LiveReplayPlane:
    """Adapts a live ``ClusterEngine`` to the ``core.events.replay`` plane
    protocol: each trace ``Request`` becomes a token-level
    ``ServeRequest`` (seeded random prompt ids of its ``in_len``) at its
    arrival event, and one ``ClusterEngine.step`` serves each
    ``advance``.  Build the cluster with the replay's ``VirtualClock`` as
    its ``clock``, so request times land on the replay's axis."""

    def __init__(self, cluster: ClusterEngine, seed: int = 0):
        self.cluster = cluster
        self._rng = np.random.default_rng(seed)
        self.served: Dict[int, ServeRequest] = {}

    def submit(self, trace_req, now: float) -> None:
        prompt = self._rng.integers(0, self.cluster.cfg.vocab_size,
                                    size=trace_req.in_len).tolist()
        sr = ServeRequest(rid=trace_req.rid, prompt=prompt,
                          max_new_tokens=trace_req.out_len,
                          slo=getattr(trace_req, "slo", None))
        self.served[trace_req.rid] = sr
        self.cluster.submit(sr)

    def advance(self, now: float, dt: float) -> None:
        self.cluster.step()

    @property
    def idle(self) -> bool:
        return self.cluster.idle
