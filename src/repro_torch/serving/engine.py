"""Continuous-batching serving engine over the paged KV pool — the
single-device subset of ``repro.serving.engine``.

Slot-based continuous batching: the decode batch has ``max_batch``
fixed slots; a request occupies one slot from prefill until EOS or its
token limit, then the slot is reusable.  Every layer's KV pool is
slot-partitioned (slot s owns pages ``[s*mps, (s+1)*mps)``).

Prefill is chunked and policy-driven (``core.scheduler.PrefillPolicy``):
each step admits at most one waiting request and spends up to the
policy's token budget advancing partially-prefilled slots by
page-aligned chunks (``Model.prefill_chunk`` -> the chunk-prefill
kernel).  A prompt that is one chunk runs whole (``Model.prefill`` ->
the flash kernel).  Decode runs every active slot in one batched step
(``Model.decode_step`` -> the paged-decode kernel over the pool in
place).  Greedy sampling is ``argmax``.

Where the reference extracts a batch-1 copy of a slot's cache and adopts
it back, the port computes on in-place slot VIEWS of the engine's
caches (``paged.pool.slot_view``): the same bytes land in the pool
without a copy.

Two placements, as in the reference:

  * one device (``devices=None``, the default): one ``Model`` and one
    cache per layer;
  * ``devices=[...]``: the engine spreads over W workers
    (``launch.mesh.InstanceMesh``; the entries may repeat, e.g. two
    workers on one card) starting at TP1 x W, its layers held per worker
    (``core.instance.WorkerLayer``), with the MLP on the padded FFN
    kernel.  ``transform(tp_to)`` opens a §4.3 session to any degree
    dividing the worker count (TP1 x 4 -> TP2 x 2 -> TP4 and back: the
    ``(rep, tp)`` layouts of ``core.instance``), and each ``step()``
    executes one schedule step around its decode iteration, so page
    migration (gather/scatter kernels and the exchange) interleaves
    with serving; ``transform(tp, devices=...)`` at the same degree
    moves the engine onto other workers in one synchronous re-shard.
    Replicated kv heads (fewer kv heads than workers) are laid out as
    the reference's GQA rule gives them.  ``transform(tp_to,
    layout=Layout(sp, tp))`` reaches the sequence-parallel layouts
    (``par_layout``; TP4 <-> SP2xTP2 is a same-degree session that
    serves throughout): each sp shard holds a slice of every slot's
    pages, and decode and chunk attention run on the kernels' partial
    entries, exchanged and combined inside each sp group.

The capacity contract is the reference's (``max_seq_at``): ``seq_quantum``
is the per-worker admission share, ``max_seq_at(tp) = seq_quantum * tp``
and the physical per-slot pool ``max_seq_alloc`` follows the TP degree.

Engines with workers also take part in cross-instance merges, driven by
``serving.cluster.ClusterEngine`` (the reference's merge lifecycle):
``export_active`` -> ``park`` on a donor, ``adopt_devices`` ->
``import_request`` -> ``transform(W')`` on the target, and on a split
``transform(1, devices=home_devices)`` then ``revive`` on the donor.
Workers are ``launch.mesh.Worker`` identities, so an engine's home and
adopted workers may share one card.  They also take part in KV spill
(rung 1 of the capacity ladder): a host reserves whole free slots for
a guest's overflow pages (``host_spilled``), and the guest serves the
request on an extended view of its slot and the hosted pages
(``admit_spilled``).

A recurrent (RGLRU, MLSTM, SLSTM) layer keeps each slot's state in a
``RecState`` instead of pages; an MLSTM or SLSTM layer has no MLP, so a
worker engine places, relays out and moves none for it.  A chunked
prefill carries the state from chunk to chunk in its progress record
(``"rec"``, the reference's carry): a fresh state at the first chunk,
the last chunk's state restored over the batched decode's filler
before each later one, as the reference's
``_sanitize_tree`` does; an export mid-prefill takes the carry along.
Spill never moves recurrent state (the slot's own rows serve the
extended view).

A MoE model needs nothing of its own here: each prefill call routes its
one request's tokens together and each batched decode routes every
slot (idle slots' filler rows included) in slot order, as the
reference's calls do; an engine with workers routes over that global
order across its replicas (``models.model.moe_workers``).  A spilled
request's extended calls (its batch-1 decode on the extended view, its
chunks past the local ceiling) route their own rows alone, as the
reference's spill path, which has no MoE branch, does.

An encoder-decoder (whisper) or a vision model (phi-3-vision) serves
with its request's own stub frontend input (``ServeRequest.frames`` /
``patches``), on one device or on workers at TP1 x W, whole-prompt
only (``_can_chunk``, as the reference's engine; ``PrefillPolicy``
chunks are ignored).  The whole prefill runs the frames through the
encoder into the slot's rows of a dense cross-attention cache
(``models.model.CrossKV``: ``self.cross``, one a worker with workers),
which every later decode step reads, and a slot reused by another
request gets that request's; patches take the context's first
positions, so admission and the slot ceiling count them
(``ServeRequest.context_len``).  The reference's engine passes only the
tokens to its whole prefill, so its whisper raises ``KeyError:
'frames'`` and its phi-3-vision serves text only; the port passes the
reference model's own inputs (ROADMAP queue 3).  Neither model changes
degree live, moves a slot to another engine or spills: the reference's
per-layer paths refuse them (``live_change_refusal``), and so does
``transform`` (and the cluster's merge and spill).

The reference's other serving modes: ``transform_attn=False`` keeps
every attention replica whole on each worker at every degree (the
paper's placement: only the MLP and the KV move), and
``layout="page_friendly"`` or ``"raw"`` stores a one-device engine's
pools token-first (each attention kernel runs on a canonical copy).

``Engine(cfg)`` runs on the card.  Without a GPU it raises unless the
caller asks for ``device="cpu"`` (or ``devices=["cpu"] * W``), where
every kernel call runs its plain PyTorch version.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import instance as I
from repro_torch.core import kv_transform as KT
from repro_torch.core import transform_engine as TE
from repro_torch.core import weight_transform as WT
from repro_torch.core.costmodel import kv_bytes_per_token
from repro_torch.core.padding import PaddingPlan, make_plan
from repro_torch.core.scheduler import PrefillPolicy
from repro_torch.launch.mesh import (InstanceMesh, Layout, Worker,
                                     resolve_device, workers_of)
from repro_torch.models import model as M
from repro_torch.models.blocks import (ATTENTION_KINDS, init_block_cache,
                                      slot_pages)
from repro_torch.paged import pool as pp
from repro_torch.paged.layout import CANONICAL, LAYOUTS
from repro_torch.paged.recurrent import RecState
from repro_torch.serving.request import ServeRequest, State


def live_change_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why an engine of ``cfg`` keeps its degree and its slots (no
    transform, merge, slot export or KV spill), or None: the reference's
    per-layer paths refuse encoder and vision models
    (``repro/models/model.py:551-553``, ``:668-670``)."""
    if cfg.has_frontend:
        return "per-layer transformation does not cover encoder/vision yet"
    return None


class Engine:
    _ids = itertools.count()

    def __init__(self, cfg: ModelConfig, params: Optional[M.Model] = None,
                 max_batch: int = 4, max_seq: int = 256,
                 page_tokens: int = 16, seed: int = 0,
                 prefill_policy: Optional[PrefillPolicy] = None,
                 device=None, devices: Optional[List] = None,
                 iid: Optional[int] = None,
                 plan: Optional[PaddingPlan] = None, clock=None,
                 layout: str = "header_centric",
                 transform_attn: bool = True):
        """``params`` is a ``Model`` (or, for a cluster's engines, another
        engine at TP1 whose replica is copied); without one the engine
        builds random weights from ``seed``.

        ``layout`` is the KV pools' storage order (``paged.layout``, the
        paper's Table 2): ``header_centric`` (the kernels' canonical
        order), or on one device ``page_friendly`` or ``raw``, whose
        pools each attention call copies into the canonical order
        around its kernel (``models.blocks``).  An engine with workers
        refuses a token-first layout, as the reference's does.
        ``transform_attn=False`` keeps every attention replica whole on
        every worker at each degree (the reference's faithful mode, the
        paper's own placement: ``core.instance``): a transform moves the
        MLP and the KV only, and copies attention weights only to a
        merge's adopted workers.

        One device (``devices=None``): ``params`` lives on ``device``.
        W workers (``devices=[...]``: devices, or ``launch.mesh.Worker``
        identities of a cluster's pool): ``params`` is planned for
        ``plan`` (default ``make_plan(cfg, W, mode="page")``; a cluster
        whose engines may merge passes one for the whole pool's width)
        with its MLP in that plan's per-shard Eq. 2 layout
        (``models.convert.params_from_jax`` gives that); worker 0 takes
        its tensors, every other worker a copy, and the engine never
        writes a weight in place.

        ``clock`` stamps request times (default the wall clock; a
        cluster passes its own, a replay a ``core.events.VirtualClock``).
        Transform measurements stay on the wall clock."""
        self.cfg = cfg
        self.layout = layout
        self.transform_attn = transform_attn
        if layout not in LAYOUTS:
            raise ValueError(f"unknown KV layout {layout!r}: one of "
                             f"{sorted(LAYOUTS)}")
        if devices is not None and layout != CANONICAL:
            raise ValueError(f"layout {layout!r}: mesh placement shards "
                             "the canonical header-centric pool")
        self._clock = clock if clock is not None else time.monotonic
        self.iid = iid if iid is not None else next(Engine._ids)
        self.max_batch = max_batch
        self.max_seq_alloc = max_seq
        self.page_tokens = page_tokens
        self.tp = 1
        # the full (sp, tp) factorization of the degree ``tp``
        self.par_layout = Layout(1, 1)
        self.tp_pending: Optional[int] = None
        self.mesh = None
        self._session: Optional[TE.TransformSession] = None
        self._session_t0 = 0.0
        self._session_cross = False
        self._pending_devices: Optional[List[Worker]] = None
        self.transform_reports: List[TE.StepReport] = []
        self.transform_log: List[Dict] = []
        # same-degree moves onto other workers (no session; kept apart
        # from transform_log, which the metrics and cost model read, as
        # the reference records none)
        self.move_log: List[Dict] = []
        # -- cross-instance merge lifecycle (serving.cluster) -------------
        # reserved: earmarked as the next scale-up candidate (Alg 2 line
        # 9)
        self.reserved = False
        self.parked = False
        self.adopted_devices: List[Worker] = []
        # a partial-merge target whose loaned workers are still leaving
        # their donors (serving.cluster): committed, not transformable
        self.awaiting_devices = False
        if devices is None:
            self.devices = None
            self.W = 1
            self.device = resolve_device(device)
            self.plan = plan or make_plan(cfg, 1)
            if params is None:
                params = M.build(cfg, self.plan, seed, device=self.device)
            if params.device != self.device:
                raise ValueError(f"params live on {params.device}, the "
                                 f"engine on {self.device}")
            self.model = params
            self.caches: List[pp.PagedState] = self.model.init_decode_caches(
                max_batch, max_seq, page_tokens, layout=layout)
            self.cross = self.model.init_cross_cache(max_batch)
        else:
            if device is not None:
                raise ValueError("pass device= or devices=, not both")
            self._init_workers(params, workers_of(devices), seed, plan)
        self.home_devices = None if devices is None else list(self.devices)
        self.seq_quantum = max_seq // self.W
        # temperature sampling only: not comparable with the reference,
        # which samples with jax.random
        self.gen = torch.Generator(device="cpu")
        self.gen.manual_seed(seed)
        self.slots: List[Optional[ServeRequest]] = [None] * max_batch
        self.waiting: List[ServeRequest] = []
        self.prefill_policy = prefill_policy or PrefillPolicy()
        # chunk continuation needs causal caches: encoder / vision models
        # keep whole-prompt prefill, as the reference's engine does
        self._can_chunk = not cfg.has_frontend
        # slot -> {"req", "chunks", "ci", "done"}: the page-aligned chunk
        # plan and its progress (the KV lives in the slot's pool pages)
        self._prefilling: Dict[int, Dict] = {}
        self._prefill_deferred = 0   # consecutive decode-priority defers
        # -- KV spill (Infinite-LLM-style distributed pool) -------------
        # guest side: slot -> {"req", "host", "hosting", "ext_tokens"};
        # plans keyed by rid until the request admits into a slot.  Host
        # side: handle -> {"slots", "pages"}, whole local slots reserved
        # to carry a neighbour's overflow pages.
        self._spills: Dict[int, Dict] = {}
        self._spill_plans: Dict[int, Dict] = {}
        self._hosted: Dict[int, Dict] = {}
        self._hosted_ids = itertools.count()
        self.spill_log: List[Dict] = []

    def _init_workers(self, params: Optional[M.Model], workers: List[Worker],
                      seed: int, plan: Optional[PaddingPlan]) -> None:
        """Spread the engine over the workers at TP1 x W."""
        cfg, W = self.cfg, len(workers)
        assert self.max_seq_alloc % W == 0, (
            f"max_seq={self.max_seq_alloc} must divide over the {W} "
            "workers (per-worker admission quantum must be whole)")
        assert self.max_seq_alloc % self.page_tokens == 0, (
            f"max_seq={self.max_seq_alloc} must be page-aligned "
            f"(page_tokens={self.page_tokens}) so pool resizes stay pure "
            "page-range copies")
        assert self.max_batch % W == 0, (
            f"max_batch={self.max_batch} must be divisible by the worker "
            f"count {W}: slots split over the workers at TP1")
        self.devices, self.W, self.device = workers, W, workers[0].device
        self.plan = plan or make_plan(cfg, W, mode="page")
        assert self.plan.max_tp % W == 0, (
            f"a plan for {self.plan.max_tp} shards cannot split over {W} "
            "workers")
        if params is None:
            params = M.build(cfg, self.plan, seed, device=self.device)
            for blk in params.layers:
                WT.relayout_block_mlp(blk.mlp, cfg.d_ff, self.plan.max_tp,
                                      cfg.activation)
        self.mesh = InstanceMesh(workers, 1)
        self.model = self.caches = None
        self._place(params)

    def _place(self, source: Union[M.Model, "Engine"]) -> None:
        """Lay the engine out at TP1 x W on ``self.mesh``: every worker a
        replica of ``source``'s weights and an empty pool at
        ``max_seq_alloc`` tokens a slot.  ``source`` is a ``Model`` (worker
        0 takes its tensors, every other worker a copy) or another engine
        at TP1, whose worker-0 replica every worker copies (a revived
        donor: weights are identical cluster-wide)."""
        if isinstance(source, Engine):
            assert source.tp == 1 and not source.transforming, (
                "a replica source must be at TP1 with no session open")
            blocks = [(l.kind, l.ln1[0], l.ln2[0], l.attn[0], l.mlp[0])
                      for l in source.layers]
            static, share = source.static[0], False
        else:
            blocks = [b.parts() for b in source.layers]
            static, share = source.static(), True

        self.layers, self.static = I.place_replicas(
            blocks, static, self.mesh, share, self.max_batch,
            lambda kind, rows, dev: init_block_cache(
                kind, self.cfg, self.plan, rows, self.max_seq_alloc,
                self.page_tokens, device=dev),
            whole_attn=not self.transform_attn)
        # an encoder-decoder's cross memory: each worker's own slots
        self.cross = None if self.cfg.encoder is None else [
            M.CrossKV.make(self.cfg, self.plan, self.max_batch // self.W,
                           device=dev) for dev in self.mesh.devices]

    def _slot_pages(self, kind: str) -> int:
        """Pages a slot of a layer of ``kind`` holds at the current
        allocation (``models.blocks.slot_pages``, the reference's
        ``init_block_cache``)."""
        return slot_pages(kind, self.cfg, self.max_seq_alloc,
                          self.page_tokens)

    def _min_chunk_cap(self) -> int:
        """Largest chunk one prefill call may carry: the smallest
        attention-cache capacity across the model's layers (a ring's
        page-rounded window; ``max_seq_alloc`` for full attention)."""
        caps = [self._slot_pages(k) * self.page_tokens
                for k in set(self.cfg.pattern) if k in ATTENTION_KINDS]
        return min(caps) if caps else self.max_seq_alloc

    # -- the capacity contract (InstanceView accessors) ---------------------
    @property
    def max_tp(self) -> int:
        """Largest TP degree this engine can transform to in place."""
        return self.W

    @property
    def width(self) -> int:
        """Workers this engine spans."""
        return self.W

    def max_seq_at(self, tp: int) -> int:
        """Admission ceiling (tokens per request) at TP degree ``tp``:
        ``seq_quantum * tp``, the per-worker share frozen at construction
        times the degree.  ``max_seq_alloc``, the physical per-slot pool,
        always backs the active degree (``check_capacity_invariant``).
        A single-device engine has no transformable axis and exposes its
        allocation at any degree."""
        assert tp >= 1, tp
        if self.devices is None:
            return self.max_seq_alloc
        return self.seq_quantum * tp

    def max_seq(self) -> int:
        """Admission ceiling at the policy degree: while a scale-up is in
        flight the engine admits at its target capacity."""
        return self.max_seq_at(self.tp_pending or self.tp)

    def check_capacity_invariant(self) -> None:
        """Physical backs policy: ``seq_quantum * (tp_pending or tp) <=
        max_seq_alloc <= seq_quantum * W``."""
        if self.devices is None or self.parked:
            return
        assert (self.seq_quantum * (self.tp_pending or self.tp)
                <= self.max_seq_alloc
                <= self.seq_quantum * self.W), (
            self.max_seq_alloc, self.seq_quantum, self.tp,
            self.tp_pending, self.W)
        assert (self.tp_pending or self.tp) <= self.W, (
            self.tp, self.tp_pending, self.W)
        assert self.max_seq() <= self.max_seq_alloc

    def kv_capacity_tokens(self) -> int:
        """Slot-partitioned pools: every slot owns max_seq() tokens."""
        return self.max_batch * self.max_seq()

    def kv_used_tokens(self) -> int:
        used = sum(r.context_len for r in self.slots if r is not None)
        # whole slots reserved to host a neighbour's spilled pages are
        # consumed capacity as far as admission is concerned
        used += sum(len(h["slots"]) for h in self._hosted.values()) \
            * self.max_seq()
        return used + sum(r.n_patches + len(r.prompt) for r in self.waiting)

    def kv_used_fraction(self) -> float:
        return self.kv_used_tokens() / max(self.kv_capacity_tokens(), 1)

    def kv_free_tokens(self) -> int:
        return max(0, self.kv_capacity_tokens() - self.kv_used_tokens())

    def load(self) -> float:
        # KV pressure + queue pressure, as the simulator's load
        return self.kv_used_fraction() + 0.05 * len(self.waiting)

    def has_long_request(self) -> bool:
        """A request is long if its final context would not fit this
        engine at TP1."""
        cap1 = self.max_seq_at(1)
        live = [r for r in self.slots if r is not None] + self.waiting
        return any(r.total_tokens > cap1 for r in live)

    # -- requests -----------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        self._check_inputs(req)
        self.waiting.append(req)

    def _check_inputs(self, req: ServeRequest) -> None:
        """A request carries the frontend input its model reads: frames
        (F, d) for an encoder-decoder, optional patches (P, d) for a
        vision model, neither for any other."""
        cfg, d = self.cfg, self.cfg.d_model
        if cfg.encoder is not None:
            want = (cfg.encoder.num_frames, d)
            if req.frames is None or tuple(req.frames.shape) != want:
                raise ValueError(
                    f"{cfg.name} is an encoder-decoder: request {req.rid} "
                    f"needs frames of shape {want}, not "
                    f"{None if req.frames is None else tuple(req.frames.shape)}")
        elif req.frames is not None:
            raise ValueError(f"{cfg.name} has no encoder: request "
                             f"{req.rid} carries frames")
        if req.patches is not None and (
                cfg.vision is None or req.patches.ndim != 2
                or req.patches.shape[1] != d):
            takes = ("no patches" if cfg.vision is None
                     else f"patches of shape (P, {d})")
            raise ValueError(f"{cfg.name} takes {takes}: request "
                             f"{req.rid} carries patches of shape "
                             f"{tuple(req.patches.shape)}")

    def _refuse_live_change(self, what: str) -> None:
        reason = live_change_refusal(self.cfg)
        if reason is not None:
            raise NotImplementedError(f"{self.cfg.name}: {what}: {reason}")

    def _free_slot(self) -> Optional[int]:
        hosted = self._hosted_slots()
        for i, s in enumerate(self.slots):
            if s is None and i not in hosted:
                return i
        return None

    def _hosted_slots(self) -> set:
        return {s for h in self._hosted.values() for s in h["slots"]}

    def _n_decoding(self) -> int:
        return sum(1 for r in self.slots
                   if r is not None and r.state == State.DECODE)

    def _admittable_now(self, req: ServeRequest) -> bool:
        """While capacity is on its way (a partial merge's loaned workers
        not yet adopted, or a transform that grows the ceiling in
        flight), a request longer than the current pool waits in the
        queue instead of admitting into a slot it would overflow.  A
        spilled request carries its own extension."""
        return not (req.total_tokens > self.max_seq_alloc
                    and req.rid not in self._spill_plans
                    and (self.awaiting_devices
                         or self.tp_pending is not None))

    # -- slot views (the reference's extract / adopt) -----------------------
    def _slot_caches(self, slot: int) -> List:
        """Batch-1 in-place views of ``slot`` in every layer's cache (on
        every worker that holds it, for an engine with workers; at TP1
        one a layer): pages, or a recurrent layer's state rows."""
        if self.mesh is None:
            return [c.slot(slot) for c in self.caches]
        rows = M.RowSet([slot], self.max_batch)
        return [v for layer in self.layers
                for v in (rows.views(layer, w)
                          for w in range(layer.mesh.W))
                if v is not None]

    # -- chunked prefill ----------------------------------------------------
    def _begin_prefill(self, req: ServeRequest, slot: int) -> None:
        req.state = State.PREFILL
        req.slot = slot
        self.slots[slot] = req
        plan = self._spill_plans.pop(req.rid, None)
        if plan is not None:
            self._spills[slot] = {"req": req, **plan}
        chunks = (self.prefill_policy.chunk_sizes(len(req.prompt),
                                                  self.page_tokens)
                  if self._can_chunk else [len(req.prompt)])
        if (plan is not None and len(chunks) == 1
                and chunks[0] > self._min_chunk_cap()):
            # a spilled prompt longer than the local pool MUST chunk: the
            # chunk path computes on the extended (local + hosted) view
            # once the cursor crosses the local ceiling
            cap = self._min_chunk_cap()
            c = chunks[0]
            chunks = [cap] * (c // cap) + ([c % cap] if c % cap else [])
        if len(chunks) > 1:
            # ring-cache models: no chunk may exceed the smallest
            # attention capacity (a page multiple, so the page-boundary
            # chunking invariant survives the split)
            cap = self._min_chunk_cap()
            chunks = [s for c in chunks
                      for s in ([cap] * (c // cap) + ([c % cap] if c % cap
                                                      else []))]
        self._prefilling[slot] = {"req": req, "chunks": chunks, "ci": 0,
                                  "done": 0}

    def _prefill_step(self) -> int:
        """Admit at most one waiting request (FCFS over the admittable
        queue), then spend the policy's token quota advancing
        partially-prefilled slots in its service order.  Prefills keep
        running during transform sessions.  Returns tokens emitted (a
        finished prefill emits the first token)."""
        if self.waiting:
            slot = self._free_slot()
            if slot is not None:
                for i, req in enumerate(self.waiting):
                    if self._admittable_now(req):
                        self._begin_prefill(self.waiting.pop(i), slot)
                        break
        if not self._prefilling:
            self._prefill_deferred = 0
            return 0
        quota = self.prefill_policy.step_quota(self._n_decoding(),
                                               self._prefill_deferred)
        if quota <= 0:
            self._prefill_deferred += 1
            return 0
        self._prefill_deferred = 0
        emitted = 0
        spent = 0.0

        def remaining(slot: int) -> int:
            p = self._prefilling[slot]
            return len(p["req"].prompt) - p["done"]

        for slot in self.prefill_policy.service_order(
                list(self._prefilling), remaining):
            while slot in self._prefilling:
                prog = self._prefilling[slot]
                size = prog["chunks"][prog["ci"]]
                if spent > 0 and spent + size > quota:
                    return emitted      # budget exhausted this step
                emitted += self._run_chunk(slot)
                spent += size
        return emitted

    def _run_chunk(self, slot: int) -> int:
        """Advance the slot's prefill by one chunk; returns 1 when the
        prefill completed (first token emitted), else 0.  A one-chunk
        plan outside a transform session runs whole (flash kernel);
        mid-session it runs as one first chunk, as in the reference."""
        prog = self._prefilling[slot]
        req = prog["req"]
        if req.t_prefill_start is None:
            req.t_prefill_start = self._clock()
        if len(prog["chunks"]) == 1 and self._session is None:
            self._prefill_whole(req, slot)
            del self._prefilling[slot]
            return 1
        start = prog["done"]
        size = prog["chunks"][prog["ci"]]
        tokens = torch.tensor(req.prompt[start:start + size],
                              dtype=torch.long)[None]
        # a spilled slot past the local ceiling computes the chunk on the
        # EXTENDED view (local + hosted pages) and writes it back through
        # ``spill_slot``
        ext = slot in self._spills and start + size > self._local_page_cap()
        views = (self._assemble_spilled(slot) if ext
                 else self._slot_caches(slot))
        self._sanitize_sub(views, start)
        self._restore_carry(slot, prog)
        if self.mesh is None:
            logits = self.model.prefill_chunk(
                tokens.to(self.device),
                torch.full((1,), start, dtype=torch.int32,
                           device=self.device),
                views, first_chunk=start == 0)
        else:
            positions = (start + torch.arange(size, dtype=torch.int32))[None]
            logits = self._walk([slot], tokens, positions, "chunk",
                                first_chunk=start == 0,
                                caches=views if ext else None)[:, None]
        if ext:
            self.spill_slot(slot, views)
        self._save_carry(slot, prog)
        prog["done"] += size
        prog["ci"] += 1
        if prog["done"] >= len(req.prompt):
            del self._prefilling[slot]
            self._finish_prefill(req, slot, logits)
            return 1
        return 0

    def _walk(self, rows: List[int], tokens: torch.Tensor,
              positions: torch.Tensor, mode: str, first_chunk: bool = False,
              caches: Optional[List[pp.PagedState]] = None,
              frames: Optional[torch.Tensor] = None,
              patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One pass of ``rows`` through the per-worker layers (an engine
        with workers); mid-session the decode walk streams the session's
        staged layer groups, and the static weights are the session's
        (a cross-assembly session moves them in its final step).
        ``caches``: a one-row set's per-layer states in place of its
        slot views (a spilled slot's extended view); ``frames`` /
        ``patches``: a whole prompt's frontend input."""
        s = self._session
        hook = s.on_decode_layer if s is not None and mode == "decode" \
            else None
        static, smesh = ((s.static, s.static_mesh) if s is not None
                         else (self.static, self.mesh))
        return M.walk_layers(self.layers, static, self.cfg, self.plan,
                             smesh, M.RowSet(rows, self.max_batch), tokens,
                             positions, mode, first_chunk=first_chunk,
                             on_layer=hook, caches=caches, frames=frames,
                             patches=patches, cross=self.cross)

    def _pin_prefill_cursors(self) -> None:
        """Decode iterations append masked filler for EVERY slot at its
        ``seq_lens`` cursor, mid-prefill slots included.  Re-pinning the
        cursor to ``done`` after each decode confines the filler to the
        one position the next chunk overwrites anyway (left alone, a
        starved slot's filler would ring-wrap into its prefix).  With
        workers, on every worker holding the slot."""
        if not self._prefilling:
            return
        for slot, prog in self._prefilling.items():
            for v in self._slot_caches(slot):
                v.pin_(prog["done"])

    def _slot_rec_views(self, slot: int) -> List[List[RecState]]:
        """The slot's state rows in each recurrent layer: one in-place
        view a worker that holds them (every worker of its replica)."""
        if self.mesh is None:
            return [[c.slot(slot)] for c in self.caches if c.recurrent]
        rows = M.RowSet([slot], self.max_batch)
        return [[v for v in (rows.views(layer, w)
                             for w in range(layer.mesh.W)) if v is not None]
                for layer in self.layers if layer.cache[0].recurrent]

    def _restore_carry(self, slot: int, prog: Dict) -> None:
        """Before a chunk: a fresh recurrent state at the first chunk
        (each leaf at its start value: mLSTM's ``m`` at ``NEG_INF``,
        sLSTM's ``n`` at 1), else the last chunk's carry restored over
        whatever the batched decode's filler left in the slot's rows
        (the reference's ``_sanitize_tree``)."""
        rec = prog.get("rec")
        for i, views in enumerate(self._slot_rec_views(slot)):
            for v in views:
                if prog["done"] == 0 or rec is None:
                    v.fresh_()
                else:
                    v.copy_(rec[i])

    def _save_carry(self, slot: int, prog: Dict) -> None:
        """After a chunk: keep the slot's recurrent state as the carry of
        the next one (one copy a layer)."""
        views = self._slot_rec_views(slot)
        if views:
            prog["rec"] = [v[0].clone() for v in views]

    @staticmethod
    def _sanitize_sub(views: List, done: int) -> None:
        """Prepare a slot's views for the next chunk, in place: keep
        exactly the slots holding real prefix tokens and set the cursor
        to ``done`` (``PagedState.sanitize_``).  Recurrent rows are left
        to the carry (``_restore_carry``)."""
        for v in views:
            v.sanitize_(done)

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        """One token from one row of logits (vocab_padded,)."""
        if temperature <= 0.0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.float().cpu() / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen))

    def _finish_prefill(self, req: ServeRequest, slot: int,
                        logits: torch.Tensor) -> None:
        tok = self._sample(logits[0, -1], req.temperature)
        req.generated.append(tok)
        req.t_first_token = self._clock()
        req.state = State.DECODE
        req.slot = slot
        self.slots[slot] = req
        # the prefill-emitted token counts against the budget too
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
                or req.context_len >= self._slot_ceiling(slot)):
            req.state = State.DONE
            req.t_done = self._clock()
            self.slots[slot] = None

    def _prefill_whole(self, req: ServeRequest, slot: int) -> None:
        """Single-call prefill straight into the slot's pages: every page
        of the slot's range is rewritten, exactly what the reference's
        fresh batch-1 cache + page-range adopt leaves there.  A vision
        request's patches go first; an encoder-decoder request's frames
        fill the slot's cross-attention memory."""
        prompt = torch.tensor(req.prompt, dtype=torch.long)[None]
        frames, patches = (None if a is None
                           else torch.as_tensor(a)[None].to(self.device)
                           for a in (req.frames, req.patches))
        if self.mesh is None:
            logits = self.model.prefill(
                prompt.to(self.device), self._slot_caches(slot),
                frames=frames, patches=patches,
                cross=None if self.cross is None else self.cross.slot(slot))
        else:
            positions = torch.arange(req.n_patches + len(req.prompt),
                                     dtype=torch.int32)[None]
            logits = self._walk([slot], prompt, positions, "seq",
                                frames=frames, patches=patches)[:, None]
        self._finish_prefill(req, slot, logits)

    # -- §4.3 live transformation -------------------------------------------
    def transform(self, tp_to: int, layers_per_step: int = 1,
                  devices: Optional[List[Worker]] = None,
                  layout=None) -> int:
        """Begin a live transformation to degree ``tp_to``, any divisor of
        the target worker count, at the layout ``layout`` (a
        ``launch.mesh.Layout(sp, tp)`` of degree ``tp_to``; default pure
        TP): ``(rep = W/tp_to) x sp x tp`` (a full merge TP1 x W -> TPW', a
        decompose TPW -> TP1 x W', a partial change such as TP1 x 4 -> TP2
        x 2, or a same-degree LAYOUT change such as TP4 -> SP2xTP2, which
        re-partitions weights and pages and leaves the capacity alone).
        Returns the number of schedule steps; each later ``step()``
        executes one of them around its decode iteration, while requests
        keep decoding.

        The target workers are the engine's own (``devices``, after
        ``adopt_devices`` the home ones plus the adopted) or the given
        ``devices`` (a split: the home workers, after which the adopted
        ones are shed).  When they differ from the workers the layers
        sit on, the session crosses assemblies, layer by layer.  The pool
        grows to the target ceiling before the session (memory follows
        the TP degree); the shrink half runs when it lands.  An sp layout
        needs each slot's pages to split evenly over its shards, and
        raises otherwise.

        At the same layout on other workers (a partial-merge donor
        shedding workers, or widening back onto returned ones) there is
        no session: the whole state moves in one synchronous re-shard
        between steps (``_move_workers``), and this returns 0."""
        self._refuse_live_change("transform")
        assert self.mesh is not None, "transform requires devices="
        assert self._session is None, "transformation already in progress"
        assert not self._spills and not self._hosted, (
            "no transforms while KV spill regions are open: a pool resize "
            "would move hosted or overflow pages out from under their "
            "extended views")
        lay = Layout.of(layout if layout is not None else tp_to)
        assert lay.degree == tp_to, (
            f"layout {lay} (degree {lay.degree}) disagrees with "
            f"tp_to={tp_to}")
        target = list(self.devices if devices is None else devices)
        if lay == self.par_layout and target == self.mesh.workers:
            return 0
        assert len(target) % tp_to == 0, (
            f"TP{tp_to} does not divide {len(target)} workers")
        assert self.max_batch % (len(target) // tp_to) == 0, (
            f"max_batch={self.max_batch} must split over the "
            f"{len(target) // tp_to} replicas of {lay}")
        I.check_degree(self.plan, lay)
        alloc = max(self.max_seq_alloc, self.seq_quantum * tp_to)
        if -(-alloc // self.page_tokens) % lay.sp:
            raise ValueError(
                f"{lay}: {-(-alloc // self.page_tokens)} pages a slot do "
                f"not split over {lay.sp} sp shards")
        if lay == self.par_layout:
            self._move_workers(target)
            return 0
        if self.max_seq_alloc < self.seq_quantum * tp_to:
            self._resize_pool(self.seq_quantum * tp_to)
        session = TE.open_owner_session(self, tp_to, layers_per_step,
                                        devices=target, layout_to=lay)
        self.tp_pending = tp_to
        self._pending_devices = (target if target != self.devices
                                 else None)
        self._session_cross = session.cross
        self._session_t0 = time.monotonic()
        return session.schedule.n_steps

    def _move_workers(self, target: List[Worker]) -> None:
        """Same-degree move onto the workers ``target``: every layer's
        weights, pages and metadata re-shard to the same degree on the
        new assembly (``core.kv_transform.migrate_sharded``, the gather
        and scatter kernels), the replicated weights follow, and the pool
        is sized to ``seq_quantum * len(target)`` (trimmed before the
        move, grown after it).  Live contexts must fit that allocation
        (the scheduler's ``donor_loanable`` keeps a shrink legal)."""
        need = self._live_need()
        alloc = self.seq_quantum * len(target)
        assert need <= alloc, (
            f"live context ({need} tok) exceeds the retained width's "
            f"allocation ({alloc} tok)")
        t0 = time.monotonic()
        if alloc < self.max_seq_alloc:
            self._resize_pool(alloc)
        lay = self.par_layout
        src, dst = self.mesh, InstanceMesh(target, lay)
        moved = 0
        for layer in self.layers:
            moved += I.move_attn(layer, dst, lay, self.plan)[0]
            I.move_mlp(layer, dst, lay, self.plan.max_tp)
            layer.ln1 = I.replicas_across(layer.ln1, src, dst)
            layer.ln2 = I.replicas_across(layer.ln2, src, dst)
            layer.mesh = dst
        self.static = I.replicas_across(self.static, src, dst)
        self.mesh, self.devices, self.W = dst, list(target), len(target)
        self._resize_pool(alloc)
        TE._sync(src.devices + dst.devices)
        self.move_log.append({
            "kind": "move", "tp_from": self.tp, "tp_to": self.tp,
            "layout_from": f"{src.W // lay.degree}x{lay}",
            "layout_to": f"{dst.W // lay.degree}x{lay}",
            "bytes": sum(c.nbytes for layer in self.layers
                         for c in layer.cache),
            "wall_s": time.monotonic() - t0, "kv_bytes": moved})
        self.check_capacity_invariant()

    @property
    def transforming(self) -> bool:
        return self._session is not None

    def _finish_transform(self) -> None:
        session = TE.close_owner_session(self)
        self.tp_pending = None
        self.transform_reports.extend(session.reports)
        reps = session.reports
        lay_from, lay_to = session.schedule.resolved_layouts()
        self.transform_log.append({
            "kind": "transform",
            "tp_from": session.schedule.tp_from,
            "tp_to": session.schedule.tp_to,
            "layout_from": str(lay_from), "layout_to": str(lay_to),
            "bytes": sum(c.nbytes for layer in self.layers
                         for c in layer.cache),
            "cross": self._session_cross,
            "steps": session.schedule.n_steps,
            "wall_s": time.monotonic() - self._session_t0,
            "measured_s": sum(r.seconds for r in reps),
            "exposed_s": sum(r.blocked_s for r in reps),
            "modeled_s": sum(r.modeled_s for r in reps),
            "step_drifts": [abs(r.seconds - r.modeled_s) / r.modeled_s
                            for r in reps if r.modeled_s > 0.0],
            # what the session's kernels and exchanges moved, and the
            # weights copied to workers that held none
            "kv_bytes": sum(r.kv_bytes for r in reps),
            "weight_bytes": sum(r.weight_bytes for r in reps),
            # attention weights written into new tensors, and those
            # gathered from other workers (0 and 0 kept whole in place)
            "attn_copied_bytes": sum(r.attn_copied_bytes for r in reps),
            "attn_gathered_bytes": sum(r.attn_gathered_bytes
                                       for r in reps),
        })
        self._session_cross = False
        if self._pending_devices is not None:
            # a split: every tensor now lives on the retained workers
            self.devices = self._pending_devices
            self.W = len(self.devices)
            self.adopted_devices = []
            self._pending_devices = None
        # memory follows the TP degree: trim the pool to the landed
        # degree's allocation, never below a live context's footprint,
        # in whole pages of every sp shard
        unit = self.page_tokens * self.par_layout.sp
        target = -(-max(self.seq_quantum * self.tp, self._live_need())
                   // unit) * unit
        if target < self.max_seq_alloc:
            self._resize_pool(target)
        self.check_capacity_invariant()

    def _live_need(self) -> int:
        """The page-rounded footprint of the longest live or queued
        request."""
        live = [r for r in self.slots if r is not None] + self.waiting
        need = max((r.total_tokens for r in live), default=0)
        return -(-need // self.page_tokens) * self.page_tokens

    def _resize_pool(self, new_max_seq: int) -> None:
        """Reallocate every full-attention pool at ``new_max_seq`` tokens
        a slot, on every worker (window caches keep their window)."""
        if new_max_seq == self.max_seq_alloc:
            return
        old_cap = -(-self.max_seq_alloc // self.page_tokens) \
            * self.page_tokens
        new_mps = -(-new_max_seq // self.page_tokens)
        for layer in self.layers:
            lay = layer.attn_layout
            lo, hi = I.rows_of(lay, self.max_batch, layer.mesh.W, 0)
            if not layer.cache[0].spans(old_cap // lay.sp):
                continue    # a window's ring keeps its size, a state too
            if lay.sp == 1:
                layer.cache = [KT.resize_slot_capacity(c, new_mps, hi - lo)
                               for c in layer.cache]
                continue
            # an sp shard's page range moves with the slot's page count:
            # the global cache is resized and laid out again
            g = KT.resize_slot_capacity(I.join_cache(layer.cache, lay),
                                        new_mps, self.max_batch)
            layer.cache = I.split_cache(g, lay, layer.mesh.devices)
        self.max_seq_alloc = new_max_seq

    # -- cross-instance merge lifecycle (paper Fig. 3, §3.4) ----------------
    #
    # The control plane (serving.cluster) drives a merge as
    #   donor.export_active() -> donor.park() -> target.adopt_devices()
    #   -> target.import_request(...) -> target.transform(W')
    # and a split as transform(1, devices=home_devices), then
    # donor.revive().  Each keeps the capacity contract true.

    def adopt_devices(self, workers: List[Worker]) -> None:
        """Widen this engine with a parked donor's workers.  The pool
        grows by their per-slot allocation BEFORE the transform so
        imported and migrated KV has page-aligned room; every layer still
        sits on the old workers until ``transform`` carries it across."""
        assert self.mesh is not None and not self.transforming
        assert self.tp == 1, "merge targets must be at TP1 (Fig. 3)"
        assert workers, "nothing to adopt"
        self.adopted_devices = self.adopted_devices + list(workers)
        self.devices = self.devices + list(workers)
        self.W = len(self.devices)
        self._resize_pool(self.seq_quantum * self.W)
        self.check_capacity_invariant()

    def park(self) -> List[Worker]:
        """Donor side of a merge: drop every tensor of the engine and
        return its workers (the control plane has exported its in-flight
        requests with ``export_active``).  The engine stays constructed;
        ``revive`` brings it back."""
        assert not self.transforming and not self.parked
        assert all(s is None for s in self.slots) and not self.waiting \
            and not self._prefilling, (
                "park requires a drained engine (export_active first)")
        assert not self._spills and not self._hosted, (
            "cannot park an engine taking part in a KV spill")
        workers = list(self.devices)
        self.parked = True
        self.layers, self.static, self.mesh = [], None, None
        self.cross = None
        self.devices = []
        return workers

    def revive(self, workers: List[Worker],
               params: Union[M.Model, "Engine"]) -> None:
        """Rebuild a parked engine on ``workers`` (normally its own,
        returned by a split): a fresh TP1 x W replica of ``params`` (a
        ``Model``, or an engine at TP1 whose replica is copied: weights
        are identical cluster-wide) and an empty pool at this width's
        allocation."""
        assert self.parked
        self.devices = list(workers)
        self.home_devices = list(workers)
        self.W = len(workers)
        self.parked = False
        self.tp, self.tp_pending = 1, None
        self.par_layout = Layout(1, 1)
        self.max_seq_alloc = self.seq_quantum * self.W
        self.mesh = InstanceMesh(self.devices, 1)
        self._place(params)
        self.slots = [None] * self.max_batch
        self._prefilling = {}
        self._prefill_deferred = 0
        self.check_capacity_invariant()

    def _holder(self, layer: I.WorkerLayer, slot: int) -> Tuple[int, int]:
        """(worker, local slot) holding ``slot`` of a layer at TP1."""
        assert layer.attn_layout == Layout(1, 1), "slots move at TP1 only"
        per = self.max_batch // layer.mesh.W
        return slot // per, slot % per

    def export_active(self) -> List[Tuple[ServeRequest, List[pp.PagedState],
                                          Optional[Dict]]]:
        """Donor-side KV export: pull every in-flight request out of its
        slot as ``(request, per-layer batch-1 states, prefill progress)``
        for ``import_request`` on the merge target; slots are freed.  A
        slot mid-chunked-prefill exports its chunk plan and progress, so
        the target resumes the prefill where the donor stopped."""
        self._refuse_live_change("slot export")
        assert self.mesh is not None and not self.transforming
        out = []
        for slot, r in enumerate(self.slots):
            if r is None:
                continue
            prog = self._prefilling.pop(slot, None)
            extra = None if prog is None else {
                k: prog.get(k) for k in ("chunks", "ci", "done", "rec")}
            sub = []
            for layer in self.layers:
                w, local = self._holder(layer, slot)
                sub.append(KT.export_slot(layer.cache[w], local))
            out.append((r, sub, extra))
            self.slots[slot] = None
        return out

    def import_request(self, req: ServeRequest, sub: List[pp.PagedState],
                       progress: Optional[Dict] = None) -> None:
        """Target-side KV import: land a donor request's states in a free
        slot (on the worker that owns it, through the scatter kernel) and
        resume it here: decoding, or its chunked prefill at ``progress``."""
        self._refuse_live_change("slot import")
        assert self.mesh is not None and not self.transforming
        slot = self._free_slot()
        assert slot is not None, "no free slot for donor import"
        for layer, s in zip(self.layers, sub):
            w, local = self._holder(layer, slot)
            KT.import_slot(layer.cache[w], s, local)
        req.slot = slot
        self.slots[slot] = req
        if progress is not None:
            self._prefilling[slot] = {"req": req, **progress}

    def global_caches(self) -> List:
        """Every layer's cache as the reference's global arrays hold it
        (``core.instance.join_cache``, sp shards' page ranges joined):
        equal bytes before and after a migration."""
        if self.mesh is None:
            return self.caches
        return [I.join_cache(l.cache, l.attn_layout) for l in self.layers]

    # -- KV spill (rung 1 of the capacity ladder) ---------------------------
    #
    # The reference's Infinite-LLM-style distributed pool: a host engine
    # reserves whole free slots for a guest's overflow pages; the guest
    # computes a spilled slot's chunks and decode steps on a batch-1
    # EXTENDED view (``paged.pool.concat_spilled``: the slot's local
    # pages, then the hosted ones, as one identity-paged state), on the
    # ordinary decode and chunk-prefill kernels, and writes the view back
    # (``spill_slot``): the local part into the slot, the overflow pages
    # into the host's pool through ``kv_transform.migrate_slot_pages``
    # (the page-copy kernel).  As in the reference, every extended step
    # re-copies the whole overflow both ways.  Spill runs at TP1 and
    # outside transform sessions (the control plane keeps spill
    # participants out of transforms).

    def _local_page_cap(self) -> int:
        """Page-rounded capacity of a full-attention slot: the
        discriminator of full-attention caches (ring caches keep their
        window and never spill)."""
        return -(-self.max_seq_alloc // self.page_tokens) * self.page_tokens

    def host_spilled(self, n_pages: int) -> Optional[Dict]:
        """Host side of a KV spill: reserve whole FREE slots to carry
        ``n_pages`` of a neighbour's overflow.  Returns the hosting
        descriptor (handle, reserved slots, granted page count), or None
        when the pool lacks the free slots: the control plane then falls
        back down the capacity ladder."""
        self._refuse_live_change("KV spill")
        if self.parked or self.transforming or n_pages <= 0:
            return None
        mps = self._local_page_cap() // self.page_tokens
        need = -(-n_pages // mps)
        hosted = self._hosted_slots()
        free = [i for i, s in enumerate(self.slots)
                if s is None and i not in hosted]
        if len(free) < need:
            return None
        slots = tuple(free[:need])
        # a free slot's positions still name what its last request, or
        # the batched decode's filler at its idle cursor, left there: the
        # guest's extended view would read those as keys.  Empty them
        # (the reference does not: ROADMAP queue 3).
        for j in slots:
            for v in self._slot_caches(j):
                v.empty_()
        handle = next(self._hosted_ids)
        self._hosted[handle] = {"slots": slots, "pages": need * mps}
        return {"handle": handle, "slots": slots, "pages": need * mps,
                "page_tokens": self.page_tokens}

    def release_hosted(self, handle: int) -> None:
        self._hosted.pop(handle, None)

    def admit_spilled(self, req: ServeRequest, host: "Engine",
                      hosting: Dict) -> None:
        """Guest side: queue a request whose overflow KV will live in
        ``host``'s pool (the reservation from ``host.host_spilled``)."""
        self._refuse_live_change("KV spill")
        assert hosting["page_tokens"] == self.page_tokens, (
            "KV spill requires a uniform page size across the cluster")
        ext_tokens = self._local_page_cap() \
            + hosting["pages"] * self.page_tokens
        assert ext_tokens >= req.total_tokens, (
            ext_tokens, req.total_tokens)
        self._spill_plans[req.rid] = {"host": host, "hosting": hosting,
                                      "ext_tokens": ext_tokens}
        self.submit(req)

    def _slot_ceiling(self, slot: int) -> int:
        """Context ceiling of one slot: the pool allocation, extended by
        the hosted overflow for a spilled slot."""
        sp = self._spills.get(slot)
        return self.max_seq_alloc if sp is None else sp["ext_tokens"]

    def _slot_states(self, slot: int) -> List[Tuple[pp.PagedState, int]]:
        """Each layer's whole cache holding ``slot`` and the slot's index
        in it (at TP1: the cache of the worker that owns the slot)."""
        if self.mesh is None:
            return [(c, slot) for c in self.caches]
        assert self.tp == 1, "spilled slots live at TP1"
        out = []
        for layer in self.layers:
            w, local = self._holder(layer, slot)
            out.append((layer.cache[w], local))
        return out

    def _assemble_spilled(self, slot: int) -> List[pp.PagedState]:
        """Extended batch-1 view of a spilled slot, one state a layer:
        the slot's local pages followed by the host-pool overflow pages
        of each full-attention layer (a copy, on the slot's device); a
        ring cache's or a recurrent state's own slot view otherwise."""
        sp = self._spills[slot]
        host: Engine = sp["host"]
        cap = self._local_page_cap()
        parts = [host._slot_caches(j) for j in sp["hosting"]["slots"]]
        return [pp.concat_spilled([loc] + [p[i] for p in parts])
                if loc.spans(cap) else loc
                for i, loc in enumerate(self._slot_caches(slot))]

    def spill_slot(self, slot: int, ext: List[pp.PagedState]) -> None:
        """Write a spilled slot back after an extended-view compute: the
        local part lands in the slot's own pages, and the overflow pages
        MIGRATE into the host engine's pool (``write_spill_pages`` ->
        ``kv_transform.migrate_slot_pages`` -> the page-copy kernel).
        This is where KV bytes cross engines."""
        t0 = time.monotonic()
        sp = self._spills[slot]
        host: Engine = sp["host"]
        host_slots = sp["hosting"]["slots"]
        counts = [self._local_page_cap() // self.page_tokens] \
            + [host._local_page_cap() // host.page_tokens] * len(host_slots)
        ext_cap = sum(counts) * self.page_tokens
        host_parts: List[List[Optional[pp.PagedState]]] = [
            [None] * len(ext) for _ in host_slots]
        for i, (view, loc) in enumerate(zip(ext, self._slot_caches(slot))):
            if not view.spans(ext_cap):
                continue    # a ring cache or a state, computed in place
            parts = pp.split_spilled(view, counts)
            loc.copy_(parts[0])
            for k, part in enumerate(parts[1:]):
                host_parts[k][i] = part
        for k, j in enumerate(host_slots):
            host.write_spill_pages(j, host_parts[k])
        overflow_pages = sum(counts[1:])
        self.spill_log.append({
            "kind": "spill", "tp_from": 0, "tp_to": 0,
            "wall_s": time.monotonic() - t0,
            "bytes": kv_bytes_per_token(self.cfg) * overflow_pages
            * self.page_tokens,
            "pages": overflow_pages,
        })

    def write_spill_pages(self, j: int,
                          part: List[Optional[pp.PagedState]]) -> None:
        """Host side of ``spill_slot``: land one overflow segment in
        reserved slot ``j``'s page range, one batch-1 state a layer (None
        for layers that do not spill).  Pool bytes move through
        ``kv_transform.migrate_slot_pages``; the positions ride alongside
        so hosted pages stay self-describing."""
        for (dst, local), src in zip(self._slot_states(j), part):
            if src is None:
                continue
            mps_d = dst.page_table.shape[-1]
            mps_s = src.page_table.shape[-1]
            assert mps_s <= mps_d, (mps_s, mps_d)
            KT.migrate_slot_pages(src.pool, dst.pool, mps_s, local * mps_d)
            row = dst.positions[local]
            cap_s = src.positions.shape[-1]
            row[:cap_s].copy_(src.positions[0].to(row.device))
            row[cap_s:].fill_(-1)

    def _decode_spilled(self, r: ServeRequest) -> int:
        """One decode step for a slot whose context has outgrown the
        local pool: assemble the extended view, run the ordinary decode
        on it (batch-1), sample as the batched path does, write back."""
        assert self._session is None, (
            "spilled slots decode outside transform sessions")
        slot = r.slot
        ext = self._assemble_spilled(slot)
        tok = torch.tensor([r.generated[-1]], dtype=torch.long)
        pos = torch.tensor([r.context_len - 1], dtype=torch.int32)
        if self.mesh is None:
            logits = self.model.decode_step(ext, tok.to(self.device),
                                            pos.to(self.device))
        else:
            logits = self._walk([slot], tok[:, None], pos[:, None],
                                "decode", caches=ext)
        t = self._sample(logits[0], r.temperature)
        self.spill_slot(slot, ext)
        r.generated.append(t)
        if (len(r.generated) >= r.max_new_tokens
                or (r.eos_id is not None and t == r.eos_id)
                or r.context_len >= self._slot_ceiling(slot)):
            r.state = State.DONE
            r.t_done = self._clock()
            self.slots[slot] = None
        return 1

    def _release_spill(self, slot: int) -> None:
        sp = self._spills.pop(slot)
        sp["host"].release_hosted(sp["hosting"]["handle"])

    # -- one engine iteration -----------------------------------------------
    @torch.no_grad()
    def step(self) -> Dict[str, int]:
        """One engine iteration: policy-driven prefill work, then one
        batched decode step for every decoding slot.  While a transform
        session is open, the iteration first completes the previous
        schedule step, then stages the next one and primes one layer
        group; the decode's layer walk issues the rest, one group per
        layer, and the final step completes after the decode."""
        if self._session is not None:
            s = self._session
            s.complete_step()
            if s.done:
                self._finish_transform()
            else:
                s.dispatch_step_begin()
                s.dispatch_step_advance()
        in_session = self._session is not None
        emitted = self._prefill_step()
        decode_emitted = 0
        active = [r for r in self.slots
                  if r is not None and r.state == State.DECODE]
        # spilled slots past the local ceiling decode one by one on the
        # extended (local + hosted pages) view; the rest stay batched
        lcap = self._local_page_cap() if self._spills else 0
        ext_active = [r for r in active if r.slot in self._spills
                      and r.context_len - 1 >= lcap]
        ext_slots = {r.slot for r in ext_active}
        batch_active = [r for r in active if r.slot not in ext_slots]
        # the batched decode appends masked filler at EVERY row's cursor:
        # the cursor of a spilled slot outside the batch (prefilling, or
        # decoding on the extended view) may sit at or past its local
        # capacity, on real prefix, and a slot hosting a neighbour's
        # overflow is idle here, its cursor on hosted pages.  Save those
        # slots' views and restore them after the batch.  (The reference
        # saves only the spilled slots that are not decoding on the
        # extended view: ROADMAP queue 3.)
        protect = set()
        if batch_active:
            protect = ({s for s in self._spills if self.slots[s] is not None}
                       | self._hosted_slots()) \
                - {r.slot for r in batch_active}
        saved = {s: [v.clone() for v in self._slot_caches(s)]
                 for s in protect}
        if batch_active:
            tokens = np.zeros((self.max_batch,), np.int64)
            positions = np.zeros((self.max_batch,), np.int32)
            for r in batch_active:
                tokens[r.slot] = r.generated[-1]
                positions[r.slot] = r.context_len - 1
            # one batched step over every slot: idle and prefilling rows
            # compute masked filler whose outputs are dropped
            logits = self._decode(torch.from_numpy(tokens),
                                  torch.from_numpy(positions))
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for r in batch_active:
                tok = int(nxt[r.slot])
                if r.temperature > 0:
                    tok = self._sample(logits[r.slot], r.temperature)
                r.generated.append(tok)
                emitted += 1
                decode_emitted += 1
                if (len(r.generated) >= r.max_new_tokens
                        or (r.eos_id is not None and tok == r.eos_id)
                        or r.context_len >= self._slot_ceiling(r.slot)):
                    r.state = State.DONE
                    r.t_done = self._clock()
                    self.slots[r.slot] = None
            self._pin_prefill_cursors()
        for s, views in saved.items():
            for v, keep in zip(self._slot_caches(s), views):
                v.copy_(keep)
        for r in ext_active:
            emitted += self._decode_spilled(r)
            decode_emitted += 1
        for s in [s for s in self._spills if self.slots[s] is None]:
            self._release_spill(s)
        if self._session is not None and self._session.all_dispatched:
            self._session.complete_step()
            if self._session.done:
                self._finish_transform()
        return {"active": len(active), "waiting": len(self.waiting),
                "emitted": emitted, "decode_emitted": decode_emitted,
                "transforming": int(in_session)}

    def _decode(self, tokens: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        """One decode step over every slot; mid-session, the groups the
        walk could not issue (their layer was already walked) go out
        after it."""
        if self.mesh is None:
            return self.model.decode_step(self.caches,
                                          tokens.to(self.device),
                                          positions.to(self.device),
                                          cross=self.cross)
        logits = self._walk(list(range(self.max_batch)), tokens[:, None],
                            positions[:, None], "decode")
        if self._session is not None:
            self._session.dispatch_step_drain()
        return logits

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if (not self.waiting and not self.transforming
                    and all(s is None for s in self.slots)):
                return
            self.step()
        raise RuntimeError("engine did not drain")
