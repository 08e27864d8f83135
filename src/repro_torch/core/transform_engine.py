"""Transformation orchestration (paper §4.3).

The counterpart of ``repro.core.transform_engine``.  Schedules:

  * MLP-first on scale-up: MLP weights re-split before the KV migration
    starts, so the freed memory absorbs incoming remote KV;
  * layer-staggered on scale-down: one (or a few) layers a step bounds
    the transient memory spike, KV first;
  * reversed traversal: last layer first.

``TransformSession`` executes a schedule step by step against the
per-worker layers of an engine (``core.instance.WorkerLayer``), keeping
the reference's call structure: stage a step, prime one layer group,
stream one group per decode layer (``on_decode_layer``), drain.

Differences from the reference:

  * The port runs eagerly and keeps ONE per-layer representation, so
    ``unstack_decode_state`` / ``restack_decode_state`` have no
    counterpart: a session flips each layer's layout in place, and
    ``close_owner_session`` flips the owner's ``tp``.
  * An ``mlp`` op re-splits the layer's MLP weights from degree a to
    degree b inside each TP group (scale-up: each worker keeps its
    S/b-shard slice as a compact tensor of its own and drops the rest;
    scale-down: each worker gathers its S/b shards from its group's
    peers).  A ``kv`` op runs the sharded migration of the layer's pages
    (``kv_transform.migrate_sharded``) and moves the attention weights
    with them, so each half of a layer is at one degree at any time
    (the reference's ``mlp`` op moves the whole layer's weights; GSPMD
    computes the mixed state, and its ``device_put`` does the partial
    degrees' moves that the port makes explicitly).
  * Everything is issued on the current stream; overlapping a step
    under decode on a side CUDA stream is later work.  A step's
    ``seconds`` run from staging to ``torch.cuda.synchronize`` after
    its last op (wall clock on the CPU), and ``blocked_s`` is the host
    time issuing it plus that wait.
  * Embedding and head are replicated in both layouts, so the final
    step carries a static-parameter span only on a cross-assembly
    session (a merge onto adopted workers or a split back home), where
    the workers change.

Cross-assembly sessions (the counterpart of the reference's
``cross`` sessions) run the layer-coherent scale-up schedule on a merge;
the scale-down schedule is coherent already.  A layer's tensors move
from its old assembly to its new one as a group: an adopted worker gets
its shard copied from a worker holding the replica, and on a split the
adopted workers' tensors are dropped as each layer leaves them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Literal, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import instance as I
from repro_torch.core import kv_transform as KT
from repro_torch.core import weight_transform as WT
from repro_torch.core.padding import PaddingPlan
from repro_torch.launch.mesh import InstanceMesh, Layout

Component = Literal["mlp", "kv"]


@dataclass(frozen=True)
class TransformOp:
    layer: int
    component: Component
    overlap: bool = True


@dataclass
class Schedule:
    direction: str                 # "up" | "down"
    tp_from: int
    tp_to: int
    steps: List[List[TransformOp]] = field(default_factory=list)
    layout_from: Optional[Layout] = None
    layout_to: Optional[Layout] = None

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def resolved_layouts(self) -> Tuple[Layout, Layout]:
        return (self.layout_from or Layout.of(self.tp_from),
                self.layout_to or Layout.of(self.tp_to))


def scale_up_schedule(n_layers: int, layers_per_step: int = 0,
                      tp_from: int = 1, tp_to: int = 4,
                      coherent: bool = False) -> Schedule:
    """MLP-first, reversed order, then KV migration per layer.
    ``coherent=True``: each step moves a layer's MLP and KV together."""
    lps = layers_per_step or n_layers
    order = list(range(n_layers - 1, -1, -1))
    steps: List[List[TransformOp]] = []
    if coherent:
        for i in range(0, n_layers, lps):
            chunk = order[i:i + lps]
            steps.append([TransformOp(l, "mlp") for l in chunk]
                         + [TransformOp(l, "kv") for l in chunk])
        return Schedule("up", tp_from, tp_to, steps)
    for i in range(0, n_layers, lps):
        steps.append([TransformOp(l, "mlp") for l in order[i:i + lps]])
    for i in range(0, n_layers, lps):
        steps.append([TransformOp(l, "kv") for l in order[i:i + lps]])
    return Schedule("up", tp_from, tp_to, steps)


def schedule_is_layer_coherent(sched: Schedule) -> bool:
    """True iff every layer named in a step has both its components in
    that same step."""
    for step in sched.steps:
        by_layer: Dict[int, set] = {}
        for op in step:
            by_layer.setdefault(op.layer, set()).add(op.component)
        if any(comps != {"mlp", "kv"} for comps in by_layer.values()):
            return False
    return True


def scale_down_schedule(n_layers: int, layers_per_step: int = 1,
                        tp_from: int = 4, tp_to: int = 1) -> Schedule:
    """Layer-staggered, reversed order; KV first so freed head shards
    make room for the incoming MLP weight gather."""
    order = list(range(n_layers - 1, -1, -1))
    steps: List[List[TransformOp]] = []
    for i in range(0, n_layers, layers_per_step):
        chunk = order[i:i + layers_per_step]
        steps.append([TransformOp(l, "kv") for l in chunk]
                     + [TransformOp(l, "mlp") for l in chunk])
    return Schedule("down", tp_from, tp_to, steps)


def _mlp_stats(sched: Schedule, cfg: ModelConfig, plan: PaddingPlan,
               method: str) -> WT.WeightTransformStats:
    """The MLP's cost: a regroup between the layouts' tp factors (none
    when they agree, as TP2x2 <-> SP2xTP2)."""
    la, lb = sched.resolved_layouts()
    if la.tp == lb.tp:
        return WT.WeightTransformStats()
    return WT.account_regroup(cfg, plan, la.tp, lb.tp, method)


def schedule_cost(sched: Schedule, cfg: ModelConfig, plan: PaddingPlan,
                  kv_stats_per_layer: KT.MigrationStats,
                  link: KT.LinkModel, method: str = "padded",
                  overlap: bool = True) -> Tuple[float, List[float]]:
    """Modeled total transformation time and per-step times."""
    per_step = []
    for step in sched.steps:
        t = 0.0
        for op in step:
            if op.component == "mlp":
                t += _mlp_stats(sched, cfg, plan, method).time_s(
                    link, overlap=overlap and op.overlap)
            else:
                t += kv_stats_per_layer.time_s(
                    link, overlap=overlap and op.overlap)
        per_step.append(t)
    return sum(per_step), per_step


def seesaw_cost(cfg: ModelConfig, plan: PaddingPlan, n_layers: int,
                link: KT.LinkModel, host_bw: float = 25e9) -> float:
    """Seesaw-style baseline: weights bounce through host memory, every
    byte crossing PCIe twice."""
    w_bytes = WT.mlp_layer_bytes(cfg, plan, padded=False) * n_layers
    return 2.0 * w_bytes / host_bw


# ---------------------------------------------------------------------------
# Schedule execution
# ---------------------------------------------------------------------------

def open_owner_session(owner, tp_to: int, layers_per_step: int = 1,
                       storage_layout: str = "header_centric",
                       devices: Optional[List] = None,
                       layout_to: Optional[Layout] = None
                       ) -> "TransformSession":
    """Open a session on anything owning ``layers/static/cfg/plan/tp/
    mesh/page_tokens/_session`` (the serving engine, ``InstanceGroup``;
    ``par_layout`` when it has one): a change of layout to ``layout_to``
    (default pure TP at ``tp_to``, its degree) whose degree divides the
    target worker count, ``(rep, sp, tp) -> (rep', sp', tp')`` (TP1 x W
    -> TPW' is a full merge, TPW -> TP1 x W' a decompose, TP1 x 4 -> TP2 x
    2 a partial one, TP4 -> SP2xTP2 a same-degree layout change), onto
    the workers ``devices`` (default: the owner's own).  When those are
    not the owner's current assembly the session is CROSS-assembly (a
    merge onto adopted workers, or a split back onto the home workers).
    A cross-assembly session and a same-degree layout change run the
    layer-coherent schedule (every step moves whole layers), so each
    layer sits on exactly one assembly and layout at any time and
    serving goes on through the session."""
    assert owner._session is None, "transformation already in progress"
    mesh_from = owner.mesh
    workers = mesh_from.workers if devices is None else list(devices)
    tp_from = owner.tp
    lay_from = Layout.of(getattr(owner, "par_layout", None) or tp_from)
    lay_to = Layout.of(layout_to if layout_to is not None else tp_to)
    assert lay_from.degree == tp_from and lay_to.degree == tp_to, (
        lay_from, tp_from, lay_to, tp_to)
    assert lay_to != lay_from and len(workers) % tp_to == 0, (
        lay_from, lay_to, len(workers))
    mesh_to = InstanceMesh(workers, lay_to)
    n = len(owner.layers)
    cross = not mesh_from.same_workers(mesh_to)
    if tp_to >= tp_from:
        sched = scale_up_schedule(n, layers_per_step, tp_from, tp_to,
                                  coherent=cross or tp_to == tp_from)
    else:
        sched = scale_down_schedule(n, layers_per_step, tp_from, tp_to)
    sched.layout_from, sched.layout_to = lay_from, lay_to
    session = TransformSession(
        owner.layers, sched, owner.cfg, owner.plan, mesh_to=mesh_to,
        page_tokens=owner.page_tokens, storage_layout=storage_layout,
        mesh_from=mesh_from, static=owner.static)
    owner._session = session
    return session


def close_owner_session(owner) -> "TransformSession":
    """Flip the owner's mesh, static weights, ``tp`` and (when it keeps
    one) ``par_layout`` to the drained session's target."""
    session = owner._session
    assert session is not None and session.done, "schedule steps remain"
    owner.mesh = session.mesh_to
    owner.static = session.static
    owner.tp = session.schedule.tp_to
    if hasattr(owner, "par_layout"):
        owner.par_layout = session.schedule.resolved_layouts()[1]
    owner._session = None
    return session


@dataclass
class StepReport:
    """What one executed schedule step did, measured vs. modeled.
    ``seconds`` spans staging to the synchronize after its last op;
    ``blocked_s`` is the exposed cost (host time issuing the ops plus
    the wait); ``modeled_s`` the accounting plane's prediction (a
    model, see ``core.kv_transform``)."""
    ops: List[TransformOp]
    seconds: float
    modeled_s: float
    kernel_plane: bool = False     # gather/scatter kernels + all-to-all?
    dispatch_s: float = 0.0
    blocked_s: float = 0.0
    overlapped: bool = False
    # (layer, components, start_rel_s, duration_s) a layer group
    layer_spans: List[Tuple] = field(default_factory=list)
    # bytes the kv ops' kernels and exchange read and wrote, and the
    # bytes of the pools they migrated
    kv_bytes: int = 0
    kv_pool_bytes: int = 0
    # weight bytes that crossed assemblies (copied to a merge's adopted
    # workers, gathered from a split's shed ones)
    weight_bytes: int = 0
    # attention (token-mixer) weight bytes the kv ops wrote into new
    # tensors, and of those the bytes that came from another worker: 0
    # and 0 when attention is kept whole on the same workers
    attn_copied_bytes: int = 0
    attn_gathered_bytes: int = 0


def _sync(devices) -> None:
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


class TransformSession:
    """Executes a ``Schedule`` step by step against per-worker layers.
    Between steps the owner keeps serving through the per-layer walks
    (``models.model.walk_layers``), which read each layer's layouts and
    assembly as they reach it.

    A CROSS-assembly session (``mesh_from`` and ``mesh_to`` hold
    different workers: a merge or a split) needs a layer-coherent
    schedule, moves each layer's norms with it, and moves the non-layer
    ``static`` weights (embedding, final norm, head; replicated) once
    every layer group of the final step is out, as the reference's
    static span: until then ``static_mesh`` is ``mesh_from``."""

    def __init__(self, layers: List[I.WorkerLayer], schedule: Schedule,
                 cfg: ModelConfig, plan: PaddingPlan, mesh_to,
                 page_tokens: int, link: KT.LinkModel = KT.LinkModel(),
                 storage_layout: str = "header_centric", mesh_from=None,
                 static: Optional[List[Dict]] = None):
        self.layers = layers
        self.schedule = schedule
        self.cfg, self.plan = cfg, plan
        self.mesh_to = mesh_to
        self.mesh_from = mesh_to if mesh_from is None else mesh_from
        self.static, self.static_mesh = static, self.mesh_from
        self.cross = not self.mesh_from.same_workers(mesh_to)
        assert not self.cross or schedule_is_layer_coherent(schedule), (
            "cross-assembly sessions need layer-coherent schedule steps: "
            "a layer split across two assemblies cannot serve")
        self.page_tokens = page_tokens
        self.link = link
        self.storage_layout = storage_layout
        self.reports: List[StepReport] = []
        self._next = 0               # completed steps
        self._dispatched = 0         # staged steps (>= completed)
        self._pending: Optional[Dict] = None
        self.target = schedule.tp_to
        self.target_layout = schedule.resolved_layouts()[1]

    # -- progress -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._next >= self.schedule.n_steps

    @property
    def all_dispatched(self) -> bool:
        return self._dispatched >= self.schedule.n_steps

    # -- ops ------------------------------------------------------------
    def _modeled_op_s(self, op: TransformOp, layer: I.WorkerLayer) -> float:
        sched = self.schedule
        if op.component == "mlp":
            return _mlp_stats(sched, self.cfg, self.plan, "padded").time_s(
                self.link, overlap=op.overlap)
        if layer.cache[0].recurrent:
            return 0.0      # the reference prices a layer without a pool
        pool = layer.cache[0].pool
        la, lb = sched.resolved_layouts()
        lay = layer.attn_layout
        if la.sp > 1 or lb.sp > 1:
            # page ranges move between sp shards: the bytes each box
            # intersection sends off its worker
            src = layer.mesh
            mps = I.pages_per_slot(layer)
            batch = (layer.cache[0].page_table.shape[0]
                     * (src.W // lay.degree))
            same = [a == b for a in src.workers
                    for b in self.mesh_to.workers]
            stats = KT.layout_migration_stats(
                src.W, lay, self.mesh_to.W, self.target_layout, batch, mps,
                pool.shape[1] * lay.tp, self.page_tokens, pool.shape[-1],
                dtype_bytes=pool.element_size(), same=same)
            return stats.time_s(self.link, overlap=op.overlap)
        # the accounting plane models a TP1 x k -> TPk merge; a partial
        # a -> b re-splits heads among groups of k = max/min workers
        t = lay.degree
        NPt, kvs = pool.shape[0] * (layer.mesh.W // t), pool.shape[1] * t
        k = max(sched.tp_from, sched.tp_to) // max(
            1, min(sched.tp_from, sched.tp_to))
        stats = KT.account_scale_up(
            self.storage_layout, max(2, k), max(1, NPt // k), kvs,
            self.page_tokens, pool.shape[-1],
            dtype_bytes=pool.element_size())
        return stats.time_s(self.link, overlap=op.overlap)

    def _crossed_bytes(self, src, old: List[Dict], new: List[Dict]) -> int:
        """Weight bytes that crossed assemblies: ``new`` (one dict a
        worker of ``mesh_to``) on workers new to the layer (a merge's
        adopted ones), plus ``old`` (one a worker of ``src``) on workers
        the layer leaves (a split's).  0 in place."""
        def nbytes(pairs, keep):
            return sum(t.numel() * t.element_size() for wk, p in pairs
                       if wk not in keep.workers and p is not None
                       for t in p.values() if t is not None)

        return (nbytes(zip(self.mesh_to.workers, new), src)
                + nbytes(zip(src.workers, old), self.mesh_to))

    def _run_mlp(self, layer: I.WorkerLayer) -> int:
        """Re-split the layer's MLP weights; returns the bytes that
        crossed assemblies.  A layer without an MLP (an MLSTM or SLSTM
        block) moves nothing here: the op keeps its place in the
        reference's schedule, and the layer's mixer and state move
        together in its ``kv`` op."""
        src, old = layer.mesh, layer.mlp
        I.move_mlp(layer, self.mesh_to, self.target_layout, self.plan.max_tp)
        return self._crossed_bytes(src, old, layer.mlp)

    def _run_kv(self, layer: I.WorkerLayer
                ) -> Tuple[int, int, int, int, int]:
        """Migrate the layer's pages and attention weights; returns the
        bytes the migration's kernels and exchange read and wrote, the
        bytes of the migrated pool, the attention bytes that crossed
        assemblies, and the attention bytes copied in all and gathered
        from other workers (``core.instance.move_attn``).  Attention kept
        whole crosses only as the adopted workers' whole copies: a
        split's shed workers give nothing."""
        src, old = layer.mesh, layer.attn
        pool_bytes = sum(c.nbytes for c in layer.cache)
        moved, gathered, copied = I.move_attn(
            layer, self.mesh_to, self.target_layout, self.plan)
        crossed = (gathered if layer.attn_whole is not None
                   else self._crossed_bytes(src, old, layer.attn))
        return moved, pool_bytes, crossed, copied, gathered

    def _move_norms(self, layer: I.WorkerLayer) -> int:
        """A cross-assembly layer group's last act: its norms follow the
        weights, and the layer flips to ``mesh_to``."""
        src = layer.mesh
        moved = 0
        if self.cross:
            old = [{"a": a, "b": b} for a, b in zip(layer.ln1, layer.ln2)]
            layer.ln1 = I.replicas_across(layer.ln1, src, self.mesh_to)
            layer.ln2 = I.replicas_across(layer.ln2, src, self.mesh_to)
            moved = self._crossed_bytes(
                src, old, [{"a": a, "b": b}
                           for a, b in zip(layer.ln1, layer.ln2)])
        layer.mesh = self.mesh_to
        return moved

    # -- execution ------------------------------------------------------
    def dispatch_step_begin(self) -> None:
        """Stage the next schedule step: its ops grouped per layer
        (first-occurrence order), none issued yet."""
        assert self._pending is None, "previous step not completed"
        assert self._dispatched < self.schedule.n_steps, (
            "schedule exhausted")
        ops = self.schedule.steps[self._dispatched]
        groups: List[List] = []
        by_layer: Dict[int, List[TransformOp]] = {}
        for op in ops:
            if op.layer not in by_layer:
                by_layer[op.layer] = []
                groups.append([op.layer, by_layer[op.layer]])
            by_layer[op.layer].append(op)
        self._pending = {"ops": ops, "t0": time.perf_counter(),
                         "modeled": 0.0, "kernel": False, "dispatch_s": 0.0,
                         "groups": groups, "spans": [], "kv_bytes": 0,
                         "kv_pool_bytes": 0, "weight_bytes": 0,
                         "attn_copied": 0, "attn_gathered": 0,
                         "static": self.cross and (
                             self._dispatched + 1 == self.schedule.n_steps)}
        self._dispatched += 1

    def dispatch_step_advance(self) -> bool:
        """Issue ONE staged layer group (on a cross-assembly session's
        final step, once the groups are out, the static weights as one
        more).  Returns False when nothing is left to issue."""
        p = self._pending
        if p is None:
            return False
        if not p["groups"]:
            if not p["static"]:
                return False
            td = time.perf_counter()
            p["static"] = False
            old = self.static
            self.static = I.replicas_across(old, self.static_mesh,
                                            self.mesh_to)
            p["weight_bytes"] += self._crossed_bytes(self.static_mesh, old,
                                                     self.static)
            self.static_mesh = self.mesh_to
            dt = time.perf_counter() - td
            p["dispatch_s"] += dt
            p["spans"].append((-1, ("static",), td - p["t0"], dt))
            return True
        td = time.perf_counter()
        layer_idx, ops = p["groups"].pop(0)
        layer = self.layers[layer_idx]
        for op in ops:
            p["modeled"] += self._modeled_op_s(op, layer)
            if op.component == "mlp":
                p["weight_bytes"] += self._run_mlp(layer)
            else:
                moved, pool_bytes, wb, copied, gathered = self._run_kv(
                    layer)
                p["kv_bytes"] += moved
                p["kv_pool_bytes"] += pool_bytes
                p["weight_bytes"] += wb
                p["attn_copied"] += copied
                p["attn_gathered"] += gathered
                p["kernel"] = True
        p["weight_bytes"] += self._move_norms(layer)
        dt = time.perf_counter() - td
        p["dispatch_s"] += dt
        p["spans"].append((layer_idx, tuple(op.component for op in ops),
                           td - p["t0"], dt))
        return True

    def dispatch_step_drain(self) -> None:
        while self.dispatch_step_advance():
            pass

    def dispatch_step(self) -> None:
        self.dispatch_step_begin()
        self.dispatch_step_drain()

    def on_decode_layer(self, i: int) -> None:
        """Walk hook: after layer ``i`` has been issued, issue the next
        staged group, if the walk has not reached its layer yet."""
        p = self._pending
        if p is not None and p["groups"] and p["groups"][0][0] > i:
            self.dispatch_step_advance()

    def complete_step(self, overlapped: bool = True
                      ) -> Optional[StepReport]:
        """Drain the pending step, wait for the device, record its
        report.  No-op (None) when nothing is pending."""
        if self._pending is None:
            return None
        self.dispatch_step_drain()
        p, self._pending = self._pending, None
        t_wait = time.perf_counter()
        _sync(self.mesh_from.devices + self.mesh_to.devices)
        wait_s = time.perf_counter() - t_wait
        rep = StepReport(ops=p["ops"],
                         seconds=time.perf_counter() - p["t0"],
                         modeled_s=p["modeled"], kernel_plane=p["kernel"],
                         dispatch_s=p["dispatch_s"],
                         blocked_s=p["dispatch_s"] + wait_s,
                         overlapped=overlapped, layer_spans=p["spans"],
                         kv_bytes=p["kv_bytes"],
                         kv_pool_bytes=p["kv_pool_bytes"],
                         weight_bytes=p["weight_bytes"],
                         attn_copied_bytes=p["attn_copied"],
                         attn_gathered_bytes=p["attn_gathered"])
        self.reports.append(rep)
        self._next += 1
        return rep

    def step(self) -> StepReport:
        """Execute the next schedule step synchronously."""
        assert not self.done, "schedule exhausted"
        self.dispatch_step()
        return self.complete_step(overlapped=False)

    def run(self, between_steps: Optional[Callable[[StepReport], None]]
            = None) -> List[StepReport]:
        while not self.done:
            rep = self.step()
            if between_steps is not None:
                between_steps(rep)
        return self.reports
