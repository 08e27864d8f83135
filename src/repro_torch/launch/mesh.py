"""The instance ``Layout``, worker identities and the worker mesh of an
engine.

The counterpart of ``repro.launch.mesh``.  The reference is a single
controller: one process drives every device of a ``(rep, sp, tp)``
``jax.sharding.Mesh``, and GSPMD places each array's shards.  The port's
counterpart is one process holding a list of W workers, and their
devices may repeat: W x ``cuda:0`` on one card, W x ``cpu`` in the
tests, ``cuda:0..W-1`` on a box with several cards.  Every byte that the
reference's sharding places on worker w lives in a tensor that belongs
to worker w, and no other worker's tensor aliases it, so a change of
layout really copies every byte it moves, even when all workers share
one device.

A worker is a ``Worker(index, device)``: its index in the device pool
and its torch device.  Everything that compares placements (the pool
ledger, an engine's home and adopted workers, "does this session cross
assemblies") compares workers, never devices: two workers on one card
are two entries.

The exchanges between workers (``all_to_all``, ``all_reduce_sum``,
``all_gather``, ``group_all_gather``, ``sp_all_gather``, ``replicate``)
copy between worker
tensors with
``Tensor.copy_``: plain data movement, as ``lax.all_to_all`` is in the
reference.  ``all_to_all``, ``all_gather`` and ``replicate`` also run
between two assemblies (a layer's old workers and its new ones, in a
cross-instance merge or split): the senders are this mesh's workers,
the receivers those of ``dst``.  On several cards the same code does
peer copies; that path is not proven (no multi-card run yet), and an
NCCL exchange is later work.

The training grid (``Grid``) is the counterpart of the reference's
production mesh, ``(data, model)`` or ``(pod, data, model)``, over a
worker list in the reference's reshape order (``make_production_mesh``,
``make_host_mesh``, ``batch_axes``, ``model_axis_size``,
``data_axis_size``).  Its exchanges (all-gather over any axes, all-
reduce-sum and all-reduce-max, an all-to-all of pieces) are autograd
functions: the gradient of an all-gather is summed back into each
owner's shard (a reduce-scatter), that of an all-reduce-sum is an
all-reduce-sum of the gradients, that of an all-to-all the reverse
all-to-all.  Every exchange, the ``InstanceMesh`` ones included, adds
the bytes it moves between workers to ``comm_analysis.TALLY`` by the
reference's collective kinds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.comm_analysis import TALLY


def resolve_device(device) -> torch.device:
    """``None`` means the card.  A CUDA device without a GPU raises: the
    port never drops quietly to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on the GPU by default and none is "
                "available; pass device='cpu' (or CPU workers) to run the "
                "plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Worker:
    """One worker of a device pool: ``index`` is its place in the pool,
    ``device`` where its tensors live.  Hashable and equal by both, so
    workers sharing a device stay distinct."""
    index: int
    device: torch.device

    def __str__(self) -> str:
        return f"w{self.index}@{self.device}"


def workers_of(devices: Sequence) -> List[Worker]:
    """Worker identities for a list of workers or devices: a ``Worker``
    stays itself, device entry i becomes ``Worker(i, device)``."""
    return [d if isinstance(d, Worker) else Worker(i, resolve_device(d))
            for i, d in enumerate(devices)]


@dataclass(frozen=True, order=True)
class Layout:
    """A parallelism layout for one serving instance: ``sp`` sequence-
    parallel shards x ``tp`` tensor-parallel shards, ``degree = sp * tp``
    devices per replica.  A bare TP degree ``t`` is the layout
    ``Layout(1, t)``: the entry points that take a degree turn it into
    a ``Layout`` once (``Layout.of``), and everything inside holds
    ``Layout`` values."""
    sp: int = 1
    tp: int = 1

    def __post_init__(self):
        if self.sp < 1 or self.tp < 1:
            raise ValueError(f"layout factors must be >= 1: {self}")

    @property
    def degree(self) -> int:
        return self.sp * self.tp

    @staticmethod
    def of(value) -> "Layout":
        """Coerce an int TP degree or a Layout."""
        if isinstance(value, Layout):
            return value
        return Layout(1, int(value))

    def __str__(self) -> str:
        return (f"SP{self.sp}xTP{self.tp}" if self.sp > 1
                else f"TP{self.tp}")


def place(lay: Layout, w: int) -> Tuple[int, int, int]:
    """Worker w's ``(replica, sp shard, tp position)`` at ``lay``: the
    order of the reference's ``(rep, sp, tp)`` reshape of the device
    list."""
    return w // lay.degree, (w // lay.tp) % lay.sp, w % lay.tp


class InstanceMesh:
    """W workers arranged as ``(rep, sp, tp)`` for one layout, ordered as
    the reference's reshape orders its devices (``place``): worker w is
    in replica ``w // (sp*tp)``, sp shard ``(w // tp) % sp`` and at tp
    position ``w % tp``.  A TP group is a run of ``tp`` consecutive
    workers (one shard of one replica); an sp group is the ``sp``
    workers of one replica at one tp position (``sp_groups``).
    ``devices`` may be workers or devices (``workers_of``); ``layout``
    a ``Layout`` or a TP degree."""

    def __init__(self, devices: Sequence, layout):
        lay = Layout.of(layout)
        W = len(devices)
        if W % lay.degree:
            raise ValueError(f"layout {lay} (degree {lay.degree}) does not "
                             f"divide {W} devices")
        self.workers = workers_of(devices)
        self.devices = [w.device for w in self.workers]
        self.layout = lay

    @property
    def W(self) -> int:
        return len(self.workers)

    @property
    def rep(self) -> int:
        return self.W // self.layout.degree

    def sp_groups(self, lay: Optional[Layout] = None) -> List[List[int]]:
        """The worker indices of each sp group at ``lay`` (default the
        mesh's own): the ``sp`` workers of one replica at one tp
        position, in shard order."""
        lay = lay or self.layout
        return [[r * lay.degree + s * lay.tp + p for s in range(lay.sp)]
                for r in range(self.W // lay.degree) for p in range(lay.tp)]

    def groups(self, t: int) -> List[range]:
        """The worker indices of each TP group at degree ``t``: ``W/t``
        runs of ``t`` consecutive workers."""
        assert self.W % t == 0, (self.W, t)
        return [range(g * t, (g + 1) * t) for g in range(self.W // t)]

    def same_workers(self, other: "InstanceMesh") -> bool:
        return self.workers == other.workers

    # -- exchanges between workers ------------------------------------------
    def replicate(self, x: torch.Tensor, dst: Optional["InstanceMesh"] = None
                  ) -> List[torch.Tensor]:
        """One copy of ``x`` on each worker (of ``dst``)."""
        devs = (dst or self).devices
        TALLY.add("collective-permute", len(devs) * _nbytes(x))
        return [x.to(d, copy=True) for d in devs]

    def all_to_all(self, send: List[torch.Tensor],
                   dst: Optional["InstanceMesh"] = None
                   ) -> List[torch.Tensor]:
        """``send[u]``, from worker u of this mesh, is ``dst.W`` equal
        chunks along dim 0; worker w of ``dst`` (default: this mesh)
        receives chunk w of every ``send[u]``, concatenated in u order."""
        dst = dst or self
        n = send[0].shape[0] // dst.W
        recv, moved = [], 0
        for w, dev in enumerate(dst.devices):
            out = torch.empty((len(send) * n, *send[0].shape[1:]),
                              dtype=send[0].dtype, device=dev)
            for u in range(len(send)):
                piece = send[u][w * n:(w + 1) * n]
                out[u * n:(u + 1) * n].copy_(piece)
                if self.workers[u] != dst.workers[w]:
                    moved += _nbytes(piece)
            recv.append(out)
        TALLY.add("all-to-all", moved)
        return recv

    def all_reduce_sum(self, xs: List[Optional[torch.Tensor]], tp: int
                       ) -> List[Optional[torch.Tensor]]:
        """The sum over each TP group at degree ``tp`` (fp32, in worker
        order, rounded once to the inputs' type), one copy on each worker
        of the group.  A group whose entries are None (it holds none of
        the rows) stays None: groups never mix, since each holds other
        slots' partial products."""
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        for grp in self.groups(tp):
            if xs[grp[0]] is None:
                continue
            total = xs[grp[0]].float()
            for w in grp[1:]:
                total = total + xs[w].to(total.device).float()
            total = total.to(xs[grp[0]].dtype)
            for w in grp:
                out[w] = total.to(self.devices[w], copy=True)
            TALLY.add("all-reduce", 2 * (len(grp) - 1) * _nbytes(total))
        return out

    def group_all_gather(self, xs: List[Optional[torch.Tensor]], tp: int,
                         dim: int) -> List[Optional[torch.Tensor]]:
        """The all-gather inside each TP group at degree ``tp``: every
        member receives the members' tensors concatenated along ``dim``,
        in worker order, in a tensor of its own.  A group whose entries
        are None (it holds none of the rows) stays None."""
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        for grp in self.groups(tp):
            if xs[grp[0]] is None:
                continue
            parts = [xs[u] for u in grp]
            for w in grp:
                out[w] = torch.cat([x.to(self.devices[w]) for x in parts],
                                   dim=dim)
            TALLY.add("all-gather",
                      (len(grp) - 1) * sum(_nbytes(x) for x in parts))
        return out

    def sp_all_gather(self, bufs: List[Optional[torch.Tensor]],
                      lay: Layout) -> None:
        """The all-gather inside each sp group at ``lay``, in place:
        member i of a group holds a buffer of ``sp`` rows whose row i it
        has written itself; its row i is copied into row i of every other
        member's buffer, so each member ends with every member's row (in
        shard order) in a tensor of its own.  A group whose entries are
        None (it holds none of the rows) is skipped."""
        for grp in self.sp_groups(lay):
            if bufs[grp[0]] is None:
                continue
            for i, u in enumerate(grp):
                for w in grp:
                    if w != u:
                        bufs[w][i].copy_(bufs[u][i])
            TALLY.add("all-gather",
                      (len(grp) - 1) * sum(_nbytes(bufs[u][i])
                                           for i, u in enumerate(grp)))

    def all_gather(self, xs: List[torch.Tensor], dim: int,
                   dst: Optional["InstanceMesh"] = None
                   ) -> List[torch.Tensor]:
        """Each worker (of ``dst``) receives this mesh's workers' tensors
        concatenated along ``dim``, in worker order."""
        outs, moved = [], 0
        dst = dst or self
        for wk in dst.workers:
            shape = list(xs[0].shape)
            shape[dim] = sum(x.shape[dim] for x in xs)
            out = torch.empty(shape, dtype=xs[0].dtype, device=wk.device)
            o = 0
            for u, x in enumerate(xs):
                out.narrow(dim, o, x.shape[dim]).copy_(x)
                o += x.shape[dim]
                if self.workers[u] != wk:
                    moved += _nbytes(x)
            outs.append(out)
        TALLY.add("all-gather", moved)
        return outs


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# The training grid
# ---------------------------------------------------------------------------

def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one placement entry (None, a name or a tuple of
    names), as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Grid:
    """W workers as the reference's production mesh: ``(data, model)``,
    or ``(pod, data, model)``, in the order of its reshape of the device
    list (the last axis fastest: worker ``d*M + m`` of a D x M grid is
    at data d, model m).  ``devices`` are workers or devices
    (``workers_of``; they may repeat); ``shape`` one size an axis."""

    def __init__(self, devices: Sequence, shape: Sequence[int],
                 axes: Optional[Sequence[str]] = None):
        shape = tuple(int(n) for n in shape)
        if axes is None:
            axes = (("data", "model") if len(shape) == 2
                    else ("pod", "data", "model"))
        axes = tuple(axes)
        if len(axes) != len(shape) or math.prod(shape) != len(devices):
            raise ValueError(f"a {shape} grid over axes {axes} does not "
                             f"take {len(devices)} workers")
        self.workers = workers_of(devices)
        self.devices = [w.device for w in self.workers]
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))

    @property
    def W(self) -> int:
        return len(self.workers)

    def coords(self, w: int) -> Dict[str, int]:
        """Worker w's coordinate on each axis."""
        out = {}
        for a in reversed(self.axis_names):
            w, out[a] = divmod(w, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def extent(self, axes: Sequence[str]) -> int:
        """The number of workers along ``axes`` together."""
        return math.prod(self.shape[a] for a in axes)

    def position(self, w: int, axes: Sequence[str]) -> int:
        """Worker w's index along ``axes`` taken together, the first
        axis slowest (a ``PartitionSpec`` entry's order)."""
        c, i = self.coords(w), 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The workers that differ only along ``axes``, one list a
        group, each in ``position`` order."""
        out: Dict[Tuple, List[int]] = {}
        for w in range(self.W):
            c = self.coords(w)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            out.setdefault(key, []).append(w)
        return [sorted(g, key=lambda w: self.position(w, axes))
                for g in out.values()]

    # -- exchanges (autograd functions; every one tallied) ---------------
    def _moved(self, u: int, w: int) -> bool:
        return self.workers[u] != self.workers[w]

    def all_gather(self, xs: List[torch.Tensor], axes, dim: int
                   ) -> List[torch.Tensor]:
        """Each worker receives the tensors of its group along ``axes``
        (a name or a tuple) concatenated along ``dim`` in position
        order, in a tensor of its own; the gradient is summed back into
        each worker's piece (a reduce-scatter)."""
        axes = spec_axes(axes)
        out: List[Optional[torch.Tensor]] = [None] * self.W
        for grp in self.groups(axes):
            outs = []
            for w in grp:
                pieces, o = [], 0
                for u in grp:
                    n = xs[u].shape[dim]
                    pieces.append((grp.index(u), 0, n, o))
                    o += n
                outs.append((w, pieces))
            for w, y in zip(grp, self._route(xs, grp, outs, dim,
                                             "all-gather", "reduce-scatter")):
                out[w] = y
        return out

    def all_to_all(self, xs: List[torch.Tensor], axes, dim: int,
                   pieces_of) -> List[torch.Tensor]:
        """Inside each group along ``axes``: member i receives
        ``pieces_of(i)``, a list of ``(member j, start, length)`` slices
        of member j's tensor along ``dim``, concatenated; the gradient
        goes back the same way (the reverse all-to-all)."""
        axes = spec_axes(axes)
        out: List[Optional[torch.Tensor]] = [None] * self.W
        for grp in self.groups(axes):
            outs = []
            for i, w in enumerate(grp):
                pieces, o = [], 0
                for j, a, n in pieces_of(i):
                    pieces.append((j, a, n, o))
                    o += n
                outs.append((w, pieces))
            for w, y in zip(grp, self._route(xs, grp, outs, dim,
                                             "all-to-all", "all-to-all")):
                out[w] = y
        return out

    def _route(self, xs, grp, outs, dim, kind, bwd_kind):
        srcs = [xs[u] for u in grp]
        plan = _RoutePlan(self, grp, outs, dim, kind, bwd_kind)
        return _Route.apply(plan, *srcs)

    def all_reduce_sum(self, xs: List[torch.Tensor], axes
                       ) -> List[torch.Tensor]:
        """The sum over each group along ``axes`` (in fp32, in position
        order, rounded once to the inputs' type), one copy on each
        member; the gradient is the all-reduce-sum of the copies'
        gradients.  A group whose first entry is None is skipped."""
        axes = spec_axes(axes)
        out: List[Optional[torch.Tensor]] = [None] * self.W
        for grp in self.groups(axes):
            if xs[grp[0]] is None:
                continue
            ys = _ReduceSum.apply(self, grp, *[xs[u] for u in grp])
            for w, y in zip(grp, ys):
                out[w] = y
        return out

    @torch.no_grad()
    def all_reduce_max(self, xs: List[torch.Tensor], axes
                       ) -> List[torch.Tensor]:
        """The elementwise max over each group along ``axes``, one copy
        on each member (no gradient)."""
        axes = spec_axes(axes)
        out: List[Optional[torch.Tensor]] = [None] * self.W
        for grp in self.groups(axes):
            total = xs[grp[0]]
            for u in grp[1:]:
                total = torch.maximum(total, xs[u].to(total.device))
            for w in grp:
                out[w] = total.to(self.devices[w], copy=True)
            TALLY.add("all-reduce", 2 * (len(grp) - 1) * _nbytes(total))
        return out


class _RoutePlan:
    """What ``_Route`` builds: for each output ``(worker, pieces)``, the
    pieces ``(source member, start, length, offset)`` along ``dim``."""

    def __init__(self, grid: Grid, grp, outs, dim: int, kind: str,
                 bwd_kind: str):
        self.grid, self.grp, self.outs, self.dim = grid, grp, outs, dim
        self.kind, self.bwd_kind = kind, bwd_kind


class _Route(torch.autograd.Function):
    """Outputs assembled from slices of the inputs, each on its worker's
    device in a tensor of its own; the backward adds each output's
    gradient into the slices it came from (fp32 sums, in output
    order)."""

    @staticmethod
    def forward(ctx, plan: _RoutePlan, *xs):
        ctx.plan = plan
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        g, dim, moved, ys = plan.grid, plan.dim, 0, []
        for w, pieces in plan.outs:
            shape = list(xs[0].shape)
            shape[dim] = sum(n for _, _, n, _ in pieces)
            y = torch.empty(shape, dtype=xs[0].dtype, device=g.devices[w])
            for j, a, n, o in pieces:
                piece = xs[j].narrow(dim, a, n)
                y.narrow(dim, o, n).copy_(piece)
                if g._moved(plan.grp[j], w):
                    moved += _nbytes(piece)
            ys.append(y)
        ctx.moved = moved
        TALLY.add(plan.kind, moved)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *grads):
        plan, dim = ctx.plan, ctx.plan.dim
        acc = [torch.zeros(shape, dtype=torch.float32, device=dev)
               for shape, _, dev in ctx.meta]
        for (w, pieces), gy in zip(plan.outs, grads):
            if gy is None:
                continue
            for j, a, n, o in pieces:
                acc[j].narrow(dim, a, n).add_(
                    gy.narrow(dim, o, n).to(acc[j].device, torch.float32))
        TALLY.add(plan.bwd_kind, ctx.moved)
        return (None, *(a.to(dt) for a, (_, dt, _) in zip(acc, ctx.meta)))


class _ReduceSum(torch.autograd.Function):
    """The sum of a group's tensors, one copy on each member."""

    @staticmethod
    def forward(ctx, grid: Grid, grp, *xs):
        ctx.grid, ctx.grp = grid, grp
        ctx.dtypes = [x.dtype for x in xs]
        ys = _sum_to(grid, grp, xs)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *grads):
        grid, grp = ctx.grid, ctx.grp
        ref = next(g for g in grads if g is not None)
        gs = [torch.zeros_like(ref) if g is None else g for g in grads]
        ys = _sum_to(grid, grp, gs)
        return (None, None, *(y.to(dt) for y, dt in zip(ys, ctx.dtypes)))


def _sum_to(grid: Grid, grp, xs) -> List[torch.Tensor]:
    total = xs[0].float()
    for x in xs[1:]:
        total = total + x.to(total.device).float()
    total = total.to(xs[0].dtype)
    TALLY.add("all-reduce", 2 * (len(grp) - 1) * _nbytes(total))
    return [total.to(grid.devices[w], copy=True) for w in grp]


def make_production_mesh(workers: Sequence, *, multi_pod: bool = False
                         ) -> Grid:
    """The reference's production mesh over ``workers``: (data=16,
    model=16), or (pod=2, data=16, model=16) with ``multi_pod``."""
    return Grid(workers, (2, 16, 16) if multi_pod else (16, 16))


def make_host_mesh(workers: Sequence) -> "InstanceMesh":
    """A single host's instance group (the transformation's scope): the
    workers at TP1 each, as the reference's ``("worker",)`` mesh."""
    return InstanceMesh(workers, 1)


def batch_axes(grid: Grid) -> Tuple[str, ...]:
    """Axes a batch dimension shards over (pod and data when present)."""
    return tuple(a for a in ("pod", "data") if a in grid.axis_names)


def model_axis_size(grid: Grid) -> int:
    return grid.shape["model"]


def data_axis_size(grid: Grid) -> int:
    n = grid.shape["data"]
    if "pod" in grid.axis_names:
        n *= grid.shape["pod"]
    return n
