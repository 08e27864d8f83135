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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


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
        return [x.to(d, copy=True) for d in (dst or self).devices]

    def all_to_all(self, send: List[torch.Tensor],
                   dst: Optional["InstanceMesh"] = None
                   ) -> List[torch.Tensor]:
        """``send[u]``, from worker u of this mesh, is ``dst.W`` equal
        chunks along dim 0; worker w of ``dst`` (default: this mesh)
        receives chunk w of every ``send[u]``, concatenated in u order."""
        dst = dst or self
        n = send[0].shape[0] // dst.W
        recv = []
        for w, dev in enumerate(dst.devices):
            out = torch.empty((len(send) * n, *send[0].shape[1:]),
                              dtype=send[0].dtype, device=dev)
            for u in range(len(send)):
                out[u * n:(u + 1) * n].copy_(send[u][w * n:(w + 1) * n])
            recv.append(out)
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

    def all_gather(self, xs: List[torch.Tensor], dim: int,
                   dst: Optional["InstanceMesh"] = None
                   ) -> List[torch.Tensor]:
        """Each worker (of ``dst``) receives this mesh's workers' tensors
        concatenated along ``dim``, in worker order."""
        outs = []
        for dev in (dst or self).devices:
            shape = list(xs[0].shape)
            shape[dim] = sum(x.shape[dim] for x in xs)
            out = torch.empty(shape, dtype=xs[0].dtype, device=dev)
            o = 0
            for x in xs:
                out.narrow(dim, o, x.shape[dim]).copy_(x)
                o += x.shape[dim]
            outs.append(out)
        return outs
