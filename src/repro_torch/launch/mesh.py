"""The instance ``Layout`` and the worker mesh of an engine.

The counterpart of ``repro.launch.mesh``.  The reference is a single
controller: one process drives every device of a ``(rep, sp, tp)``
``jax.sharding.Mesh``, and GSPMD places each array's shards.  The port's
counterpart is one process holding a list of W worker devices, and the
entries may repeat: W x ``cuda:0`` on one card, W x ``cpu`` in the
tests, ``cuda:0..W-1`` on a box with several cards.  Every byte that the
reference's sharding places on worker w lives in a tensor that belongs
to worker w, and no other worker's tensor aliases it, so a change of
layout really copies every byte it moves, even when all workers share
one device.

The exchanges between workers (``all_to_all``, ``all_reduce_sum``,
``all_gather``, ``replicate``) copy between worker tensors with
``Tensor.copy_``: plain data movement, as ``lax.all_to_all`` is in the
reference.  On several cards the same code does peer copies; that path
is not proven (no multi-card run yet), and an NCCL exchange is later
work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch


@dataclass(frozen=True, order=True)
class Layout:
    """A parallelism layout for one serving instance: ``sp`` sequence-
    parallel shards x ``tp`` tensor-parallel shards, ``degree = sp * tp``
    devices per replica."""
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


class InstanceMesh:
    """W worker devices arranged as ``(rep, tp)`` for one layout (sp = 1;
    sequence-parallel layouts are ROADMAP queue 1 item 6)."""

    def __init__(self, devices: Sequence[torch.device], layout):
        lay = Layout.of(layout)
        W = len(devices)
        if lay.sp != 1:
            raise NotImplementedError(
                f"layout {lay}: sequence-parallel layouts are not ported "
                "yet (ROADMAP queue 1 item 6)")
        if W % lay.degree:
            raise ValueError(f"layout {lay} (degree {lay.degree}) does not "
                             f"divide {W} devices")
        self.devices = [torch.device(d) for d in devices]
        self.layout = lay

    @property
    def W(self) -> int:
        return len(self.devices)

    # -- exchanges between workers ------------------------------------------
    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One copy of ``x`` on each worker."""
        return [x.to(d, copy=True) for d in self.devices]

    def all_to_all(self, send: List[torch.Tensor]) -> List[torch.Tensor]:
        """``send[u]`` is W equal chunks along dim 0; worker w receives
        chunk w of every ``send[u]``, concatenated in u order."""
        W = self.W
        n = send[0].shape[0] // W
        recv = []
        for w, dev in enumerate(self.devices):
            out = torch.empty((W * n, *send[0].shape[1:]),
                              dtype=send[0].dtype, device=dev)
            for u in range(W):
                out[u * n:(u + 1) * n].copy_(send[u][w * n:(w + 1) * n])
            recv.append(out)
        return recv

    def all_reduce_sum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over workers (fp32, in worker order, rounded once to
        the inputs' type), one copy on each worker."""
        total = xs[0].float()
        for x in xs[1:]:
            total = total + x.to(total.device).float()
        return self.replicate(total.to(xs[0].dtype))

    def all_gather(self, xs: List[torch.Tensor], dim: int
                   ) -> List[torch.Tensor]:
        """Each worker receives the workers' tensors concatenated along
        ``dim``, in worker order."""
        outs = []
        for dev in self.devices:
            shape = list(xs[0].shape)
            shape[dim] = sum(x.shape[dim] for x in xs)
            out = torch.empty(shape, dtype=xs[0].dtype, device=dev)
            o = 0
            for x in xs:
                out.narrow(dim, o, x.shape[dim]).copy_(x)
                o += x.shape[dim]
            outs.append(out)
        return outs

