"""Per-slot state of a recurrent (RG-LRU) block.

Where an attention layer keeps a slot's context as KV pages
(``paged.pool.PagedState``), a recurrent layer keeps O(1) state a slot:
the temporal conv's trailing inputs and the RG-LRU hidden state, both in
the model's dtype (the reference's ``{"conv": (B, K-1, d), "h": (B, d)}``
cache, ``repro/models/blocks.py:613-615``).  The state is updated IN
PLACE, as the paged pool is: a slot view (``rows``) aliases the engine's
rows.  ``block`` is the scan block of the layer's sequence forms
(``models.layers.rglru``): the engine's page size, so chunk boundaries,
which are page-aligned, fall on block boundaries.

On an engine with workers a layer's state rows follow the replica's
slots and are replicated over its sp and tp workers (the reference's
spec: the batch axis over ``rep``, ``core/instance.py:117-122``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Sequence

import torch

CONV_K = 4  # griffin temporal conv width (the reference's ``CONV_K``)


@dataclass
class RecState:
    """conv: (B, CONV_K - 1, d) trailing conv inputs; h: (B, d) RG-LRU
    state; ``block``: the scan block in tokens."""
    conv: torch.Tensor
    h: torch.Tensor
    block: int

    #: the engine's per-slot cache protocol of ``paged.pool.PagedState``;
    #: a state holds no keys, so ``sanitize_``, ``pin_`` and ``empty_``
    #: leave it (a prefill's carry is restored by the engine) and it
    #: ``spans`` no token count (it never grows, spills or resizes)
    recurrent: ClassVar[bool] = True

    @property
    def batch(self) -> int:
        return self.h.shape[0]

    def slot(self, i: int) -> "RecState":
        """Batch-1 in-place view of row ``i``."""
        return self.rows(i, i + 1)

    def sanitize_(self, done: int) -> None:
        pass

    def pin_(self, done: int) -> None:
        pass

    def empty_(self) -> None:
        pass

    def spans(self, cap: int) -> bool:
        return False

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.conv, self.h))

    def rows(self, lo: int, hi: int) -> "RecState":
        """An in-place view of rows [lo, hi)."""
        return RecState(self.conv[lo:hi], self.h[lo:hi], self.block)

    def clone(self) -> "RecState":
        return RecState(self.conv.clone(), self.h.clone(), self.block)

    def to(self, device) -> "RecState":
        """A copy on ``device`` that shares no storage with this one."""
        return RecState(self.conv.to(device, copy=True),
                        self.h.to(device, copy=True), self.block)

    def copy_(self, src: "RecState") -> None:
        """Overwrite these rows with ``src``'s (which may lie on another
        device)."""
        self.conv.copy_(src.conv)
        self.h.copy_(src.h)

    def zero_(self) -> None:
        self.conv.zero_()
        self.h.zero_()


def make_rec_state(batch: int, d: int, dtype, block: int, *, device
                   ) -> RecState:
    """A fresh state: zeros, the sequence forms' ``state=None`` init."""
    return RecState(torch.zeros((batch, CONV_K - 1, d), dtype=dtype,
                                device=device),
                    torch.zeros((batch, d), dtype=dtype, device=device),
                    block)


def cat_rows(states: Sequence[RecState], device) -> RecState:
    """The states' rows in order, one new state on ``device``."""
    return RecState(torch.cat([s.conv.to(device) for s in states]),
                    torch.cat([s.h.to(device) for s in states]),
                    states[0].block)
