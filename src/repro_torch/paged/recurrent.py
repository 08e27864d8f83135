"""Per-slot state of a recurrent block (RG-LRU, mLSTM, sLSTM).

Where an attention layer keeps a slot's context as KV pages
(``paged.pool.PagedState``), a recurrent layer keeps O(1) state a slot,
as named leaves whose axis 0 is the slot (the reference's recurrent
caches, ``repro/models/blocks.py:613-629``):

* RGLRU: ``conv (B, K-1, d)``, the temporal conv's trailing inputs, and
  ``h (B, d)``, in the model's dtype;
* MLSTM: the matrix memory ``C (B, H, dh, dh)``, its normaliser ``n (B,
  H, dh)`` and stabiliser ``m (B, H)``, fp32 at any model dtype;
* SLSTM: ``c``, ``n``, ``m``, ``h`` (B, d each), fp32.

A fresh state is not all zeros: mLSTM's ``m`` starts at ``NEG_INF`` and
sLSTM's ``n`` at 1, the ``state=None`` init of the reference's sequence
functions; ``fresh_`` writes each leaf's own start value.  The state is
updated IN PLACE, as the paged pool is: a slot view (``rows``) aliases
the engine's rows.  ``block`` is the block of the layer's sequence
forms (``models.layers.rglru`` / ``mlstm_chunkwise``): the engine's page
size, so chunk boundaries, which are page-aligned, fall on block
boundaries.

On an engine with workers a layer's state rows follow the replica's
slots and are replicated over its sp and tp workers (the reference's
spec: the batch axis over ``rep``, ``core/instance.py:117-122``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Dict, Sequence

import torch

from repro_torch.configs.base import MLSTM, RGLRU, SLSTM, ModelConfig

CONV_K = 4  # griffin temporal conv width (the reference's ``CONV_K``)
NEG_INF = -1e30  # the reference's finite -inf (``models.layers.NEG_INF``)


@dataclass
class RecState:
    """``leaves``: the state's tensors by name, rows on axis 0, readable
    as attributes (``state.h``, ``state.C``); ``block``: the sequence
    forms' block in tokens; ``start``: each leaf's fresh value (0 where
    not named)."""
    leaves: Dict[str, torch.Tensor]
    block: int
    start: Dict[str, float] = field(default_factory=dict)

    #: the engine's per-slot cache protocol of ``paged.pool.PagedState``;
    #: a state holds no keys, so ``sanitize_``, ``pin_`` and ``empty_``
    #: leave it (a prefill's carry is restored by the engine) and it
    #: ``spans`` no token count (it never grows, spills or resizes)
    recurrent: ClassVar[bool] = True

    def __getattr__(self, name: str) -> torch.Tensor:
        leaves = self.__dict__.get("leaves")
        if leaves is not None and name in leaves:
            return leaves[name]
        raise AttributeError(name)

    @property
    def batch(self) -> int:
        return next(iter(self.leaves.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.leaves.values())).device

    def _map(self, fn) -> "RecState":
        return RecState({k: fn(v) for k, v in self.leaves.items()},
                        self.block, self.start)

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
        return sum(t.numel() * t.element_size()
                   for t in self.leaves.values())

    def rows(self, lo: int, hi: int) -> "RecState":
        """An in-place view of rows [lo, hi)."""
        return self._map(lambda t: t[lo:hi])

    def clone(self) -> "RecState":
        return self._map(torch.clone)

    def to(self, device) -> "RecState":
        """A copy on ``device`` that shares no storage with this one."""
        return self._map(lambda t: t.to(device, copy=True))

    def copy_(self, src: "RecState") -> None:
        """Overwrite these rows with ``src``'s (which may lie on another
        device)."""
        for k, t in self.leaves.items():
            t.copy_(src.leaves[k])

    def fresh_(self) -> None:
        """Every leaf at its start value: the state a prefill begins
        from."""
        for k, t in self.leaves.items():
            t.fill_(self.start.get(k, 0.0))


def make_rec_state(batch: int, d: int, dtype, block: int, *, device
                   ) -> RecState:
    """A fresh RG-LRU state: zeros, the sequence forms' ``state=None``
    init."""
    return RecState({"conv": torch.zeros((batch, CONV_K - 1, d), dtype=dtype,
                                         device=device),
                     "h": torch.zeros((batch, d), dtype=dtype,
                                      device=device)}, block)


def make_mlstm_state(batch: int, heads: int, dh: int, block: int, *, device
                     ) -> RecState:
    """A fresh mLSTM state, fp32: ``C`` and ``n`` zero, ``m`` at
    ``NEG_INF``."""
    shapes = {"C": (heads, dh, dh), "n": (heads, dh), "m": (heads,)}
    st = RecState({k: torch.zeros((batch, *v), dtype=torch.float32,
                                  device=device) for k, v in shapes.items()},
                  block, {"m": NEG_INF})
    st.fresh_()
    return st


def make_slstm_state(batch: int, d: int, block: int, *, device) -> RecState:
    """A fresh sLSTM state, fp32: ``c``, ``m``, ``h`` zero, ``n`` one."""
    st = RecState({k: torch.zeros((batch, d), dtype=torch.float32,
                                  device=device) for k in "cnmh"},
                  block, {"n": 1.0})
    st.fresh_()
    return st


def make_state_of(kind: str, cfg: ModelConfig, batch: int, block: int, *,
                  device) -> RecState:
    """A fresh state of ``batch`` rows for a recurrent layer of
    ``kind``."""
    if kind == RGLRU:
        return make_rec_state(batch, cfg.d_model, getattr(torch, cfg.dtype),
                              block, device=device)
    if kind == MLSTM:   # the reference's up = 2 * d_model over the heads
        return make_mlstm_state(batch, cfg.num_heads,
                                2 * cfg.d_model // cfg.num_heads, block,
                                device=device)
    assert kind == SLSTM, kind
    return make_slstm_state(batch, cfg.d_model, block, device=device)


def cat_rows(states: Sequence[RecState], device) -> RecState:
    """The states' rows in order, one new state on ``device``."""
    s0 = states[0]
    return RecState({k: torch.cat([s.leaves[k].to(device) for s in states])
                     for k in s0.leaves}, s0.block, s0.start)
