"""Parallelism-aware weight padding (paper §4.2, adapted to TPU).

The paper pads ``up_proj`` columns / ``down_proj`` rows at the
pre-determined TP split boundaries so that every shard lands on an
allocator page boundary (CUDA VMM granularity = 2 MB).  On TPU we keep the
2 MiB page-pool granularity *and* add two TPU/GSPMD-specific alignment
requirements that the very same padding trick solves:

  * **lane alignment** — each shard's minor dimension must be a multiple of
    128 so a shard is a whole number of (8, 128) tiles and migration is a
    pure DMA with no re-tiling;
  * **even divisibility** — GSPMD requires sharded dims to divide the mesh
    axis; we pad attention-head counts, KV-head slots, MoE expert counts
    and the vocab to the mesh axis (this generalizes the paper's padding
    beyond the MLP — see DESIGN.md §2).

Padding is *mathematically invisible*: padded ``up_proj`` columns are zero,
padded ``down_proj`` rows are zero, so ``FFN'(x) == FFN(x)`` exactly
(paper Eq. 2); padded attention heads have zero output-projection rows;
padded experts get ``-inf`` router logits.  All of this is property-tested
in ``tests/test_padding.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ModelConfig

PAGE_BYTES = 2 * 1024 * 1024  # allocator granularity (paper: CUDA VMM 2MB)
LANE = 128                    # TPU lane count (minor-most tile dim)
DTYPE_BYTES = 2               # bf16


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def shard_col_unit(d_model: int, page_bytes: int = PAGE_BYTES,
                   dtype_bytes: int = DTYPE_BYTES) -> int:
    """Smallest number of d_ff columns such that a (d_model, cols) shard is
    both lane-aligned and a whole number of allocator pages."""
    # cols * d_model * dtype_bytes ≡ 0 (mod page_bytes)
    g = math.gcd(d_model * dtype_bytes, page_bytes)
    cols_for_page = page_bytes // g
    return math.lcm(cols_for_page, LANE)


@dataclass(frozen=True)
class PaddingPlan:
    """All padded dimensions for one (config, max_tp) pair.

    ``max_tp`` is the largest tensor-parallel degree the instance can
    transform into (paper: TP4 on an 8-GPU host; production mesh: the
    16-wide ``model`` axis).  Padding for max_tp automatically aligns every
    smaller power-of-two TP, because split boundaries nest.
    """
    max_tp: int
    d_model: int
    d_ff: int
    d_ff_padded: int
    num_heads: int
    q_heads_padded: int
    num_kv_heads: int
    kv_padded: int             # kv heads after padding (pre-replication)
    kv_slots: int              # kv heads after pad+replication (divisible
                               # by max_tp, or == kv_padded when kv>=max_tp)
    kv_replication: int        # how many copies of each (padded) kv head
    q_group_size: int          # real q heads per original kv group
    q_group_padded: int        # padded q heads per kv group
    num_experts: int = 0
    experts_padded: int = 0
    vocab: int = 0
    vocab_padded: int = 0
    # True when d_ff shards are allocator-page aligned (zero-copy weight
    # transformation possible); False = padding would exceed the overhead
    # cap, so this model falls back to swap-based MLP migration (a Table-3
    # style finding — e.g. granite's 512-wide experts).
    page_aligned: bool = True

    @property
    def ff_shard(self) -> int:
        return self.d_ff_padded // self.max_tp if self.d_ff_padded else 0

    @property
    def padding_overhead(self) -> float:
        """Fraction of extra MLP weight bytes introduced by d_ff padding
        (paper Fig. 10b reports 0-14%)."""
        if not self.d_ff:
            return 0.0
        return (self.d_ff_padded - self.d_ff) / self.d_ff

    def tp_boundaries(self, tp: int) -> Tuple[int, ...]:
        """Column indices where the padded d_ff is split for a given TP."""
        assert self.d_ff_padded % tp == 0
        step = self.d_ff_padded // tp
        return tuple(step * i for i in range(1, tp))

    def q_head_mask(self) -> Tuple[bool, ...]:
        """mask[h] == True iff padded q slot h holds a real head."""
        mask = []
        n_groups_real = max(1, self.num_heads // max(self.q_group_size, 1))
        for g in range(self.kv_padded):
            for i in range(self.q_group_padded):
                mask.append(g < n_groups_real and i < self.q_group_size)
        return tuple(mask)

    def q_slot_of_head(self, j: int) -> int:
        """Padded slot index of real q head j."""
        g, i = divmod(j, self.q_group_size)
        return g * self.q_group_padded + i

    def kv_head_mask(self) -> Tuple[bool, ...]:
        return tuple(h < self.num_kv_heads for h in range(self.kv_padded))


def make_plan(cfg: ModelConfig, max_tp: int, mode: str = "lane",
              page_bytes: int = PAGE_BYTES,
              max_overhead: float = 0.25) -> PaddingPlan:
    """Build the padding plan.

    mode="lane": lane-align shards only (used for the production-mesh
        sharding, where padding overhead costs real FLOPs).
    mode="page": the paper's §4.2 — additionally align every TP split
        boundary to allocator pages so weight transformation is zero-copy.
        If that would exceed ``max_overhead`` extra d_ff (tiny shards, e.g.
        granite's 512-wide experts), fall back to lane alignment and mark
        ``page_aligned=False`` (the instance then uses swap migration for
        MLP weights — the paper's Basic path).
    """
    d = cfg.d_model

    # ---- d_ff padding (the paper's §4.2, verbatim insight) --------------
    page_aligned = True
    if cfg.d_ff:
        # MoE experts are sharded on the expert axis, so per-expert d_ff
        # shards only need lane alignment on the mesh; page alignment
        # applies to the per-expert tensor for instance transformation.
        # On the mesh, MoE d_ff is NOT sharded (the expert axis is); the
        # per-expert matrix only needs lane alignment there.
        ff_tp = 1 if (cfg.moe is not None and mode == "lane") else max_tp
        base_shard = max(1, -(-cfg.d_ff // ff_tp))
        shard = round_up(base_shard, LANE)
        if mode == "page":
            unit = shard_col_unit(d, page_bytes)
            page_shard = round_up(base_shard, unit)
            if (page_shard * max_tp - cfg.d_ff) / cfg.d_ff <= max_overhead:
                shard = page_shard
            else:
                page_aligned = False
        d_ff_padded = shard * ff_tp
    else:
        d_ff_padded = 0

    # ---- attention head padding (TPU/GSPMD extension) -------------------
    # GQA-group-structured: q heads are padded *within* each kv group so
    # that after padding, padded-q-slot h maps to the same kv head as the
    # real head it came from (tests/test_models.py checks equivalence).
    kv = cfg.num_kv_heads
    gs = max(1, cfg.num_heads // max(kv, 1))  # real q heads per kv group
    if kv >= max_tp:
        kv_padded = round_up(kv, max_tp) if kv % max_tp else kv
        kv_replication = 1
        kv_slots = kv_padded
        gp = gs
    else:
        # Megatron GQA rule: replicate kv heads so each model shard holds
        # one copy. Pad first if kv does not divide max_tp (whisper: 6->8).
        kv_padded = kv
        while max_tp % kv_padded:
            kv_padded += 1
        kv_replication = max_tp // kv_padded
        kv_slots = max_tp
        gp = round_up(gs, kv_replication)
    q_heads_padded = kv_padded * gp

    # ---- expert padding (beyond-paper: same trick on the expert axis) ---
    experts = cfg.moe.num_experts if cfg.moe else 0
    experts_padded = round_up(experts, max_tp) if experts and experts % max_tp else experts

    # ---- vocab padding ---------------------------------------------------
    vocab_padded = round_up(cfg.vocab_size, max_tp * LANE)

    return PaddingPlan(
        max_tp=max_tp,
        d_model=d,
        d_ff=cfg.d_ff,
        d_ff_padded=d_ff_padded,
        num_heads=cfg.num_heads,
        q_heads_padded=q_heads_padded,
        num_kv_heads=kv,
        kv_padded=kv_padded,
        kv_slots=kv_slots,
        kv_replication=kv_replication,
        q_group_size=gs,
        q_group_padded=gp,
        num_experts=experts,
        experts_padded=experts_padded,
        vocab=cfg.vocab_size,
        vocab_padded=vocab_padded,
        page_aligned=page_aligned,
    )


def misalignment_report(cfg: ModelConfig, tps=(1, 2, 4),
                        page_bytes: int = PAGE_BYTES):
    """Paper Table 3: pages-per-tensor for each TP degree; fractional page
    counts mean unaligned placements that force copies without padding."""
    rows = []
    for tp in tps:
        if not cfg.d_ff:
            rows.append((tp, 0.0, True))
            continue
        cols = cfg.d_ff / tp
        pages = cols * cfg.d_model * DTYPE_BYTES / page_bytes
        rows.append((tp, pages, float(pages).is_integer()))
    return rows
