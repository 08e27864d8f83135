"""Paged KV pool operations on torch tensors (layout-aware).

The pool is one tensor per layer whose axis order is given by the layout
(see ``repro_torch.paged.layout``).  Every op works in the *canonical*
(header-centric) view, a permuted view of the storage tensor, so kernels
never change when the storage layout changes.

Unlike the JAX reference, whose arrays are immutable and whose ops
rebuild the state, every write here updates the state's tensors IN
PLACE and returns the same ``PagedState``: the pool of a full-size model
is gigabytes, and the engine hands out slot views (``slot_view``) whose
writes must land in its own pool.  The bytes written are the
reference's, bit for bit, except for padding tokens of a chunk
(``scatter_chunk``).

The cache is a ring buffer over ``capacity = max_pages_per_seq *
page_tokens`` token slots: full-attention caches never wrap (capacity >=
max seq len); sliding-window caches set capacity = window.
``positions`` records each slot's global position for masking (-1 =
empty).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.paged import layout as L


@dataclass
class PagedState:
    """Per-layer paged KV cache.

    pool: layout-ordered page pool; canonical view is
          (num_pages, kv_slots, 2, page_tokens, head_dim)
    page_table: (B, max_pages_per_seq) int32 pool page per logical page
    seq_lens: (B,) int32 tokens written so far (global, may exceed
          capacity)
    positions: (B, capacity) int32 global position stored in each slot
    """
    pool: torch.Tensor
    page_table: torch.Tensor
    seq_lens: torch.Tensor
    positions: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.positions.shape[1]


def make_state(num_pages: int, kv_slots: int, page_tokens: int,
               head_dim: int, batch: int, max_pages_per_seq: int,
               dtype=torch.bfloat16, storage_layout: str = L.CANONICAL,
               device="cpu") -> PagedState:
    pool = torch.zeros(L.pool_shape(storage_layout, num_pages, kv_slots,
                                    page_tokens, head_dim),
                       dtype=dtype, device=device)
    # default identity mapping: seq b owns pages [b*mps, (b+1)*mps)
    pt = (torch.arange(batch, device=device)[:, None] * max_pages_per_seq
          + torch.arange(max_pages_per_seq, device=device)[None, :]
          ).to(torch.int32)
    pos = torch.full((batch, max_pages_per_seq * page_tokens), -1,
                     dtype=torch.int32, device=device)
    seq = torch.zeros((batch,), dtype=torch.int32, device=device)
    return PagedState(pool, pt, seq, pos)


def canonical(pool: torch.Tensor, storage_layout: str) -> torch.Tensor:
    return L.to_layout(pool, storage_layout, L.CANONICAL)


def from_canonical(pool_c: torch.Tensor, storage_layout: str
                   ) -> torch.Tensor:
    return L.to_layout(pool_c, L.CANONICAL, storage_layout)


def slot_view(state: PagedState, slot: int,
              storage_layout: str = L.CANONICAL) -> PagedState:
    """Batch-1 view of ``slot`` in a slot-partitioned state: the slot's
    own page range, a fresh identity page table, and ``seq_lens`` /
    ``positions`` rows that alias the engine's.  Writes through the view
    land in ``state`` (the reference extracts a copy and adopts it back;
    the bytes end up the same)."""
    mps = state.page_table.shape[-1]
    pool = state.pool.narrow(L.block_axis(storage_layout), slot * mps, mps)
    pt = torch.arange(mps, dtype=state.page_table.dtype,
                      device=state.page_table.device)[None, :]
    return PagedState(pool, pt, state.seq_lens[slot:slot + 1],
                      state.positions[slot:slot + 1])


def write_prefill(state: PagedState, k: torch.Tensor, v: torch.Tensor,
                  storage_layout: str = L.CANONICAL) -> PagedState:
    """Write a full prompt's K/V. k, v: (B, S, kv_slots, head_dim).

    Every page of each row's capacity is written (zeros past the
    prompt).  For ring caches (capacity < S) only the trailing
    ``capacity`` tokens are kept."""
    pool_c = canonical(state.pool, storage_layout)
    NP, kvs, _, P, dh = pool_c.shape
    B, S = k.shape[:2]
    cap = state.capacity
    dev = k.device
    if S > cap:
        k, v = k[:, S - cap:], v[:, S - cap:]
        pos_vals = torch.arange(S - cap, S, dtype=torch.int32, device=dev)
        # ring offset: token with global pos p lives at slot p % cap
        roll = (-(S % cap)) % cap
        k = torch.roll(k, roll, dims=1)
        v = torch.roll(v, roll, dims=1)
        pos_vals = torch.roll(pos_vals, roll)
    else:
        pos_vals = torch.cat([
            torch.arange(S, dtype=torch.int32, device=dev),
            torch.full((cap - S,), -1, dtype=torch.int32, device=dev)])
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, cap - S))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, cap - S))
    n = cap // P
    kv = torch.stack([k, v], dim=2)                   # (B, cap, 2, kvs, dh)
    kv = kv.reshape(B, n, P, 2, kvs, dh).permute(0, 1, 4, 3, 2, 5)
    idx = state.page_table[:, :n].reshape(-1).long()
    pool_c[idx] = kv.reshape(B * n, kvs, 2, P, dh).to(pool_c.dtype)
    state.positions.copy_(pos_vals[None, :].expand(B, cap))
    state.seq_lens.fill_(S)
    return state


def write_chunk(state: PagedState, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor,
                storage_layout: str = L.CANONICAL,
                identity_pages: bool = False) -> PagedState:
    """Write one prefill CHUNK — a contiguous run of prompt tokens
    starting mid-sequence.  k, v: (B, S, kv_slots, head_dim);
    ``positions``: (B, S) the tokens' global positions.  The token with
    global position p lands in ring slot ``p % capacity``."""
    scatter_chunk(state, k, v, positions, storage_layout, identity_pages)
    return adopt_chunk_pool(state, positions)


def scatter_chunk(state: PagedState, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor,
                  storage_layout: str = L.CANONICAL,
                  identity_pages: bool = False) -> None:
    """Pool half of ``write_chunk``: the chunk's K/V bytes only.

    A padding token (position < 0) keeps the old bytes, as the CUDA
    chunk scatter does; the reference would write it into ring slot
    ``capacity - 1``.  Chunks the engine builds hold no padding."""
    pool_c = canonical(state.pool, storage_layout)
    P = pool_c.shape[3]
    B, S = positions.shape
    slot = positions.long() % state.capacity                 # (B, S)
    kv = torch.stack([k, v], dim=3)                          # (B,S,kvs,2,dh)
    if identity_pages:
        # slot-partitioned pools: row b owns pages [b*mps, (b+1)*mps)
        mps = state.page_table.shape[-1]
        rows = torch.arange(B, device=slot.device)[:, None]
        page_idx = rows * mps + slot // P
    else:
        page_idx = state.page_table.long().gather(1, slot // P)
    keep = positions >= 0
    pool_c[page_idx[keep], :, :, (slot % P)[keep], :] = kv[keep].to(
        pool_c.dtype)


def adopt_chunk_pool(state: PagedState, positions: torch.Tensor
                     ) -> PagedState:
    """Metadata half of ``write_chunk``: the chunk-prefill kernel already
    scattered the chunk's K/V into the pool; apply the same
    positions/seq_lens update so the state is indistinguishable."""
    B, S = positions.shape
    slot = positions.long() % state.capacity
    rows = torch.arange(B, device=positions.device)[:, None]
    state.positions[rows, slot] = positions.to(state.positions.dtype)
    # chunks are contiguous and in order: the last written position + 1
    # is the new sequence length
    state.seq_lens.copy_(positions[:, -1] + 1)
    return state


def append_token(state: PagedState, k: torch.Tensor, v: torch.Tensor,
                 storage_layout: str = L.CANONICAL) -> PagedState:
    """Append one token per sequence at its ``seq_lens`` cursor.
    k, v: (B, kv_slots, head_dim)."""
    pool_c = canonical(state.pool, storage_layout)
    P = pool_c.shape[3]
    B = k.shape[0]
    pos = state.seq_lens.long()                       # (B,) global position
    slot = pos % state.capacity
    kv = torch.stack([k, v], dim=1).transpose(1, 2)   # (B, kvs, 2, dh)
    page_idx = state.page_table.long().gather(1, (slot // P)[:, None])[:, 0]
    pool_c[page_idx, :, :, slot % P, :] = kv.to(pool_c.dtype)
    rows = torch.arange(B, device=k.device)
    state.positions[rows, slot] = state.seq_lens
    state.seq_lens.add_(1)
    return state


def gather_kv(state: PagedState, storage_layout: str = L.CANONICAL
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Materialize (k, v, kv_positions, valid) for attention — the dense
    plain path.  k, v: (B, capacity, kv_slots, dh)."""
    pool_c = canonical(state.pool, storage_layout)
    NP, kvs, _, P, dh = pool_c.shape
    B, n = state.page_table.shape
    pages = pool_c[state.page_table.long()]           # (B, n, kvs, 2, P, dh)
    kv = pages.permute(0, 1, 4, 3, 2, 5).reshape(B, n * P, 2, kvs, dh)
    valid = state.positions >= 0
    return kv[:, :, 0], kv[:, :, 1], state.positions, valid
