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

Sequence-parallel shards (``shard=(s, sp)``): a state may hold only
shard s of sp of each row's pages, pages ``[s*ns, (s+1)*ns)`` of the
row's ``sp * ns`` (``ns`` = its page-table columns), with the GLOBAL
positions of those slots in ``positions``.  The ring is then the row's
global one, ``sp * capacity`` slots, and each write lands only the
positions whose page the shard holds, at its local page; the cursor
(``seq_lens``) is the row's global one on every shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, List, Optional, Sequence, Tuple

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
    layout: the pool's storage order (``paged.layout.LAYOUTS``); every op
          below defaults to it
    """
    pool: torch.Tensor
    page_table: torch.Tensor
    seq_lens: torch.Tensor
    positions: torch.Tensor
    layout: str = L.CANONICAL

    #: the engine's per-slot cache protocol, shared with
    #: ``paged.recurrent.RecState``: ``slot``, ``clone``, ``copy_``,
    #: ``nbytes``, ``sanitize_``, ``pin_``, ``empty_``, ``spans``
    recurrent: ClassVar[bool] = False

    @property
    def capacity(self) -> int:
        return self.positions.shape[1]

    @property
    def nbytes(self) -> int:
        """Bytes of the pool."""
        return self.pool.numel() * self.pool.element_size()

    def slot(self, i: int) -> "PagedState":
        """Batch-1 in-place view of slot ``i`` (``slot_view``)."""
        return slot_view(self, i)

    def clone(self) -> "PagedState":
        """A copy of the pool and the cursors (the page table shared)."""
        return PagedState(self.pool.clone(), self.page_table,
                          self.seq_lens.clone(), self.positions.clone(),
                          self.layout)

    def copy_(self, src: "PagedState") -> None:
        """Overwrite the pool and cursors with ``src``'s."""
        self.pool.copy_(src.pool)
        self.seq_lens.copy_(src.seq_lens)
        self.positions.copy_(src.positions)

    def sanitize_(self, done: int) -> None:
        """Keep exactly the slots holding prefix tokens (stored position
        in ``[0, done)``: decode filler past the prefix is invalidated)
        and set the cursor to ``done``.  Position-based: on a ring the
        prefix wraps around the slots."""
        keep = (self.positions >= 0) & (self.positions < done)
        self.positions.masked_fill_(~keep, -1)
        self.seq_lens.fill_(done)

    def pin_(self, done: int) -> None:
        """Set the cursor to ``done``."""
        self.seq_lens.fill_(done)

    def empty_(self) -> None:
        """Forget every stored key: positions invalid, cursor 0."""
        self.positions.fill_(-1)
        self.seq_lens.zero_()

    def spans(self, cap: int) -> bool:
        """Whether a slot holds ``cap`` tokens: a full-attention cache at
        that allocation (a window's ring holds its window)."""
        return self.capacity == cap


def make_state(num_pages: int, kv_slots: int, page_tokens: int,
               head_dim: int, batch: int, max_pages_per_seq: int,
               dtype=torch.bfloat16, storage_layout: str = L.CANONICAL,
               *, device) -> PagedState:
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
    return PagedState(pool, pt, seq, pos, storage_layout)


def canonical(pool: torch.Tensor, storage_layout: str) -> torch.Tensor:
    return L.to_layout(pool, storage_layout, L.CANONICAL)


def from_canonical(pool_c: torch.Tensor, storage_layout: str
                   ) -> torch.Tensor:
    return L.to_layout(pool_c, L.CANONICAL, storage_layout)


def kernel_pool(state: PagedState) -> torch.Tensor:
    """The pool in the kernels' canonical order, contiguous: the pool
    itself when it is stored header-centric (no copy), else a copy
    (``commit_kernel_pool`` writes a kernel's in-place changes back)."""
    if state.layout == L.CANONICAL:
        return state.pool
    return canonical(state.pool, state.layout).contiguous()


def commit_kernel_pool(state: PagedState, pool_c: torch.Tensor) -> None:
    """Write ``kernel_pool``'s copy back in the storage order (nothing
    to do when it is the pool itself)."""
    if pool_c is not state.pool:
        state.pool.copy_(from_canonical(pool_c, state.layout))


def slot_view(state: PagedState, slot: int,
              storage_layout: Optional[str] = None) -> PagedState:
    """Batch-1 view of ``slot`` in a slot-partitioned state: the slot's
    own page range, a fresh identity page table, and ``seq_lens`` /
    ``positions`` rows that alias the engine's.  Writes through the view
    land in ``state`` (the reference extracts a copy and adopts it back;
    the bytes end up the same)."""
    lay = storage_layout or state.layout
    mps = state.page_table.shape[-1]
    pool = state.pool.narrow(L.block_axis(lay), slot * mps, mps)
    pt = torch.arange(mps, dtype=state.page_table.dtype,
                      device=state.page_table.device)[None, :]
    return PagedState(pool, pt, state.seq_lens[slot:slot + 1],
                      state.positions[slot:slot + 1], lay)


def write_prefill(state: PagedState, k: torch.Tensor, v: torch.Tensor,
                  storage_layout: Optional[str] = None,
                  shard: Tuple[int, int] = (0, 1)) -> PagedState:
    """Write a full prompt's K/V. k, v: (B, S, kv_slots, head_dim).

    Every page of each row's capacity is written (zeros past the
    prompt).  For ring caches (capacity < S) only the trailing
    ``capacity`` tokens are kept.  On an sp shard, the shard's slots of
    the row's global ring."""
    pool_c = canonical(state.pool, storage_layout or state.layout)
    NP, kvs, _, P, dh = pool_c.shape
    B, S = k.shape[:2]
    s, sp = shard
    local = state.capacity
    cap = local * sp
    dev = k.device
    if S > cap:
        k, v = k[:, S - cap:], v[:, S - cap:]
        pos_vals = torch.arange(S - cap, S, dtype=torch.int32, device=dev)
        # ring offset: token with global pos p lives at slot p % cap, as
        # a chunked prefill and the next decode's append put it (the
        # reference rolls by -(S % cap) instead: ROADMAP queue 3)
        roll = S % cap
        k = torch.roll(k, roll, dims=1)
        v = torch.roll(v, roll, dims=1)
        pos_vals = torch.roll(pos_vals, roll)
    else:
        pos_vals = torch.cat([
            torch.arange(S, dtype=torch.int32, device=dev),
            torch.full((cap - S,), -1, dtype=torch.int32, device=dev)])
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, cap - S))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, cap - S))
    if sp > 1:
        keep = slice(s * local, (s + 1) * local)
        k, v, pos_vals = k[:, keep], v[:, keep], pos_vals[keep]
        cap = local
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
                storage_layout: Optional[str] = None,
                identity_pages: bool = False,
                shard: Tuple[int, int] = (0, 1)) -> PagedState:
    """Write one prefill CHUNK — a contiguous run of prompt tokens
    starting mid-sequence.  k, v: (B, S, kv_slots, head_dim);
    ``positions``: (B, S) the tokens' global positions.  The token with
    global position p lands in ring slot ``p % capacity``."""
    scatter_chunk(state, k, v, positions, storage_layout, identity_pages,
                  shard)
    return adopt_chunk_pool(state, positions, shard)


def scatter_chunk(state: PagedState, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor,
                  storage_layout: Optional[str] = None,
                  identity_pages: bool = False,
                  shard: Tuple[int, int] = (0, 1)) -> None:
    """Pool half of ``write_chunk``: the chunk's K/V bytes only (on an
    sp shard, the tokens whose page it holds).

    A padding token (position < 0) keeps the old bytes, as the CUDA
    chunk scatter does; the reference would write it into ring slot
    ``capacity - 1``.  Chunks the engine builds hold no padding."""
    pool_c = canonical(state.pool, storage_layout or state.layout)
    P = pool_c.shape[3]
    B, S = positions.shape
    s, sp = shard
    slot = positions.long() % (state.capacity * sp) - s * state.capacity
    keep = (positions >= 0) & (slot >= 0) & (slot < state.capacity)
    slot = slot.clamp(0, state.capacity - 1)                 # (B, S)
    kv = torch.stack([k, v], dim=3)                          # (B,S,kvs,2,dh)
    if identity_pages:
        # slot-partitioned pools: row b owns pages [b*mps, (b+1)*mps)
        mps = state.page_table.shape[-1]
        rows = torch.arange(B, device=slot.device)[:, None]
        page_idx = rows * mps + slot // P
    else:
        page_idx = state.page_table.long().gather(1, slot // P)
    pool_c[page_idx[keep], :, :, (slot % P)[keep], :] = kv[keep].to(
        pool_c.dtype)


def adopt_chunk_pool(state: PagedState, positions: torch.Tensor,
                     shard: Tuple[int, int] = (0, 1)) -> PagedState:
    """Metadata half of ``write_chunk``: the chunk-prefill kernel already
    scattered the chunk's K/V into the pool; apply the same
    positions/seq_lens update so the state is indistinguishable.  On an
    sp shard of a chunk of contiguous positions, the shard's slots the
    chunk covers, from the chunk's first position (no host sync)."""
    B, S = positions.shape
    s, sp = shard
    if sp > 1:
        cap, local = state.capacity * sp, state.capacity
        slots = s * local + torch.arange(local, device=positions.device)
        off = (slots[None, :] - positions[:, :1].long()) % cap  # (B, local)
        state.positions.copy_(torch.where(
            off < S, positions[:, :1].long() + off,
            state.positions.long()).to(state.positions.dtype))
        state.seq_lens.copy_(positions[:, -1] + 1)
        return state
    slot = positions.long() % state.capacity
    rows = torch.arange(B, device=positions.device)[:, None]
    state.positions[rows, slot] = positions.to(state.positions.dtype)
    # chunks are contiguous and in order: the last written position + 1
    # is the new sequence length
    state.seq_lens.copy_(positions[:, -1] + 1)
    return state


def append_token(state: PagedState, k: torch.Tensor, v: torch.Tensor,
                 storage_layout: Optional[str] = None,
                 shard: Tuple[int, int] = (0, 1)) -> PagedState:
    """Append one token per sequence at its ``seq_lens`` cursor.
    k, v: (B, kv_slots, head_dim).  On an sp shard only the rows whose
    cursor lies in the shard's pages write (the others rewrite a slot of
    their own row with the bytes it holds: no host sync), and every
    row's cursor advances."""
    pool_c = canonical(state.pool, storage_layout or state.layout)
    P = pool_c.shape[3]
    B = k.shape[0]
    pos = state.seq_lens.long()                       # (B,) global position
    kv = torch.stack([k, v], dim=1).transpose(1, 2)   # (B, kvs, 2, dh)
    rows = torch.arange(B, device=k.device)
    s, sp = shard
    if sp == 1:
        slot = pos % state.capacity
        page_idx = state.page_table.long().gather(
            1, (slot // P)[:, None])[:, 0]
        pool_c[page_idx, :, :, slot % P, :] = kv.to(pool_c.dtype)
        state.positions[rows, slot] = state.seq_lens
    else:
        slot = pos % (state.capacity * sp) - s * state.capacity
        own = (slot >= 0) & (slot < state.capacity)
        slot = slot.clamp(0, state.capacity - 1)
        page_idx = state.page_table.long().gather(
            1, (slot // P)[:, None])[:, 0]
        old = pool_c[page_idx, :, :, slot % P, :]
        pool_c[page_idx, :, :, slot % P, :] = torch.where(
            own[:, None, None, None], kv.to(pool_c.dtype), old)
        state.positions[rows, slot] = torch.where(
            own, state.seq_lens, state.positions[rows, slot])
    state.seq_lens.add_(1)
    return state


def concat_spilled(states: Sequence[PagedState],
                   storage_layout: Optional[str] = None) -> PagedState:
    """Distributed-pool READ view (the reference's ``concat_spilled``):
    stitch a batch-1 slot state together from its local pages and the
    overflow page segments hosted in neighbour pools, as one
    identity-paged state whose capacity is the sum of the parts.

    ``states[0]`` is the local (guest) part and is authoritative for
    ``seq_lens``; the rest are host segments in spill order, on any
    device (they are copied to the local part's).  Every part is a
    batch-1 identity-paged state (an engine's slot view), so the
    concatenated state is indistinguishable from one big slot: the
    decode and chunk-prefill kernels run on it unchanged.  The result
    is a copy: nothing of it aliases a part."""
    head = states[0]
    lay = storage_layout or head.layout
    dev = head.pool.device
    pool = torch.cat([s.pool.to(dev) for s in states],
                     dim=L.block_axis(lay))
    mps = sum(int(s.page_table.shape[-1]) for s in states)
    pt = torch.arange(mps, dtype=head.page_table.dtype, device=dev).expand(
        *head.page_table.shape[:-1], mps).contiguous()
    pos = torch.cat([s.positions.to(dev) for s in states], dim=-1)
    return PagedState(pool, pt, head.seq_lens.clone(), pos, lay)


def split_spilled(state: PagedState, page_counts: Sequence[int],
                  storage_layout: Optional[str] = None) -> List[PagedState]:
    """Inverse of ``concat_spilled``: cut the extended state back into
    its local and host segments (``page_counts`` pages each, summing to
    the state's page count).  Each part is a self-contained batch-1
    identity-paged state whose pool and positions are VIEWS of
    ``state``'s; the first (local) part carries the true ``seq_lens``,
    host parts zeros (their metadata is the positions slice: the host
    never reads a guest's cursor)."""
    total = sum(page_counts)
    assert total == int(state.page_table.shape[-1]), (
        page_counts, tuple(state.page_table.shape))
    P = state.positions.shape[-1] // total
    lay = storage_layout or state.layout
    axis = L.block_axis(lay)
    out: List[PagedState] = []
    page0 = 0
    for i, n in enumerate(page_counts):
        pool = state.pool.narrow(axis, page0, n)
        pt = torch.arange(n, dtype=state.page_table.dtype,
                          device=state.page_table.device).expand(
            *state.page_table.shape[:-1], n).contiguous()
        pos = state.positions.narrow(-1, page0 * P, n * P)
        seq = (state.seq_lens if i == 0
               else torch.zeros_like(state.seq_lens))
        out.append(PagedState(pool, pt, seq, pos, lay))
        page0 += n
    return out


def gather_kv(state: PagedState, storage_layout: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Materialize (k, v, kv_positions, valid) for attention — the dense
    plain path.  k, v: (B, capacity, kv_slots, dh)."""
    pool_c = canonical(state.pool, storage_layout or state.layout)
    NP, kvs, _, P, dh = pool_c.shape
    B, n = state.page_table.shape
    pages = pool_c[state.page_table.long()]           # (B, n, kvs, 2, P, dh)
    kv = pages.permute(0, 1, 4, 3, 2, 5).reshape(B, n * P, 2, kvs, dh)
    valid = state.positions >= 0
    return kv[:, :, 0], kv[:, :, 1], state.positions, valid
