"""KV-cache transformation across TP layouts (paper §4.1.2).

The counterpart of ``repro.core.kv_transform``.  Two planes:

* **Accounting plane** (host, ported as is): segment, byte and peak-page
  accounting of the paper's Fig. 9 layouts, with an explicit link model
  (bytes over bandwidth plus a per-segment overhead).  ``LinkModel()``'s
  defaults are NVLink-class constants, not an H100 measurement: the
  ``modeled_s`` a transform session reports is a model until a fit on
  the card (ROADMAP queue 1 item 9) replaces them.  The reference's TPU
  link constants have no counterpart here.
* **Data plane** (torch): pool merge/split references, the slot-capacity
  resize, the cross-engine slot export and import (a merge donor's
  in-flight KV: ``export_slot`` packs a slot's pages with the gather
  kernel, ``import_slot`` lands them at the head of a free slot's wider
  page range with the scatter kernel) and the sharded migration over a
  worker list between any two TP degrees (gather kernel per worker, the
  exchange, then placement by the scatter kernel): the reference's
  shard_map pipeline for TP1 x W <-> TPW, and the bytes its GSPMD
  ``device_put`` moves for partial degrees (``transform_engine.py:
  393-416``), moved explicitly.  The sharded migration also runs
  between two assemblies: TP1 over a merge target's own workers to a
  degree over those plus the adopted ones, a donor's move onto fewer
  workers, and back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.kernels import page_migrate as PM
from repro_torch.paged import layout as L
from repro_torch.paged.pool import PagedState

# ---------------------------------------------------------------------------
# Interconnect cost model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkModel:
    # effective copy bandwidth (below peak NVLink: strided copy kernels)
    bandwidth: float = 150e9      # bytes/s
    segment_overhead: float = 100e-9  # s per contiguous segment
    # fraction of the transfer hideable behind compute on an independent
    # stream (paper §4.1 "Overlapping")
    overlap_fraction: float = 0.85


@dataclass
class MigrationStats:
    bytes_moved: int = 0
    segments: int = 0
    trim_bytes: int = 0           # extra local copies for compaction
    peak_extra_pages: int = 0     # transient page overhead during migration
    stages: int = 1

    def time_s(self, link: LinkModel, overlap: bool = False) -> float:
        transfer = (self.bytes_moved / link.bandwidth
                    + self.segments * link.segment_overhead)
        if overlap:
            transfer *= 1.0 - link.overlap_fraction
        # trims are local copies on the critical path: never hidden
        return transfer + self.trim_bytes / link.bandwidth


# ---------------------------------------------------------------------------
# Accounting plane
# ---------------------------------------------------------------------------

def page_bytes(kv_slots: int, page_tokens: int, head_dim: int,
               dtype_bytes: int = 2) -> int:
    return kv_slots * 2 * page_tokens * head_dim * dtype_bytes


def account_scale_up(layout: str, n_workers: int, pages_per_worker: int,
                     kv_slots: int, page_tokens: int, head_dim: int,
                     n_stages: int = 1, dtype_bytes: int = 2
                     ) -> MigrationStats:
    """TP1 x n_workers -> TPn migration accounting (paper Fig. 5): every
    worker keeps heads [w*H/n, (w+1)*H/n) of its local pages and sends
    the other (n-1)/n of every page to the other workers."""
    pb = page_bytes(kv_slots, page_tokens, head_dim, dtype_bytes)
    total_pages = n_workers * pages_per_worker
    sent_fraction = (n_workers - 1) / n_workers
    bytes_moved = int(total_pages * pb * sent_fraction)
    segs_per_block = L.contiguous_segments_per_block(
        layout, kv_slots, page_tokens, n_workers)
    segments = int(total_pages * segs_per_block * sent_fraction)
    if layout == "header_centric":
        trim_bytes = 0  # freed space is contiguous: O(1) block reshaping
        if n_stages <= 1:
            peak = int(pages_per_worker * sent_fraction) + 1
        else:
            peak = int(pages_per_worker * sent_fraction / n_stages) + 1
    else:
        # token-first: trimming copies the surviving 1/n of every page
        trim_bytes = int(pages_per_worker * pb * (1.0 / n_workers))
        peak = int(pages_per_worker * sent_fraction) + int(
            pages_per_worker / n_workers) + 1
        n_stages = 1  # phased migration requires in-place reuse
    return MigrationStats(bytes_moved=bytes_moved, segments=segments,
                          trim_bytes=trim_bytes, peak_extra_pages=peak,
                          stages=n_stages)


def sharded_migration_stats(n_workers: int, pages_per_worker: int,
                            kv_slots: int, page_tokens: int, head_dim: int,
                            dtype_bytes: int = 2) -> MigrationStats:
    """Accounting for ONE TP1 x n <-> TPn ``migrate_sharded`` run: every
    worker ships the (n-1)/n foreign head slices of its pages, one
    segment per (page, destination) pair."""
    return account_scale_up("header_centric", n_workers, pages_per_worker,
                            kv_slots, page_tokens, head_dim,
                            dtype_bytes=dtype_bytes)


def simulate_phased_migration(n_workers: int, pages_per_worker: int,
                              n_stages: int, headroom_pages: int
                              ) -> Tuple[int, bool]:
    """Stage-level simulation of the phased all-to-all (Fig. 5d).
    Returns (peak_pages_used, fits_within_headroom)."""
    send_total = pages_per_worker * (n_workers - 1) // n_workers
    recv_total = send_total  # balanced load (paper §4.3)
    per_stage = max(1, -(-recv_total // n_stages))
    live = pages_per_worker
    capacity = pages_per_worker + headroom_pages
    peak = live
    sent = recv = 0
    fits = True
    while sent < send_total or recv < recv_total:
        r = min(per_stage, recv_total - recv)
        live += r
        recv += r
        peak = max(peak, live)
        if live > capacity:
            fits = False
        s = min(per_stage, send_total - sent)
        live -= s
        sent += s
    return peak, fits


# ---------------------------------------------------------------------------
# Data plane: references and single-pool operations
# ---------------------------------------------------------------------------

def merge_pools_local(pools: torch.Tensor, tp: int) -> torch.Tensor:
    """Reference TP1 x W -> TPW merge: (W, NP, kvs, 2, P, dh) ->
    (W*NP, kvs, 2, P, dh), the union pool (head-sharded on a mesh)."""
    W, NP = pools.shape[:2]
    return pools.reshape(W * NP, *pools.shape[2:])


def split_pool_local(pool: torch.Tensor, n_workers: int) -> torch.Tensor:
    """TPn -> TP1 x W reverse reference."""
    NP = pool.shape[0]
    assert NP % n_workers == 0
    return pool.reshape(n_workers, NP // n_workers, *pool.shape[1:])


def resize_slot_capacity(state: PagedState, new_mps: int, batch: int
                         ) -> PagedState:
    """Grow or shrink a slot-partitioned ``PagedState`` (identity page
    tables: slot b owns pages [b*mps, (b+1)*mps)) to ``new_mps`` pages a
    slot.  Growth appends zero pages to every slot's range; shrink drops
    trailing pages, which the caller has checked are empty.  The pool
    and ``positions`` are reallocated (memory follows the TP degree, so
    the old allocation must go); ``seq_lens`` is kept in place."""
    mps = state.page_table.shape[-1]
    if mps == new_mps:
        return state
    NP, kvs, two, P, dh = state.pool.shape
    assert NP == batch * mps, (NP, batch, mps)
    dev = state.pool.device
    keep = min(mps, new_mps)
    pool = torch.zeros((batch, new_mps, kvs, two, P, dh),
                       dtype=state.pool.dtype, device=dev)
    pool[:, :keep] = state.pool.view(batch, mps, kvs, two, P, dh)[:, :keep]
    pos = torch.full((batch, new_mps, P), -1, dtype=state.positions.dtype,
                     device=dev)
    pos[:, :keep] = state.positions.view(batch, mps, P)[:, :keep]
    pt = (torch.arange(batch, device=dev)[:, None] * new_mps
          + torch.arange(new_mps, device=dev)[None, :]).to(
              state.page_table.dtype)
    return PagedState(pool.view(batch * new_mps, kvs, two, P, dh), pt,
                      state.seq_lens, pos.view(batch, new_mps * P))


def migrate_slot_pages(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                       n_pages: int, dst_page_start: int) -> torch.Tensor:
    """Cross-pool page import: the first ``n_pages`` pages of
    ``src_pool`` land in ``dst_pool`` at ``dst_page_start`` onward, IN
    PLACE, through ``copy_page_slices`` with the full head dimension as
    one slice (one contiguous segment a page).  Other pages keep their
    bytes.  Returns ``dst_pool``."""
    assert src_pool.shape[1:] == dst_pool.shape[1:], (
        f"incompatible page geometry: src {tuple(src_pool.shape)} vs dst "
        f"{tuple(dst_pool.shape)}")
    dev = dst_pool.device
    src = src_pool.to(device=dev, dtype=dst_pool.dtype)
    ids = torch.arange(n_pages, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(ids)
    return PM.copy_page_slices(src, dst_pool, ids, zeros,
                               ids + dst_page_start, zeros,
                               heads_per_slice=dst_pool.shape[1])


def export_slot(state: PagedState, slot: int) -> PagedState:
    """A merge donor's slot as a self-contained batch-1 state: its pages
    ``[slot*mps, (slot+1)*mps)`` packed by the gather kernel (every head
    as one slice, one contiguous segment a page) under an identity page
    table, with copies of its ``seq_lens`` and ``positions`` rows.  The
    counterpart of the reference's ``_extract_slot_cache``."""
    mps = state.page_table.shape[-1]
    dev = state.pool.device
    ids = torch.arange(slot * mps, (slot + 1) * mps, dtype=torch.int32,
                       device=dev)
    pool = PM.gather_page_slices(state.pool, ids, torch.zeros_like(ids),
                                 heads_per_slice=state.pool.shape[1])
    return PagedState(pool,
                      torch.arange(mps, dtype=state.page_table.dtype,
                                   device=dev)[None],
                      state.seq_lens[slot:slot + 1].clone(),
                      state.positions[slot:slot + 1].clone())


def import_slot(state: PagedState, sub: PagedState, slot: int) -> None:
    """Land an exported batch-1 state in ``slot`` of ``state``, in place
    (the reference's ``_import_slot_cache``): its pages at the head of
    the slot's (wider) page range through ``migrate_slot_pages``, its
    cursor and stored positions in the slot's rows; the positions past
    the donor's capacity stay invalid.  ``sub`` may lie on another
    device."""
    mps_d, mps_s = state.page_table.shape[-1], sub.page_table.shape[-1]
    assert mps_s <= mps_d, "donor slots cannot exceed the grown target's"
    migrate_slot_pages(sub.pool, state.pool, mps_s, slot * mps_d)
    dev = state.pool.device
    state.seq_lens[slot:slot + 1].copy_(sub.seq_lens.to(dev))
    pos = state.positions[slot]
    pos.fill_(-1)
    pos[:sub.positions.shape[-1]].copy_(sub.positions[0].to(dev))


# ---------------------------------------------------------------------------
# Data plane: the sharded migration over a worker list (paper §4.1)
# ---------------------------------------------------------------------------

def _block(W: int, t: int, NP: int, H: int, w: int) -> Tuple[int, ...]:
    """Worker w's rectangle at degree ``t``: global pages [p0, p1) of its
    group and kv slots [h0, h1) of its position."""
    g, p = divmod(w, t)
    return g * NP, (g + 1) * NP, p * H, (p + 1) * H


def _segments(rect, mine, h: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (page, head block) segments of the global rectangle ``rect``
    in the local ids of a worker whose rectangle is ``mine``, page-major,
    at ``h`` heads a block."""
    p0, p1, c0, c1 = rect
    nb = (c1 - c0) // h
    pages = torch.arange(p0 - mine[0], p1 - mine[0],
                         dtype=torch.int32).repeat_interleave(nb)
    blocks = torch.arange((c0 - mine[2]) // h, (c1 - mine[2]) // h,
                          dtype=torch.int32).repeat(p1 - p0)
    return pages, blocks


def migrate_sharded(pools: List[torch.Tensor], src, ta: int, dst, tb: int
                    ) -> Tuple[List[torch.Tensor], int]:
    """Header-centric migration of one layer's pools from degree ``ta``
    on the workers of ``src`` to degree ``tb`` on those of ``dst``
    (``core.instance``'s layout: group g of a degree holds its slots'
    pages, position p its kv slots).  Every (source, destination) pair
    whose rectangles of (pages x kv slots) meet moves exactly that
    intersection, in segments of ``h = gcd`` of the two head counts:

    * a worker in both assemblies keeps what it holds of its own new
      rectangle: ONE scatter-kernel launch copies it from its old pool
      into its new one, and it never enters the exchange;
    * each source packs its segments for every other destination, in
      destination order, with ONE gather-kernel launch;
    * the exchange copies each destination's chunks into its receive
      buffer, in source order (``InstanceMesh.all_to_all``'s order);
    * each destination places its arrivals with ONE scatter-kernel
      launch, unless they are whole pages of its heads (any scale-up, as
      in a full merge): each chunk is then a run of its pool's pages,
      and the exchange writes it there.

    A scale-up by k = tb/ta thus has each worker keep the head slice it
    retains and send the others to its k-1 peers of the target group; a
    scale-down is the mirror image, and TP1 x W <-> TPW, a same-degree
    move onto other workers and every partial degree are cases of it.
    Returns the destination pools and the bytes the kernels and the
    exchange read and wrote."""
    NPa, Ha = pools[0].shape[:2]
    H, NPt = Ha * ta, NPa * (src.W // ta)
    assert H % tb == 0 and NPt % (dst.W // tb) == 0, (H, NPt, dst.W, tb)
    NPb, Hb = NPt // (dst.W // tb), H // tb
    h = math.gcd(Ha, Hb)
    src_r = [_block(src.W, ta, NPa, Ha, u) for u in range(src.W)]
    dst_r = [_block(dst.W, tb, NPb, Hb, w) for w in range(dst.W)]
    meet = {}
    for u, a in enumerate(src_r):
        for w, b in enumerate(dst_r):
            r = (max(a[0], b[0]), min(a[1], b[1]),
                 max(a[2], b[2]), min(a[3], b[3]))
            if r[0] < r[1] and r[2] < r[3]:
                meet[u, w] = r

    def own(u: int, w: int) -> bool:
        return src.workers[u] == dst.workers[w]

    send, chunk, moved = [], {}, 0
    for u, pool in enumerate(pools):
        segs = [(w, _segments(meet[u, w], src_r[u], h))
                for w in range(dst.W) if (u, w) in meet and not own(u, w)]
        n = 0
        for w, (pg, _) in segs:
            chunk[u, w] = (n, n + pg.numel())
            n += pg.numel()
        if not segs:
            send.append(None)
            continue
        pages = torch.cat([pg for _, (pg, _) in segs]).to(pool.device)
        blocks = torch.cat([bl for _, (_, bl) in segs]).to(pool.device)
        buf = PM.gather_page_slices(pool, pages, blocks, heads_per_slice=h)
        moved += 4 * buf.numel() * buf.element_size()  # gather, exchange
        send.append(buf)
    seg_bytes = pools[0][:1, :h].numel() * pools[0].element_size()
    out = []
    for w, wk in enumerate(dst.workers):
        srcs = [u for u in range(src.W) if (u, w) in meet]
        pool = torch.empty((NPb, Hb, *pools[0].shape[2:]),
                           dtype=pools[0].dtype, device=wk.device)
        n = 0
        for u in srcs:
            if own(u, w):
                sp, sb = _segments(meet[u, w], src_r[u], h)
                dp, db = _segments(meet[u, w], dst_r[w], h)
                PM.copy_page_slices(
                    pools[u], pool, sp.to(wk.device), sb.to(wk.device),
                    dp.to(wk.device), db.to(wk.device), heads_per_slice=h)
                moved += 2 * sp.numel() * seg_bytes
                n += sp.numel()
        foreign = [u for u in srcs if not own(u, w)]
        m = sum(chunk[u, w][1] - chunk[u, w][0] for u in foreign)
        assert (n + m) * h == NPb * Hb, "the sources must cover every segment"
        if not foreign:
            out.append(pool)
            continue
        if h == Hb:                   # whole pages: runs of the pool's
            for u in foreign:
                lo, hi = chunk[u, w]
                p0 = meet[u, w][0] - dst_r[w][0]
                pool[p0:p0 + hi - lo].copy_(send[u][lo:hi])
            out.append(pool)
            continue
        recv = torch.empty((m, h, *pools[0].shape[2:]),
                           dtype=pools[0].dtype, device=wk.device)
        o, places = 0, []
        for u in foreign:
            lo, hi = chunk[u, w]
            recv[o:o + hi - lo].copy_(send[u][lo:hi])
            o += hi - lo
            places.append(_segments(meet[u, w], dst_r[w], h))
        ids = torch.arange(m, dtype=torch.int32, device=wk.device)
        PM.copy_page_slices(
            recv, pool, ids, torch.zeros_like(ids),
            torch.cat([pg for pg, _ in places]).to(wk.device),
            torch.cat([bl for _, bl in places]).to(wk.device),
            heads_per_slice=h)
        moved += 2 * recv.numel() * recv.element_size()
        out.append(pool)
    return out, moved
