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
  page range with the scatter kernel) and the sharded TP1 x W <-> TPW
  migration over a worker list (gather kernel per worker, the mesh's
  all-to-all, then placement), exactly as the reference's shard_map
  pipeline does.  The sharded migration also runs between two
  assemblies: TP1 over a merge target's own workers to TP over those
  plus the adopted ones, and back.
"""
from __future__ import annotations

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
    """Accounting for ONE ``migrate_scale_up_sharded`` /
    ``migrate_scale_down_sharded`` run: every worker ships the (n-1)/n
    foreign head slices of its pages, one segment per (page,
    destination) pair."""
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

def migrate_scale_up_sharded(pools: List[torch.Tensor], mesh, dst=None
                             ) -> List[torch.Tensor]:
    """Header-centric TP1 x W -> TPW'.  ``pools[u]``: worker u of
    ``mesh``'s local pages, all heads (NP, H, 2, P, dh).  Returns the
    pool of each worker of ``dst`` (default ``mesh``; a merge's widened
    assembly) after the migration: every global page (u*NP + p), its
    head slice (W*NP, H/W', 2, P, dh).  Per worker the gather kernel
    packs one contiguous segment per (page, destination); the all-to-all
    delivers them, and the received buffer IS the new pool (global page
    id u*NP + p is the identity placement)."""
    dst = dst or mesh
    Wd = dst.W
    NP, H = pools[0].shape[:2]
    assert H % Wd == 0, (H, Wd)
    send = []
    for pool in pools:
        pages, hblk = PM.scale_up_send_index(NP, Wd, pool.device)
        send.append(PM.gather_page_slices(pool, pages, hblk,
                                          heads_per_slice=H // Wd))
    return mesh.all_to_all(send, dst)


def migrate_scale_down_sharded(pools: List[torch.Tensor], mesh, dst=None
                               ) -> List[torch.Tensor]:
    """Reverse of ``migrate_scale_up_sharded``.  ``pools[w]``: every
    global page, head slice w of worker w of ``mesh`` (NPt, H/W, 2, P,
    dh).  Returns worker u of ``dst`` (default ``mesh``; a split's home
    assembly, of W' workers) its local pages [u*NP, (u+1)*NP) with all
    heads (NP, H, 2, P, dh), NP = NPt/W': each worker ships its head
    slice of u's pages to u, and the scatter kernel places each arrival
    at head block (sender) of its page."""
    dst = dst or mesh
    W = mesh.W
    NPt, hps = pools[0].shape[:2]
    assert NPt % dst.W == 0, (NPt, dst.W)
    NP = NPt // dst.W
    send = []
    for pool in pools:
        ids = torch.arange(NPt, dtype=torch.int32, device=pool.device)
        send.append(PM.gather_page_slices(pool, ids, torch.zeros_like(ids),
                                          heads_per_slice=hps))
    recv = mesh.all_to_all(send, dst)
    out = []
    for buf in recv:
        dev = buf.device
        ids = torch.arange(W * NP, dtype=torch.int32, device=dev)
        zeros = torch.zeros_like(ids)
        dst_pages, dst_hblk = PM.scale_up_send_index(NP, W, dev)
        pool = torch.empty((NP, W * hps, *buf.shape[2:]), dtype=buf.dtype,
                           device=dev)
        out.append(PM.copy_page_slices(buf, pool, ids, zeros, dst_pages,
                                       dst_hblk, heads_per_slice=hps))
    return out
