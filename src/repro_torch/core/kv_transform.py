"""KV-cache transformation across TP layouts (paper §4.1.2).

The counterpart of ``repro.core.kv_transform``.  Two planes:

* **Accounting plane** (host, ported as is): segment, byte and peak-page
  accounting of the paper's Fig. 9 layouts, with an explicit link model
  (bytes over bandwidth plus a per-segment overhead).  ``LinkModel()``'s
  defaults are the paper's NVLink-class constants, the prior that
  ``core.calibrate.fit_link_model`` replaces with constants fitted to
  isolated spans of this module's migrations on the card; a session's
  ``modeled_s`` is priced against ``LinkModel()``.
* **Data plane** (torch): pool merge/split references, the slot-capacity
  resize, the cross-engine slot export and import (a merge donor's
  in-flight KV: ``export_slot`` packs a slot's pages with the gather
  kernel, ``import_slot`` lands them at the head of a free slot's wider
  page range with the scatter kernel) and the sharded migration over a
  worker list between any two ``(rep, sp, tp)`` layouts (gather kernel
  per worker, the exchange, then placement by the scatter kernel): the
  reference's shard_map pipeline for TP1 x W <-> TPW, and the bytes its
  GSPMD ``device_put`` moves for partial degrees and for sequence-
  parallel layouts, whose pages shard over sp (``transform_engine.py:
  393-416``), moved explicitly.  The sharded migration also runs
  between two assemblies: TP1 over a merge target's own workers to a
  layout over those plus the adopted ones, a donor's move onto fewer
  workers, and back.  ``layout_migration_stats`` accounts for any such
  move, page-axis moves included.

A recurrent layer's state has no pages: its rows follow the replicas
(``regroup_rec``).  A worker whose rows at the old layout cover its new
ones keeps a slice of them; the others receive their rows copied from
the workers that hold them (TP1 x 2 -> TP2 gathers each replica's rows
onto both workers, TP2 -> TP1 x 2 splits them), every leaf of them
(RG-LRU's ``conv`` and ``h``, mLSTM's ``C``, ``n``, ``m``, sLSTM's
``c``, ``n``, ``m``, ``h``) and every byte counted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import page_migrate as PM
from repro_torch.launch.comm_analysis import TALLY
from repro_torch.launch.mesh import Layout, place
from repro_torch.paged import layout as L
from repro_torch.paged.pool import PagedState
from repro_torch.paged.recurrent import RecState, cat_rows

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
    segment per (page, destination) pair (``layout_migration_stats``
    accounts for any two layouts, page-axis moves included)."""
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


def export_slot(state, slot: int):
    """A merge donor's slot as a self-contained batch-1 state (a
    recurrent layer's: a copy of its state row): its pages
    ``[slot*mps, (slot+1)*mps)`` packed by the gather kernel (every head
    as one slice, one contiguous segment a page) under an identity page
    table, with copies of its ``seq_lens`` and ``positions`` rows.  The
    counterpart of the reference's ``_extract_slot_cache``."""
    if state.recurrent:
        return state.slot(slot).clone()
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


def import_slot(state, sub, slot: int) -> None:
    """Land an exported batch-1 state in ``slot`` of ``state``, in place
    (the reference's ``_import_slot_cache``; a state row is copied): its
    pages at the head of the slot's (wider) page range through
    ``migrate_slot_pages``, its
    cursor and stored positions in the slot's rows; the positions past
    the donor's capacity stay invalid.  ``sub`` may lie on another
    device."""
    if state.recurrent:
        state.slot(slot).copy_(sub)
        return
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

def _block(W: int, lay: Layout, per: int, ns: int, H: int, w: int
           ) -> Tuple[int, ...]:
    """Worker w's box at ``lay``: the slots [b0, b1) of its replica
    (``per`` a replica), pages [j0, j1) of each slot (its sp shard's
    ``ns``) and kv slots [h0, h1) of its tp position (``H`` of them)."""
    r, s, p = place(lay, w)
    return r * per, (r + 1) * per, s * ns, (s + 1) * ns, p * H, (p + 1) * H


def _meet(a: Tuple[int, ...], b: Tuple[int, ...]) -> Optional[Tuple]:
    """The intersection of two boxes, or None."""
    r = tuple(f(x, y) for i, (x, y) in enumerate(zip(a, b))
              for f in ((max,) if i % 2 == 0 else (min,)))
    return r if all(r[i] < r[i + 1] for i in (0, 2, 4)) else None


def _segments(box, mine, h: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (page, head block) segments of the global box ``box`` in the
    local ids of a worker whose box is ``mine`` (local page of slot b,
    page j: ``(b - b0) * ns + j - j0``), slot-major, then page, then head
    block, at ``h`` heads a block."""
    b0, b1, j0, j1, c0, c1 = box
    ns = mine[3] - mine[2]
    nb = (c1 - c0) // h
    slots = torch.arange(b0 - mine[0], b1 - mine[0], dtype=torch.int32)
    js = torch.arange(j0 - mine[2], j1 - mine[2], dtype=torch.int32)
    pages = (slots[:, None] * ns + js[None, :]).reshape(-1)
    blocks = torch.arange((c0 - mine[4]) // h, (c1 - mine[4]) // h,
                          dtype=torch.int32).repeat(pages.numel())
    return pages.repeat_interleave(nb), blocks


def layout_boxes(W: int, lay: Layout, batch: int, mps: int, kvs: int
                 ) -> List[Tuple[int, ...]]:
    """Every worker's box of a W-worker assembly at ``lay`` for a cache
    of ``batch`` slots of ``mps`` pages and ``kvs`` kv slots."""
    assert mps % lay.sp == 0 and kvs % lay.tp == 0, (lay, mps, kvs)
    per = batch // (W // lay.degree)
    return [_block(W, lay, per, mps // lay.sp, kvs // lay.tp, w)
            for w in range(W)]


def layout_migration_stats(W_from: int, la, W_to: int, lb, batch: int,
                           mps: int, kv_slots: int, page_tokens: int,
                           head_dim: int, dtype_bytes: int = 2,
                           same: Optional[List[bool]] = None
                           ) -> MigrationStats:
    """Accounting for ONE ``migrate_sharded`` run between any two
    layouts: the bytes of every (source, destination) box intersection
    that leaves its worker (``same[u * W_to + w]`` says whether source u
    and destination w are one worker; by default worker index equality,
    one assembly), and one segment a (page, head block) of it.  Pages
    move along the page axis (sp) as well as the head axis (tp).
    ``la``/``lb``: ``Layout`` values or TP degrees."""
    la, lb = Layout.of(la), Layout.of(lb)
    src = layout_boxes(W_from, la, batch, mps, kv_slots)
    dst = layout_boxes(W_to, lb, batch, mps, kv_slots)
    h = math.gcd(kv_slots // la.tp, kv_slots // lb.tp)
    head = 2 * page_tokens * head_dim * dtype_bytes
    out = MigrationStats()
    for u, a in enumerate(src):
        for w, b in enumerate(dst):
            r = _meet(a, b)
            own = (same[u * W_to + w] if same is not None else u == w)
            if r is None or own:
                continue
            pages = (r[1] - r[0]) * (r[3] - r[2])
            out.bytes_moved += pages * (r[5] - r[4]) * head
            out.segments += pages * (r[5] - r[4]) // h
    return out


def migrate_sharded(pools: List[torch.Tensor], src, la, dst, lb,
                    mps: Optional[int] = None
                    ) -> Tuple[List[torch.Tensor], int]:
    """Header-centric migration of one layer's pools from layout ``la``
    on the workers of ``src`` to layout ``lb`` on those of ``dst``
    (``core.instance``'s placement: replica r holds its slots, sp shard
    s pages ``[s*ns, (s+1)*ns)`` of each of them, tp position p its kv
    slots; ``mps`` pages a slot in all).  Every (source, destination)
    pair whose boxes of (slots x pages of a slot x kv slots) meet moves
    exactly that intersection, in segments of one page and ``h = gcd``
    of the two head counts:

    * a worker in both assemblies keeps what it holds of its own new
      box: ONE scatter-kernel launch copies it from its old pool into
      its new one, and it never enters the exchange;
    * each source packs its segments for every other destination, in
      destination order, with ONE gather-kernel launch;
    * the exchange copies each destination's chunks into its receive
      buffer, in source order (``InstanceMesh.all_to_all``'s order);
    * each destination places its arrivals with ONE scatter-kernel
      launch, unless they are whole pages of its heads covering whole
      runs of its slots' pages (any scale-up along tp, as in a full
      merge): each chunk is then a run of its pool's pages, and the
      exchange writes it there.

    A scale-up by k = tb/ta thus has each worker keep the head slice it
    retains and send the others to its k-1 peers of the target group; a
    scale-down is the mirror image; a change of sp moves page ranges
    between shards (TP4 <-> SP2xTP2 both); TP1 x W <-> TPW, a same-layout
    move onto other workers and every partial layout are cases of it.
    Returns the destination pools and the bytes the kernels and the
    exchange read and wrote.  Without ``mps`` (pure TP on both sides) a
    replica's pages are one flat range: every page a "slot"."""
    a, b = Layout.of(la), Layout.of(lb)
    if mps is None:
        assert a.sp == b.sp == 1, "an sp layout needs the slots' pages"
        mps = 1
    NPa, Ha = pools[0].shape[:2]
    H = Ha * a.tp
    B = NPa // (mps // a.sp) * (src.W // a.degree)
    assert H % b.tp == 0 and mps % b.sp == 0 \
        and B % (dst.W // b.degree) == 0, (H, mps, B, dst.W, b)
    src_r = layout_boxes(src.W, a, B, mps, H)
    dst_r = layout_boxes(dst.W, b, B, mps, H)
    NPb, Hb = (B // (dst.W // b.degree)) * (mps // b.sp), H // b.tp
    h = math.gcd(Ha, Hb)
    meet = {}
    for u, ra in enumerate(src_r):
        for w, rb in enumerate(dst_r):
            r = _meet(ra, rb)
            if r is not None:
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
    out, exchanged = [], 0
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
        exchanged += m * seg_bytes
        assert (n + m) * h == NPb * Hb, "the sources must cover every segment"
        if not foreign:
            out.append(pool)
            continue
        if h == Hb and all(meet[u, w][2:4] == dst_r[w][2:4]
                           for u in foreign):
            # whole pages of the destination's slots: runs of its pool
            ns = dst_r[w][3] - dst_r[w][2]
            for u in foreign:
                lo, hi = chunk[u, w]
                p0 = (meet[u, w][0] - dst_r[w][0]) * ns
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
    TALLY.add("all-to-all", exchanged)
    return out, moved


def regroup_rec(states: List[RecState], src, la, dst, lb
                ) -> Tuple[List[RecState], int]:
    """One recurrent layer's state rows from layout ``la`` on the workers
    of ``src`` to ``lb`` on those of ``dst`` (replica r holds the rows of
    its slots on every one of its workers).  A worker of both whose old
    rows cover its new ones keeps them (the same tensors when the rows
    do not change, else a compact slice); every other worker receives
    its rows copied from one worker of each source replica that holds
    some.  Returns the states and the bytes copied."""
    from repro_torch.core.instance import rows_of
    a, b = Layout.of(la), Layout.of(lb)
    B = states[0].batch * (src.W // a.degree)
    out, moved, exchanged = [], 0, 0
    for w, wk in enumerate(dst.workers):
        lo, hi = rows_of(b, B, dst.W, w)
        if wk in src.workers:
            u = src.workers.index(wk)
            ulo, uhi = rows_of(a, B, src.W, u)
            if (ulo, uhi) == (lo, hi):
                out.append(states[u])
                continue
            if ulo <= lo and hi <= uhi:
                part = states[u].rows(lo - ulo, hi - ulo).to(wk.device)
                out.append(part)
                moved += 2 * part.nbytes
                continue
        parts = []
        for u in range(0, src.W, a.degree):
            ulo, uhi = rows_of(a, B, src.W, u)
            if ulo < hi and lo < uhi:
                parts.append(states[u].rows(max(lo, ulo) - ulo,
                                            min(hi, uhi) - ulo))
                if src.workers[u] != wk:
                    exchanged += parts[-1].nbytes
        new = cat_rows(parts, wk.device) if len(parts) > 1 \
            else parts[0].to(wk.device)
        out.append(new)
        moved += 2 * new.nbytes
    TALLY.add("all-gather", exchanged)
    return out, moved
