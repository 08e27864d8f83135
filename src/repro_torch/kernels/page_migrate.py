"""Header-centric KV page migration: the CUDA kernels
``csrc/page_migrate.cu`` (replacing the TPU kernels
``repro/kernels/page_migrate.py``) with their plain versions
``ref.copy_page_slices_ref`` / ``ref.gather_page_slices_ref``, and the
host drivers built on them.

  * ``copy_page_slices`` — in-place scatter of (page, head-slice)
    segments from one pool into another; pages it does not name keep
    their bytes.  The TPU kernel aliases ``dst``; here ``dst`` is written
    in place and returned.
  * ``gather_page_slices`` — packs segments into a contiguous send buffer.
  * ``migrate_scale_up_local`` / ``migrate_scale_down_local`` — whole
    TP1 x W <-> TPW migrations of W stacked per-worker pools.
  * ``migrate_scale_up_staged`` — the phased protocol of Fig. 5d through
    a bounded frame pool; returns the measured peak page occupancy.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels import _build, ops, ref

#: kernel launches since the last reset (the card only), per wrapper
copy_launches = 0
gather_launches = 0


def _geometry(src: torch.Tensor, dst: torch.Tensor, hps: int) -> None:
    ops.require(src.dim() == 5 and dst.dim() == 5
                and src.shape[2:] == dst.shape[2:] and src.shape[2] == 2,
                f"pools {tuple(src.shape)} / {tuple(dst.shape)}: "
                "(pages, heads, 2, P, dh) with equal page geometry")
    ops.require(hps >= 1 and src.shape[1] % hps == 0
                and dst.shape[1] % hps == 0,
                f"heads_per_slice {hps} must divide the pools' heads "
                f"{src.shape[1]} / {dst.shape[1]}")


def copy_page_slices(src: torch.Tensor, dst: torch.Tensor,
                     src_pages: torch.Tensor, src_hblocks: torch.Tensor,
                     dst_pages: torch.Tensor, dst_hblocks: torch.Tensor, *,
                     heads_per_slice: int) -> torch.Tensor:
    """src: (NPs, Hs, 2, P, dh); dst: (NPd, Hd, 2, P, dh); four int32
    (n,) index vectors.  Writes segment i into ``dst`` in place and
    returns ``dst``.  Destinations must be distinct."""
    idx = (src_pages, src_hblocks, dst_pages, dst_hblocks)
    if not ops.on_card(src, dst, *idx):
        return ref.copy_page_slices_ref(src, dst, *idx, heads_per_slice)
    global copy_launches
    _geometry(src, dst, heads_per_slice)
    n = src_pages.shape[0]
    ops.require(all(tuple(t.shape) == (n,) for t in idx), "index shapes")
    ops.check_cuda_inputs(src.dtype, (src, dst), idx)
    NPs, Hs, _, P, dh = src.shape
    err = _build.library("page_migrate").repro_copy_page_slices(
        ops.ptr(src), ops.ptr(dst), *(ops.ptr(t) for t in idx), n, NPs, Hs,
        dst.shape[0], dst.shape[1], heads_per_slice, P, dh,
        src.element_size(), ops.stream(src.device))
    _build.check(err, "copy_page_slices launch")
    copy_launches += 1
    return dst


def gather_page_slices(pool: torch.Tensor, pages: torch.Tensor,
                       hblocks: torch.Tensor, *, heads_per_slice: int
                       ) -> torch.Tensor:
    """pool: (NP, H, 2, P, dh); pages, hblocks: int32 (n,).  Returns the
    send buffer (n, heads_per_slice, 2, P, dh)."""
    if not ops.on_card(pool, pages, hblocks):
        return ref.gather_page_slices_ref(pool, pages, hblocks,
                                          heads_per_slice)
    global gather_launches
    NP, H, _, P, dh = pool.shape
    n = pages.shape[0]
    out = torch.empty((n, heads_per_slice, 2, P, dh), dtype=pool.dtype,
                      device=pool.device)
    _geometry(pool, out, heads_per_slice)
    ops.require(tuple(hblocks.shape) == (n,), "index shapes")
    ops.check_cuda_inputs(pool.dtype, (pool,), (pages, hblocks))
    err = _build.library("page_migrate").repro_gather_page_slices(
        ops.ptr(pool), ops.ptr(out), ops.ptr(pages), ops.ptr(hblocks), n, NP,
        H, heads_per_slice, P, dh, pool.element_size(),
        ops.stream(pool.device))
    _build.check(err, "gather_page_slices launch")
    gather_launches += 1
    return out


def _i32(values, device) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.int32, device=device)


def scale_up_send_index(NP: int, W: int, device):
    """Worker-local send order of a TP1 x W -> TPW migration: for each
    destination u, every local page's head block u."""
    pages = torch.arange(NP, dtype=torch.int32, device=device).repeat(W)
    hblk = torch.arange(W, dtype=torch.int32,
                        device=device).repeat_interleave(NP)
    return pages, hblk


# ---------------------------------------------------------------------------
# Whole-migration drivers (W stacked per-worker pools)
# ---------------------------------------------------------------------------

def migrate_scale_up_local(pools: torch.Tensor) -> torch.Tensor:
    """TP1 x W -> TPW on stacked per-worker pools, all kernel traffic.
    pools: (W, NP, H, 2, P, dh), worker w's local pages.  Returns
    (W, W*NP, H/W, 2, P, dh): worker w's pool after the migration, every
    global page (u*NP + p), its head slice w."""
    W, NP, H, _, P, dh = pools.shape
    assert H % W == 0, (H, W)
    hps = H // W
    dev = pools.device
    pages, hblk = scale_up_send_index(NP, W, dev)
    send = torch.stack([gather_page_slices(pools[w], pages, hblk,
                                           heads_per_slice=hps)
                        for w in range(W)])
    # the "network": worker u receives from every w
    recv = send.reshape(W, W, NP, hps, 2, P, dh).transpose(0, 1)
    out = torch.zeros((W, W * NP, hps, 2, P, dh), dtype=pools.dtype,
                      device=dev)
    ids = torch.arange(W * NP, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(ids)
    for u in range(W):
        copy_page_slices(recv[u].reshape(W * NP, hps, 2, P, dh), out[u], ids,
                         zeros, ids, zeros, heads_per_slice=hps)
    return out


def migrate_scale_down_local(pools: torch.Tensor) -> torch.Tensor:
    """TPW -> TP1 x W: pools (W, W*NP, H/W, 2, P, dh) ->
    (W, NP, H, 2, P, dh).  Worker w keeps pages [w*NP, (w+1)*NP) and
    receives their other head slices from every peer."""
    W, NPt, hps, _, P, dh = pools.shape
    assert NPt % W == 0, (NPt, W)
    NP, H = NPt // W, hps * W
    dev = pools.device
    ids = torch.arange(NPt, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(ids)
    send = torch.stack([gather_page_slices(pools[w], ids, zeros,
                                           heads_per_slice=hps)
                        for w in range(W)])
    recv = send.reshape(W, W, NP, hps, 2, P, dh).transpose(0, 1)
    out = torch.zeros((W, NP, H, 2, P, dh), dtype=pools.dtype, device=dev)
    dst_pages, dst_hblk = scale_up_send_index(NP, W, dev)
    for u in range(W):
        copy_page_slices(recv[u].reshape(W * NP, hps, 2, P, dh), out[u], ids,
                         zeros, dst_pages, dst_hblk, heads_per_slice=hps)
    return out


# ---------------------------------------------------------------------------
# Staged migration (Fig. 5d): freed-page reuse under bounded headroom
# ---------------------------------------------------------------------------

def migrate_scale_up_staged(pools: torch.Tensor, n_stages: int,
                            headroom_pages: int) -> Tuple[torch.Tensor, int]:
    """Phased TP1 x W -> TPW through a bounded physical pool, the port of
    ``repro.kernels.page_migrate.migrate_scale_up_staged``.

    Worker w holds ``NP + headroom_pages`` page slots; one slot is W
    contiguous frames of the post-migration page geometry (H/W, 2, P,
    dh).  Each stage lands its share of incoming slices in free frames
    (one ``copy_page_slices`` scatter), then ships 1/n_stages of the
    local pages, whose non-kept frames the next stage reuses.  Returns
    (result equal to ``migrate_scale_up_local``, measured peak pages);
    raises RuntimeError if a stage would overflow the pool."""
    W, NP, H, _, P, dh = pools.shape
    assert H % W == 0, (H, W)
    hps = H // W
    dev = pools.device
    frames_cap = (NP + headroom_pages) * W
    send_total = NP * (W - 1) // W
    per_stage = max(1, -(-send_total // n_stages))
    out = torch.zeros((W, W * NP, hps, 2, P, dh), dtype=pools.dtype,
                      device=dev)
    peak_pages = NP
    for w in range(W):
        # local page p's H heads occupy frames [p*W, (p+1)*W); its kept
        # slice w is frame p*W + w and never moves
        frames = torch.zeros((frames_cap, hps, 2, P, dh), dtype=pools.dtype,
                             device=dev)
        frames[:NP * W] = pools[w].reshape(NP * W, hps, 2, P, dh)
        free: List[int] = list(range(NP * W, frames_cap))
        frame_of = {(w, p): p * W + w for p in range(NP)}
        # arrivals round-robin over peers (balanced all-to-all, §4.3)
        incoming = [(u, p) for p in range(NP) for u in range(W) if u != w]
        ship_queue = [p * W + u for p in range(NP) for u in range(W)
                      if u != w]
        sent = 0
        live_frames = NP * W
        while incoming or sent < send_total:
            batch = incoming[:per_stage * W]
            incoming = incoming[per_stage * W:]
            if batch:
                if len(free) < len(batch):
                    raise RuntimeError(
                        f"stage overflow: need {len(batch)} free frames, "
                        f"have {len(free)} (headroom {headroom_pages} too "
                        f"small for {n_stages} stages)")
                slots = [free.pop(0) for _ in batch]
                recv = torch.stack([pools[u, p, w * hps:(w + 1) * hps]
                                    for u, p in batch])
                zeros = _i32([0] * len(batch), dev)
                copy_page_slices(recv, frames, _i32(range(len(batch)), dev),
                                 zeros, _i32(slots, dev), zeros,
                                 heads_per_slice=hps)
                for (u, p), s in zip(batch, slots):
                    frame_of[(u, p)] = s
                live_frames += len(batch)
                peak_pages = max(peak_pages, -(-live_frames // W))
            s = min(per_stage, send_total - sent)
            sent += s
            released, ship_queue = ship_queue[:s * W], ship_queue[s * W:]
            free.extend(released)
            live_frames -= len(released)
        order = [frame_of[(u, p)] for u in range(W) for p in range(NP)]
        out[w] = frames[torch.as_tensor(order, device=dev)]
    return out, peak_pages
