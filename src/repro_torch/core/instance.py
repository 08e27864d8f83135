"""Sharding rules of an instance spread over W workers.

The counterpart of ``repro.core.instance``'s PartitionSpec trees
(``:57-133``), as explicit functions that split one layer's weights and
paged cache into per-worker tensors for a layout and join them back.
Two layouts of a W-worker instance (sequence parallelism and partial
degrees are ROADMAP queue 1 items 6 and 5):

* ``REP`` (TP1 x W): worker w owns slots ``[w*B/W, (w+1)*B/W)``, their
  pages under local page ids (global id minus ``w*NP/W``), and a full
  replica of the weights;
* ``TP`` (TPW): worker w owns every page for kv heads
  ``[w*kvs/W, (w+1)*kvs/W)``, the matching q heads, the ``wo`` rows of
  those heads and FFN shard w (``[gate_w | up_w]``, the Eq. 2 layout;
  see ``core.weight_transform``).  Page tables, ``seq_lens`` and
  ``positions`` are replicated on every worker.

Embedding, head and norms are replicated in both.  A layer's attention
(weights and cache) and its MLP each sit at one layout; mid-transform
the two may differ (``WorkerLayer``).  ``InstanceGroup`` is ported in a
later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from repro_torch.paged import pool as pp

REP, TP = "rep", "tp"

Params = Dict[str, torch.Tensor]


@dataclass
class WorkerLayer:
    """One decoder layer spread over the workers.  ``attn_layout`` is the
    layout of the attention weights AND the layer's paged cache (they
    move together, in the ``kv`` op of a transform); ``mlp_layout`` that
    of the MLP weights (the ``mlp`` op).  Every list has one entry a
    worker."""
    kind: str
    attn_layout: str
    mlp_layout: str
    ln1: List[torch.Tensor]
    ln2: List[torch.Tensor]
    attn: List[Params]
    mlp: List[Params]
    cache: List[pp.PagedState]


def rows_of(layout: str, batch: int, W: int, w: int) -> Tuple[int, int]:
    """The slot range [lo, hi) worker w holds at ``layout``."""
    if layout == TP:
        return 0, batch
    per = batch // W
    return w * per, (w + 1) * per


def own_copy(t: torch.Tensor, device, w: int) -> torch.Tensor:
    """Worker w's tensor of a replicated value: worker 0 takes ``t``
    itself (moved only if it lies elsewhere), every other worker a copy
    of its own."""
    return t.to(device) if w == 0 else t.to(device, copy=True)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def shard_attn(p: Params, w: int, W: int) -> Params:
    """Worker w's TP shard of a full attention replica (kv heads are not
    replicated: ``kv_replication == 1``): q/k/v columns of its heads and
    the ``wo`` rows of its q heads, each a compact tensor of its own."""
    def cols(t):
        n = t.shape[1] // W
        return t[:, w * n:(w + 1) * n].contiguous()

    n = p["wo"].shape[0] // W
    return {"wq": cols(p["wq"]), "wk": cols(p["wk"]), "wv": cols(p["wv"]),
            "wo": p["wo"][w * n:(w + 1) * n].contiguous()}


def gather_attn(ps: List[Params], mesh) -> List[Params]:
    """Full attention replicas, one a worker, from the workers' shards."""
    cols = {k: mesh.all_gather([p[k] for p in ps], 1)
            for k in ("wq", "wk", "wv")}
    wo = mesh.all_gather([p["wo"] for p in ps], 0)
    return [{"wq": cols["wq"][w], "wk": cols["wk"][w], "wv": cols["wv"][w],
             "wo": wo[w]} for w in range(mesh.W)]


def shard_mlp(p: Params, w: int, W: int) -> Params:
    """Worker w's FFN shard of a full replica in the Eq. 2 layout:
    ``wi`` [gate_w | up_w] (d, 2*ffp/W) and ``wo`` rows (ffp/W, d)."""
    d, ffp = p["wi"].shape[0], p["wi"].shape[1] // 2
    fs = ffp // W
    wi = p["wi"].view(d, 2, W, fs)[:, :, w].reshape(d, 2 * fs)
    return {"wi": wi.contiguous(),
            "wo": p["wo"][w * fs:(w + 1) * fs].contiguous()}


def gather_mlp(ps: List[Params], mesh) -> List[Params]:
    """Full MLP replicas from the workers' shards: gate and up halves are
    gathered shard by shard into [gate | up]."""
    d, fs2 = ps[0]["wi"].shape
    wi = mesh.all_gather([p["wi"].view(d, 2, fs2 // 2) for p in ps], 2)
    wo = mesh.all_gather([p["wo"] for p in ps], 0)
    return [{"wi": wi[w].view(d, -1), "wo": wo[w]} for w in range(mesh.W)]


# ---------------------------------------------------------------------------
# Paged caches
# ---------------------------------------------------------------------------

def identity_page_table(batch: int, mps: int, device) -> torch.Tensor:
    return (torch.arange(batch, device=device)[:, None] * mps
            + torch.arange(mps, device=device)[None, :]).to(torch.int32)


def join_cache(states: List[pp.PagedState], layout: str) -> pp.PagedState:
    """The global view of one layer's cache (on worker 0's device): pool
    (NP, kvs, 2, P, dh) under global page ids, with the global page
    table, ``seq_lens`` and ``positions`` — what the reference's sharded
    arrays hold."""
    dev = states[0].pool.device
    if layout == TP:
        s0 = states[0]
        return pp.PagedState(
            torch.cat([s.pool.to(dev) for s in states], dim=1),
            s0.page_table.clone(), s0.seq_lens.clone(),
            s0.positions.clone())
    pool = torch.cat([s.pool.to(dev) for s in states])
    B = sum(s.page_table.shape[0] for s in states)
    mps = states[0].page_table.shape[1]
    return pp.PagedState(
        pool, identity_page_table(B, mps, dev),
        torch.cat([s.seq_lens.to(dev) for s in states]),
        torch.cat([s.positions.to(dev) for s in states]))


def init_worker_caches(kvs: int, page_tokens: int, dh: int, batch: int,
                       mps: int, dtype, devices) -> List[pp.PagedState]:
    """Empty slot-partitioned caches at ``REP``: each worker's B/W slots
    under local page ids."""
    W = len(devices)
    per = batch // W
    return [pp.make_state(per * mps, kvs, page_tokens, dh, per, mps, dtype,
                          device=d) for d in devices]


def cache_to_tp(states: List[pp.PagedState], pools: List[torch.Tensor],
                mesh) -> List[pp.PagedState]:
    """The ``TP`` cache after a scale-up migration: the migrated pools
    and the metadata of every slot, replicated."""
    B = sum(s.page_table.shape[0] for s in states)
    mps = states[0].page_table.shape[1]
    seq = mesh.all_gather([s.seq_lens for s in states], 0)
    pos = mesh.all_gather([s.positions for s in states], 0)
    return [pp.PagedState(pools[w], identity_page_table(B, mps, d), seq[w],
                          pos[w]) for w, d in enumerate(mesh.devices)]


def cache_to_rep(states: List[pp.PagedState], pools: List[torch.Tensor],
                 mesh) -> List[pp.PagedState]:
    """The ``REP`` cache after a scale-down migration: each worker keeps
    its own slots' rows of the replicated metadata, as compact tensors."""
    B, mps = states[0].page_table.shape
    out = []
    for w, d in enumerate(mesh.devices):
        lo, hi = rows_of(REP, B, mesh.W, w)
        s = states[w]
        out.append(pp.PagedState(
            pools[w], identity_page_table(hi - lo, mps, d),
            s.seq_lens[lo:hi].clone(), s.positions[lo:hi].clone()))
    return out
