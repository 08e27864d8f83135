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

Every layer also names the assembly of workers its tensors live on
(``WorkerLayer.mesh``).  A cross-instance merge moves a layer from REP
over the target's own W_old workers to TP over W_new workers, some of
them adopted from parked donors (and a split moves it back): the
functions that take a source mesh and a ``dst`` mesh below build the
new layout's tensors on ``dst``'s workers.  An adopted worker holds
nothing of the layer, so it receives its shard copied from a worker
that holds the replica, as the reference's ``device_put`` onto the
widened mesh does.

The MLP replicas are in the Eq. 2 layout of ``S`` shards, the width of
the padding plan (``plan.max_tp``: the engine's own W, or the whole
pool's in a cluster), and a TP-t shard is ``S/t`` consecutive of them
(``mlp_shards``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.paged import pool as pp

REP, TP = "rep", "tp"

Params = Dict[str, torch.Tensor]


@dataclass
class WorkerLayer:
    """One decoder layer spread over the workers of ``mesh`` (the
    assembly its tensors live on).  ``attn_layout`` is the layout of the
    attention weights AND the layer's paged cache (they move together,
    in the ``kv`` op of a transform); ``mlp_layout`` that of the MLP
    weights (the ``mlp`` op).  Every list has one entry a worker of
    ``mesh``."""
    kind: str
    attn_layout: str
    mlp_layout: str
    ln1: List[torch.Tensor]
    ln2: List[torch.Tensor]
    attn: List[Params]
    mlp: List[Params]
    cache: List[pp.PagedState]
    mesh: Any


def rows_of(layout: str, batch: int, W: int, w: int) -> Tuple[int, int]:
    """The slot range [lo, hi) worker w of a W-worker assembly holds at
    ``layout``."""
    if layout == TP:
        return 0, batch
    per = batch // W
    return w * per, (w + 1) * per


def mlp_shards(layout: str, S: int, d_ff: int, W: int) -> Tuple[int, int]:
    """``(tp, ff)`` for the padded FFN on one worker's MLP: the Eq. 2
    shards its tensor holds and their real columns in all.  A replica
    (REP) holds all ``S``; a TP shard over W workers ``S/W`` of them."""
    if layout == REP:
        return S, d_ff
    assert S % W == 0 and d_ff % W == 0, (S, d_ff, W)
    return S // W, d_ff // W


def own_copy(t: torch.Tensor, device, w: int) -> torch.Tensor:
    """Worker w's tensor of a replicated value: worker 0 takes ``t``
    itself (moved only if it lies elsewhere), every other worker a copy
    of its own."""
    return t.to(device) if w == 0 else t.to(device, copy=True)


def _compact(t: torch.Tensor, device) -> torch.Tensor:
    """A dense copy of ``t`` (a slice) on ``device`` that shares no
    storage with it: a shard never keeps its replica alive."""
    return t.to(device, copy=True, memory_format=torch.contiguous_format)


def _source(src, w: int, worker) -> int:
    """The worker of ``src`` whose tensors feed ``worker`` (worker w of
    the destination): itself when it is in ``src``, else (an adopted
    worker) ``src`` worker ``w mod src.W``."""
    return (src.workers.index(worker) if worker in src.workers
            else w % src.W)


def replicas_across(xs: List, src, dst) -> List:
    """A replicated value (a tensor or a dict of tensors, one a worker
    of ``src``) on the workers of ``dst``: a worker of both keeps its
    own, an adopted worker receives a copy."""
    out = []
    for w, wk in enumerate(dst.workers):
        if wk in src.workers:
            out.append(xs[src.workers.index(wk)])
            continue
        x = xs[w % src.W]
        out.append({k: None if v is None else v.to(wk.device, copy=True)
                    for k, v in x.items()} if isinstance(x, dict)
                   else x.to(wk.device, copy=True))
    return out


def shard_across(ps: List[Params], src, dst, shard) -> List[Params]:
    """TP shards (``shard``: ``shard_attn`` or ``shard_mlp``) on every
    worker of ``dst`` from the full replicas on the workers of ``src``."""
    return [shard(ps[_source(src, w, wk)], w, dst.W, wk.device)
            for w, wk in enumerate(dst.workers)]


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def shard_attn(p: Params, w: int, W: int, device=None) -> Params:
    """Worker w's TP shard of a full attention replica (kv heads are not
    replicated: ``kv_replication == 1``): q/k/v columns of its heads and
    the ``wo`` rows of its q heads, each a compact tensor of its own (on
    ``device``, by default the replica's)."""
    dev = p["wq"].device if device is None else device

    def cols(t):
        n = t.shape[1] // W
        return _compact(t[:, w * n:(w + 1) * n], dev)

    n = p["wo"].shape[0] // W
    return {"wq": cols(p["wq"]), "wk": cols(p["wk"]), "wv": cols(p["wv"]),
            "wo": _compact(p["wo"][w * n:(w + 1) * n], dev)}


def gather_attn(ps: List[Params], mesh, dst=None) -> List[Params]:
    """Full attention replicas, one a worker of ``dst`` (default
    ``mesh``), from the shards on the workers of ``mesh``."""
    cols = {k: mesh.all_gather([p[k] for p in ps], 1, dst)
            for k in ("wq", "wk", "wv")}
    wo = mesh.all_gather([p["wo"] for p in ps], 0, dst)
    return [{"wq": cols["wq"][w], "wk": cols["wk"][w], "wv": cols["wv"][w],
             "wo": wo[w]} for w in range(len(wo))]


def shard_mlp(p: Params, w: int, W: int, device=None) -> Params:
    """Worker w's FFN shard of a full replica in the Eq. 2 layout:
    ``wi`` [gate_w | up_w] (d, 2*ffp/W) and ``wo`` rows (ffp/W, d).  A
    replica laid out for S shards gives each of W workers S/W
    consecutive ones: ``[g_a 0 g_b 0 | u_a 0 u_b 0]``, itself an Eq. 2
    layout (``mlp_shards``)."""
    dev = p["wi"].device if device is None else device
    d, ffp = p["wi"].shape[0], p["wi"].shape[1] // 2
    fs = ffp // W
    wi = _compact(p["wi"].view(d, 2, W, fs)[:, :, w], dev)
    return {"wi": wi.view(d, 2 * fs),
            "wo": _compact(p["wo"][w * fs:(w + 1) * fs], dev)}


def gather_mlp(ps: List[Params], mesh, dst=None) -> List[Params]:
    """Full MLP replicas (on the workers of ``dst``, default ``mesh``)
    from the shards on the workers of ``mesh``: gate and up halves are
    gathered shard by shard into [gate | up]."""
    d, fs2 = ps[0]["wi"].shape
    wi = mesh.all_gather([p["wi"].view(d, 2, fs2 // 2) for p in ps], 2, dst)
    wo = mesh.all_gather([p["wo"] for p in ps], 0, dst)
    return [{"wi": wi[w].view(d, -1), "wo": wo[w]} for w in range(len(wo))]


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
                mesh, dst=None) -> List[pp.PagedState]:
    """The ``TP`` cache after a scale-up migration from the workers of
    ``mesh`` to those of ``dst`` (default ``mesh``): the migrated pools
    and the metadata of every slot, replicated."""
    dst = dst or mesh
    B = sum(s.page_table.shape[0] for s in states)
    mps = states[0].page_table.shape[1]
    seq = mesh.all_gather([s.seq_lens for s in states], 0, dst)
    pos = mesh.all_gather([s.positions for s in states], 0, dst)
    return [pp.PagedState(pools[w], identity_page_table(B, mps, d), seq[w],
                          pos[w]) for w, d in enumerate(dst.devices)]


def cache_to_rep(states: List[pp.PagedState], pools: List[torch.Tensor],
                 mesh, dst=None) -> List[pp.PagedState]:
    """The ``REP`` cache after a scale-down migration from the workers of
    ``mesh`` to those of ``dst`` (default ``mesh``): each worker keeps
    its own slots' rows of the replicated metadata, as compact tensors."""
    dst = dst or mesh
    B, mps = states[0].page_table.shape
    out = []
    for w, wk in enumerate(dst.workers):
        lo, hi = rows_of(REP, B, dst.W, w)
        s = states[_source(mesh, w, wk)]
        out.append(pp.PagedState(
            pools[w], identity_page_table(hi - lo, mps, wk.device),
            _compact(s.seq_lens[lo:hi], wk.device),
            _compact(s.positions[lo:hi], wk.device)))
    return out
