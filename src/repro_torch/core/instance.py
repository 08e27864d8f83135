"""Sharding rules of an instance spread over W workers.

The counterpart of ``repro.core.instance``'s PartitionSpec trees
(``:57-133``), as explicit functions that split one layer's weights and
paged cache into per-worker tensors for a layout and join them back.  A
layout of a W-worker assembly is its TP degree ``t`` (any divisor of W
that divides the padding plan's ``max_tp``; sequence parallelism is
ROADMAP queue 1 item 6): ``(rep = W/t) x (tp = t)``, ordered as the
reference's ``make_instance_mesh`` reshape orders its devices, so worker
w is in TP group ``g = w // t`` at position ``p = w % t``.  One rule
holds for every ``(rep, tp)``, as the reference's one PartitionSpec tree
does:

* group g owns slots ``[g*B/rep, (g+1)*B/rep)`` and their pages under
  group-local page ids (the pool's pages over ``rep``);
* position p holds kv slots ``[p*kvs/t, (p+1)*kvs/t)`` of every page of
  its group, the q heads ``[p*Hq/t, (p+1)*Hq/t)`` and the ``wo`` rows of
  those heads, the ``wk``/``wv`` columns of the kv heads its kv slots
  copy (``kv_heads_of``: with replicated kv heads, a whole head that
  several positions hold a copy of, never a blind column slice), and
  MLP shards ``[p*S/t, (p+1)*S/t)`` of the ``S`` Eq. 2 shards;
* page tables, ``seq_lens`` and ``positions`` rows of the group's slots
  are on every worker of the group; embedding, head and norms are
  replicated.

TP1 x W is ``t = 1`` (every worker a replica and its own slots), TPW is
``t = W``.  A layer's attention (weights and cache) and its MLP each sit
at one degree (``WorkerLayer``); mid-transform the two may differ.

Every layer also names the assembly of workers its tensors live on
(``WorkerLayer.mesh``).  A cross-instance merge moves a layer from TP1
over the target's own workers to a degree over those plus the adopted
ones (and a split moves it back): the re-sharding functions below take a
source assembly and degree and a destination assembly and degree.  An
adopted worker holds nothing of the layer, so it receives its shard
copied from a worker that holds the source, as the reference's
``device_put`` onto the widened mesh does.

The MLP replicas are in the Eq. 2 layout of ``S`` shards, the width of
the padding plan (``plan.max_tp``: the engine's own W, or the whole
pool's in a cluster), and a TP-t shard is ``S/t`` consecutive of them
(``mlp_shards``).

``InstanceGroup`` is the counterpart of the reference's owner of the
same name: a thin transformable owner of ``WorkerLayer`` lists that
serves through the engine's layer walk.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.padding import PaddingPlan
from repro_torch.paged import pool as pp

Params = Dict[str, torch.Tensor]


@dataclass
class WorkerLayer:
    """One decoder layer spread over the workers of ``mesh`` (the
    assembly its tensors live on).  ``attn_layout`` is the TP degree of
    the attention weights AND the layer's paged cache (they move
    together, in the ``kv`` op of a transform); ``mlp_layout`` that of
    the MLP weights (the ``mlp`` op).  Every list has one entry a worker
    of ``mesh``."""
    kind: str
    attn_layout: int
    mlp_layout: int
    ln1: List[torch.Tensor]
    ln2: List[torch.Tensor]
    attn: List[Params]
    mlp: List[Params]
    cache: List[pp.PagedState]
    mesh: Any


def rows_of(t: int, batch: int, W: int, w: int) -> Tuple[int, int]:
    """The slot range [lo, hi) worker w of a W-worker assembly holds at
    TP degree ``t``: its group's."""
    per = batch // (W // t)
    g = w // t
    return g * per, (g + 1) * per


def mlp_shards(t: int, S: int, d_ff: int) -> Tuple[int, int]:
    """``(tp, ff)`` for the padded FFN on one worker's MLP at degree
    ``t``: the ``S/t`` Eq. 2 shards its tensor holds and their real
    columns in all."""
    assert S % t == 0 and d_ff % t == 0, (S, d_ff, t)
    return S // t, d_ff // t


def check_degree(plan: PaddingPlan, t: int) -> None:
    """Raise unless every TP-t shard holds whole q heads and kv slots,
    and its kv slots copy whole kv heads or lie inside one."""
    if plan.max_tp % t or plan.kv_slots % t or plan.q_heads_padded % t:
        raise ValueError(f"TP{t} does not divide the padding plan "
                         f"(max_tp {plan.max_tp}, kv slots "
                         f"{plan.kv_slots}, q heads "
                         f"{plan.q_heads_padded})")
    n, r = plan.kv_slots // t, plan.kv_replication
    if n % r and r % n:
        raise NotImplementedError(
            f"TP{t}: a shard of {n} kv slots would straddle the "
            f"{r}-fold copies of two kv heads")


def kv_heads_of(plan: PaddingPlan, t: int, p: int) -> Tuple[int, int]:
    """The kv heads [lo, hi) (columns of ``wk``/``wv``, in heads) whose
    copies fill position p's kv slots at degree ``t``."""
    n, r = plan.kv_slots // t, plan.kv_replication
    return p * n // r, ((p + 1) * n - 1) // r + 1


def own_copy(t: torch.Tensor, device, w: int) -> torch.Tensor:
    """Worker w's tensor of a replicated value: worker 0 takes ``t``
    itself (moved only if it lies elsewhere), every other worker a copy
    of its own."""
    return t.to(device) if w == 0 else t.to(device, copy=True)


def _compact(t: torch.Tensor, device) -> torch.Tensor:
    """A dense copy of ``t`` (a slice) on ``device`` that shares no
    storage with it: a shard never keeps its replica alive."""
    return t.to(device, copy=True, memory_format=torch.contiguous_format)


def _join(pieces: List[torch.Tensor], dim: int, device) -> torch.Tensor:
    """The pieces concatenated along ``dim`` into a tensor of its own on
    ``device``."""
    if len(pieces) == 1:
        return _compact(pieces[0], device)
    return torch.cat([x.to(device) for x in pieces], dim=dim)


def _runs(lo: int, hi: int, per: int) -> List[Tuple[int, int, int]]:
    """Units [lo, hi) cut where sources of ``per`` units each meet:
    ``(source, local lo, local hi)`` runs."""
    out = []
    while lo < hi:
        i = lo // per
        end = min(hi, (i + 1) * per)
        out.append((i, lo - i * per, end - i * per))
        lo = end
    return out


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


def reshard(ps: List[Params], src, ta: int, dst, tb: int,
            fn: Callable) -> List[Params]:
    """One layer's weights (one dict a worker of ``src``, at degree
    ``ta``) at degree ``tb`` on the workers of ``dst``.  ``fn(group, ta,
    tb, p, device)`` builds position p's shard from one source TP group
    (``reshard_attn`` or ``reshard_mlp``).  A worker of ``src`` draws on
    its own group and keeps its tensors when its shard does not change;
    an adopted worker draws on a group of ``src``."""
    out = []
    for w, wk in enumerate(dst.workers):
        p = w % tb
        if wk in src.workers:
            u = src.workers.index(wk)
            if ta == tb and u % ta == p:
                out.append(ps[u])
                continue
            g = u // ta
        else:
            g = (w // tb) % (src.W // ta)
        out.append(fn(ps[g * ta:(g + 1) * ta], ta, tb, p, wk.device))
    return out


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def reshard_attn(group: List[Params], ta: int, tb: int, p: int,
                 plan: PaddingPlan, device) -> Params:
    """Position p's attention shard at degree ``tb`` from the ``ta``
    shards of one source TP group: its q columns and ``wo`` rows, and the
    ``wk``/``wv`` columns of the kv heads its kv slots copy
    (``kv_heads_of``), each a compact tensor of its own on ``device``."""
    check_degree(plan, tb)
    Hq = plan.q_heads_padded
    d = group[0]["wq"].shape[0]
    dh = group[0]["wq"].shape[1] * ta // Hq
    per = Hq // tb
    q = _runs(p * per, (p + 1) * per, Hq // ta)
    out = {"wq": _join([group[i]["wq"].view(d, -1, dh)[:, a:b]
                        for i, a, b in q], 1, device).view(d, -1),
           "wo": _join([group[i]["wo"].view(-1, dh, d)[a:b]
                        for i, a, b in q], 0, device).view(-1, d)}
    lo, hi = kv_heads_of(plan, tb, p)
    kv = []
    while lo < hi:        # each head from the first source position
        i = lo * plan.kv_replication // (plan.kv_slots // ta)
        s0, s1 = kv_heads_of(plan, ta, i)
        end = min(hi, s1)
        kv.append((i, lo - s0, end - s0))
        lo = end
    for k in ("wk", "wv"):
        out[k] = _join([group[i][k].view(d, -1, dh)[:, a:b]
                        for i, a, b in kv], 1, device).view(d, -1)
    return {k: out[k] for k in ("wq", "wk", "wv", "wo")}


def shard_attn(p: Params, t: int, pos: int, plan: PaddingPlan,
               device=None) -> Params:
    """Position ``pos``'s TP-t shard of a full attention replica."""
    dev = p["wq"].device if device is None else device
    return reshard_attn([p], 1, t, pos, plan, dev)


def gather_attn(ps: List[Params], plan: PaddingPlan, device=None) -> Params:
    """A full attention replica from the shards of one TP group."""
    dev = ps[0]["wq"].device if device is None else device
    return reshard_attn(ps, len(ps), 1, 0, plan, dev)


def reshard_mlp(group: List[Params], ta: int, tb: int, p: int, S: int,
                device) -> Params:
    """Position p's MLP shard at degree ``tb`` (Eq. 2 shards ``[p*S/tb,
    (p+1)*S/tb)``) from the ``ta`` shards of one source TP group: ``wi``
    ``[gate_p | up_p]`` and the matching ``wo`` rows.  A shard of S/t
    consecutive Eq. 2 shards is ``[g_a 0 g_b 0 | u_a 0 u_b 0]``, itself
    an Eq. 2 layout (``mlp_shards``)."""
    d = group[0]["wi"].shape[0]
    per = S // ta
    fs = group[0]["wo"].shape[0] // per
    runs = _runs(p * S // tb, (p + 1) * S // tb, per)
    wi = _join([group[i]["wi"].view(d, 2, per, fs)[:, :, a:b]
                for i, a, b in runs], 2, device)
    wo = _join([group[i]["wo"].view(per, fs, d)[a:b] for i, a, b in runs],
               0, device)
    return {"wi": wi.view(d, -1), "wo": wo.view(-1, d)}


def shard_mlp(p: Params, t: int, pos: int, S: int, device=None) -> Params:
    """Position ``pos``'s TP-t shard of a full MLP replica laid out for
    ``S`` Eq. 2 shards."""
    dev = p["wi"].device if device is None else device
    return reshard_mlp([p], 1, t, pos, S, dev)


def move_mlp(layer: WorkerLayer, dst, tb: int, S: int) -> None:
    """The layer's MLP at degree ``tb`` on the workers of ``dst`` (its
    ``mesh`` still names the source assembly)."""
    layer.mlp = reshard(
        layer.mlp, layer.mesh, layer.mlp_layout, dst, tb,
        lambda g, ta, b, p, dev: reshard_mlp(g, ta, b, p, S, dev))
    layer.mlp_layout = tb


def move_attn(layer: WorkerLayer, dst, tb: int, plan: PaddingPlan) -> int:
    """The layer's paged cache (``kv_transform.migrate_sharded``) and
    attention weights at degree ``tb`` on the workers of ``dst``; returns
    the bytes the migration's kernels and exchange moved."""
    from repro_torch.core.kv_transform import migrate_sharded
    src, ta = layer.mesh, layer.attn_layout
    new, moved = migrate_sharded([c.pool for c in layer.cache], src, ta,
                                 dst, tb)
    layer.cache = cache_to(layer.cache, new, src, ta, dst, tb)
    layer.attn = reshard(
        layer.attn, src, ta, dst, tb,
        lambda g, a, b, p, dev: reshard_attn(g, a, b, p, plan, dev))
    layer.attn_layout = tb
    return moved


# ---------------------------------------------------------------------------
# Paged caches
# ---------------------------------------------------------------------------

def place_replicas(blocks: Sequence[Tuple], static: Dict, mesh,
                   share: bool, kvs: int, page_tokens: int, dh: int,
                   batch: int, mps: int
                   ) -> Tuple[List[WorkerLayer], List[Dict]]:
    """Layers at TP1 x W on ``mesh``: every worker a replica of
    ``blocks`` (``(kind, ln1, ln2, attn, mlp)`` a layer) and an empty
    pool of ``batch/W`` slots of ``mps`` pages, and the replicated
    ``static`` weights (embed, final_ln, lm_head).  With ``share`` worker
    0 takes the given tensors and every other worker a copy; without it
    every worker copies."""
    devs = mesh.devices

    def per_worker(t):
        return [own_copy(t.detach(), d, w) if share
                else t.detach().to(d, copy=True)
                for w, d in enumerate(devs)]

    def dicts(p):
        cols = {k: per_worker(v) for k, v in p.items()}
        return [{k: v[w] for k, v in cols.items()} for w in range(len(devs))]

    layers = [WorkerLayer(kind, 1, 1, per_worker(ln1), per_worker(ln2),
                          dicts(attn), dicts(mlp),
                          init_worker_caches(kvs, page_tokens, dh, batch,
                                             mps, static["embed"].dtype,
                                             devs), mesh)
              for kind, ln1, ln2, attn, mlp in blocks]
    cols = {k: None if v is None else per_worker(v)
            for k, v in static.items()}
    return layers, [{k: None if v is None else v[w]
                     for k, v in cols.items()} for w in range(len(devs))]


def identity_page_table(batch: int, mps: int, device) -> torch.Tensor:
    return (torch.arange(batch, device=device)[:, None] * mps
            + torch.arange(mps, device=device)[None, :]).to(torch.int32)


def join_cache(states: List[pp.PagedState], t: int) -> pp.PagedState:
    """The global view of one layer's cache at degree ``t`` (on worker
    0's device): pool (NP, kvs, 2, P, dh) under global page ids, with
    the global page table, ``seq_lens`` and ``positions`` — what the
    reference's sharded arrays hold."""
    dev = states[0].pool.device
    lead = states[::t]
    pool = torch.cat([torch.cat([s.pool.to(dev) for s in states[g:g + t]],
                                dim=1) for g in range(0, len(states), t)])
    B = sum(s.page_table.shape[0] for s in lead)
    mps = states[0].page_table.shape[1]
    return pp.PagedState(
        pool, identity_page_table(B, mps, dev),
        torch.cat([s.seq_lens.to(dev) for s in lead]),
        torch.cat([s.positions.to(dev) for s in lead]))


def split_cache(state: pp.PagedState, t: int, devices: Sequence
                ) -> List[pp.PagedState]:
    """A global cache (``join_cache``'s view) laid out at degree ``t`` on
    ``devices``, each worker's part a compact copy: the cache an engine
    at that degree holds for the same bytes."""
    W = len(devices)
    B, mps = state.page_table.shape
    kvs = state.pool.shape[1]
    out = []
    for w, dev in enumerate(devices):
        lo, hi = rows_of(t, B, W, w)
        p, n = w % t, kvs // t
        out.append(pp.PagedState(
            _compact(state.pool[lo * mps:hi * mps, p * n:(p + 1) * n], dev),
            identity_page_table(hi - lo, mps, dev),
            _compact(state.seq_lens[lo:hi], dev),
            _compact(state.positions[lo:hi], dev)))
    return out


def init_worker_caches(kvs: int, page_tokens: int, dh: int, batch: int,
                       mps: int, dtype, devices) -> List[pp.PagedState]:
    """Empty slot-partitioned caches at TP1: each worker's B/W slots
    under local page ids."""
    W = len(devices)
    per = batch // W
    return [pp.make_state(per * mps, kvs, page_tokens, dh, per, mps, dtype,
                          device=d) for d in devices]


def cache_to(states: List[pp.PagedState], pools: List[torch.Tensor],
             src, ta: int, dst, tb: int) -> List[pp.PagedState]:
    """The cache at degree ``tb`` on the workers of ``dst`` after a
    migration (``kv_transform.migrate_sharded``) from degree ``ta`` on
    those of ``src``: the migrated pools, and each worker's group's rows
    of ``seq_lens`` and ``positions`` as compact tensors of its own."""
    rep = src.W // ta
    per, mps = states[0].page_table.shape
    B = per * rep
    out = []
    for w, wk in enumerate(dst.workers):
        lo, hi = rows_of(tb, B, dst.W, w)
        rows = _runs(lo, hi, per)
        seq = _join([states[g * ta].seq_lens[a:b] for g, a, b in rows], 0,
                    wk.device)
        pos = _join([states[g * ta].positions[a:b] for g, a, b in rows], 0,
                    wk.device)
        out.append(pp.PagedState(pools[w],
                                 identity_page_table(hi - lo, mps,
                                                     wk.device), seq, pos))
    return out


# ---------------------------------------------------------------------------
# The transformable instance group
# ---------------------------------------------------------------------------

class InstanceGroup:
    """W workers serving one model with a transformable TP degree: the
    counterpart of the reference's ``InstanceGroup`` (``:140-276``), a
    thin owner of ``WorkerLayer`` lists that serves through the engine's
    layer walk (``models.model.walk_layers``).  ``batch_per_replica * W``
    slots of ``max_seq`` tokens each, a fixed pool at every degree (the
    serving engine's memory-follows-degree resize is not the group's).
    Weights: ``params`` (a ``Model`` planned for ``make_plan(cfg, W,
    "page")`` with its MLP in that plan's Eq. 2 layout) or random from
    ``seed``; worker 0 takes them, every other worker a copy."""

    def __init__(self, cfg, devices: Sequence, batch_per_replica: int,
                 max_seq: int, page_tokens: int = 16, seed: int = 0,
                 params=None):
        from repro_torch.core.padding import make_plan
        from repro_torch.core.weight_transform import relayout_mlp_for_tp
        from repro_torch.launch.mesh import InstanceMesh
        from repro_torch.models import model as M

        self.mesh = InstanceMesh(devices, 1)
        self.devices, self.W = self.mesh.workers, self.mesh.W
        self.cfg = cfg
        self.plan = make_plan(cfg, self.W, mode="page")
        self.batch = batch_per_replica * self.W
        self.max_seq, self.page_tokens = max_seq, page_tokens
        self.tp = 1
        self.transform_count = 0
        self._session = None
        if params is None:
            params = M.build(cfg, self.plan, seed,
                             device=self.mesh.devices[0])
            for blk in params.layers:
                blk.mlp["wi"].data, blk.mlp["wo"].data = \
                    relayout_mlp_for_tp(blk.mlp["wi"].data,
                                        blk.mlp["wo"].data, cfg.d_ff,
                                        self.plan.max_tp)
        blocks = [(b.kind, b.ln1, b.ln2, dict(b.attn), dict(b.mlp))
                  for b in params.layers]
        self.layers, self.static = place_replicas(
            blocks, params.static(), self.mesh, True, self.plan.kv_slots,
            page_tokens, cfg.resolved_head_dim, self.batch,
            -(-max_seq // page_tokens))

    # -- the paper's §4: the transformation -----------------------------
    def transform(self, new_tp: int) -> None:
        """Re-shard every layer to degree ``new_tp`` at once (the
        scheduled session run to its end with no serving between)."""
        assert self._session is None, "scheduled transformation open"
        self.transform_scheduled(new_tp)

    def begin_transform(self, new_tp: int, layers_per_step: int = 1):
        """Open the §4.3 session (MLP-first on scale-up, layer-staggered
        on scale-down, reversed traversal) and return it; ``decode``
        serves between its steps."""
        from repro_torch.core import transform_engine as TE
        return TE.open_owner_session(self, new_tp, layers_per_step)

    def finish_transform(self) -> None:
        from repro_torch.core import transform_engine as TE
        TE.close_owner_session(self)
        self.transform_count += 1

    def transform_scheduled(self, new_tp: int, layers_per_step: int = 1,
                            between_steps=None) -> List:
        """A whole scheduled transformation; ``between_steps(report)``
        runs after each step.  Returns the step reports."""
        if new_tp == self.tp:
            return []
        reports = self.begin_transform(new_tp, layers_per_step).run(
            between_steps)
        self.finish_transform()
        return reports

    # -- serving -----------------------------------------------------------
    def _walk(self, tokens: torch.Tensor, positions: torch.Tensor,
              mode: str) -> torch.Tensor:
        from repro_torch.models import model as M
        s = self._session
        static, smesh = ((s.static, s.static_mesh) if s is not None
                         else (self.static, self.mesh))
        return M.walk_layers(
            self.layers, static, self.cfg, self.plan, smesh,
            M.RowSet(range(self.batch), self.batch), tokens, positions,
            mode, on_layer=None if s is None else s.on_decode_layer)

    @torch.no_grad()
    def prefill(self, batch) -> torch.Tensor:
        """Whole prompts of every slot from position 0 (``batch``: the
        tokens (B, S), or a dict holding them under ``tokens``).
        Returns the last token's logits (B, vocab_padded)."""
        assert self._session is None, (
            "prefill during a scheduled transformation")
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        tokens = torch.as_tensor(tokens, dtype=torch.long).cpu()
        positions = torch.arange(tokens.shape[1], dtype=torch.int32)
        return self._walk(tokens, positions.expand(tokens.shape), "seq")

    @torch.no_grad()
    def decode(self, tokens, positions) -> torch.Tensor:
        """One token of every slot (tokens, positions: (B,)); mid-session
        the walk streams the staged layer groups.  Returns logits (B,
        vocab_padded)."""
        tokens = torch.as_tensor(tokens, dtype=torch.long).cpu()[:, None]
        positions = torch.as_tensor(positions,
                                    dtype=torch.int32).cpu()[:, None]
        out = self._walk(tokens, positions, "decode")
        if self._session is not None:
            self._session.dispatch_step_drain()
        return out
