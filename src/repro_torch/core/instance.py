"""Sharding rules of an instance spread over W workers.

The counterpart of ``repro.core.instance``'s PartitionSpec trees
(``:57-133``), as explicit functions that split one layer's weights and
paged cache into per-worker tensors for a layout and join them back.  A
layout of a W-worker assembly is a ``launch.mesh.Layout(sp, tp)`` whose
degree ``sp * tp`` divides W (``Layout(1, t)`` is pure TP; ``tp``
divides the padding plan's ``max_tp``): ``(rep = W/degree) x
sp x tp``, ordered as the reference's ``make_instance_mesh`` reshape
orders its devices, so worker w is in replica ``r = w // degree``, sp
shard ``s = (w // tp) % sp`` and at tp position ``p = w % tp``
(``launch.mesh.place``).  One rule holds for every layout, as the
reference's one PartitionSpec tree does (pages over ``(rep, sp)``, kv
heads over ``tp``):

* replica r owns slots ``[r*B/rep, (r+1)*B/rep)``; its rows, page tables,
  ``seq_lens`` and ``positions`` are on every worker of the replica;
* sp shard s holds pages ``[s*ns, (s+1)*ns)`` of every slot of its
  replica (``ns = mps / sp`` of a slot's ``mps`` pages) under local page
  ids ``slot_local * ns + j`` (an identity page table of ``ns`` columns),
  and its ``positions`` row of a slot holds the GLOBAL positions stored in
  those pages, so the kernels' position masks work unchanged;
* position p holds kv slots ``[p*kvs/tp, (p+1)*kvs/tp)`` of those pages,
  the q heads ``[p*Hq/tp, (p+1)*Hq/tp)`` and the ``wo`` rows of those
  heads, the ``wk``/``wv`` columns of the kv heads its kv slots copy
  (``kv_heads_of``: with replicated kv heads, a whole head that several
  positions hold a copy of, never a blind column slice), and MLP shards
  ``[p*S/tp, (p+1)*S/tp)`` of the ``S`` Eq. 2 shards: the weights of tp
  position p, copied across the sp shards (SP2xTP2 holds TP2x2's
  weights);
* embedding, head and norms are replicated.

TP1 x W is ``Layout(1, 1)`` (every worker a replica and its own slots),
TPW is ``Layout(1, W)``, SP2xTP2 on 4 workers one replica whose pages
split in halves and whose kv heads split in halves.  A layer's attention
(weights and cache) and its MLP each sit at one layout
(``WorkerLayer``); mid-transform the two may differ.  The MLP runs at its
layout's tp over the replica's rows on every sp shard, as the
reference's specs give it.

Every layer also names the assembly of workers its tensors live on
(``WorkerLayer.mesh``).  A cross-instance merge moves a layer from TP1
over the target's own workers to a layout over those plus the adopted
ones (and a split moves it back): the re-sharding functions below take a
source assembly and layout and a destination assembly and layout.  An
adopted worker holds nothing of the layer, so it receives its shard
copied from a worker that holds the source, as the reference's
``device_put`` onto the widened mesh does.

The MLP replicas are in the Eq. 2 layout of ``S`` shards, the width of
the padding plan (``plan.max_tp``: the engine's own W, or the whole
pool's in a cluster), and a TP-t shard is ``S/t`` consecutive of them
(``mlp_shards``).

A recurrent (RGLRU, MLSTM, SLSTM) layer keeps the reference's spec
(``repro/core/instance.py:67-84``, ``:117-122``) in ``attn`` and
``cache``, by leaf name: ``w_in``, ``wq``, ``wk``, ``wv``, ``w_og`` and
``w_zifo`` by column and ``w_out`` by row over tp, every other leaf
(the conv, RGLRU's gates and ``a_param``, ``w_if``, ``r_diag``)
replicated, and its state rows (``paged.recurrent.RecState``) over the
replicas, replicated over sp and tp (mLSTM's ``C`` too: not split by
head).  At TP2 each worker multiplies by its column shards, the TP group
all-gathers the products, the whole cell runs on every worker of the
group, and each worker multiplies its own columns of the cell's output
by its ``w_out`` shard before the all-reduce (``models.model.
rec_workers``).  Its weights and state move in the layer's ``kv`` op
(``move_rec``), as attention weights move with their pages.  An MLSTM or
SLSTM layer has no MLP: its ``mlp`` and ``ln2`` entries are None, its
``ln1`` is the block's ``ln``, and ``move_mlp`` only flips its
``mlp_layout``.

Attention kept whole (the reference's ``transform_attn=False``, the
paper's own choice: its ``P()`` spec puts a whole ``wq``/``wk``/``wv``/
``wo`` on every device, ``repro/core/instance.py:57-71``): an attention
layer then also holds ``WorkerLayer.attn_whole``, one whole replica a
worker in tensors of its own, and its ``attn`` entries are VIEWS of that
worker's replica cut at the layer's tp position (``attn_views``: the
same head bookkeeping as ``shard_attn``).  The walk reads ``attn`` as
always.  A move keeps every replica where it lies and re-cuts the views;
only a worker new to the layer (a merge's adopted one) receives a whole
copy, and a split's shed workers drop theirs with nothing gathered.  A
recurrent mixer keeps its sharded placement in both modes.

``InstanceGroup`` is the counterpart of the reference's owner of the
same name: a thin transformable owner of ``WorkerLayer`` lists that
serves through the engine's layer walk.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.padding import PaddingPlan
from repro_torch.core.weight_transform import MLP_PAIRS
from repro_torch.launch.comm_analysis import TALLY
from repro_torch.launch.mesh import Layout, place
from repro_torch.paged import pool as pp
from repro_torch.paged.recurrent import cat_rows

Params = Dict[str, torch.Tensor]


@dataclass
class WorkerLayer:
    """One decoder layer spread over the workers of ``mesh`` (the
    assembly its tensors live on).  ``attn`` holds the layer's token
    mixer, whatever its kind: attention weights, or a recurrent layer's
    RG-LRU mixer (the model's ``Block.mixer``, there ``attn`` or
    ``rec``).  ``attn_layout`` is the ``Layout`` of the mixer weights
    AND the layer's cache, a paged pool or a recurrent state (they move
    together, in the ``kv`` op of a transform); ``mlp_layout`` that of
    the MLP weights (the ``mlp`` op); an int TP degree given here is
    turned into its ``Layout``.  Every list has one entry a worker of
    ``mesh``; ``mlp`` and ``ln2`` entries are None in a layer without
    an MLP.  ``attn_whole``: with attention kept whole, each worker's
    whole replica, of which its ``attn`` entry is a view (None when the
    attention weights are sharded)."""
    kind: str
    attn_layout: Layout
    mlp_layout: Layout
    ln1: List[torch.Tensor]
    ln2: List[torch.Tensor]
    attn: List[Params]
    mlp: List[Params]
    cache: List
    mesh: Any
    attn_whole: Optional[List[Params]] = None

    def __post_init__(self):
        self.attn_layout = Layout.of(self.attn_layout)
        self.mlp_layout = Layout.of(self.mlp_layout)

    @property
    def has_mlp(self) -> bool:
        return self.mlp[0] is not None


def rows_of(layout: Layout, batch: int, W: int, w: int) -> Tuple[int, int]:
    """The slot range [lo, hi) worker w of a W-worker assembly holds at
    ``layout``: its replica's."""
    d = layout.degree
    per = batch // (W // d)
    r = w // d
    return r * per, (r + 1) * per


def shard_of(layout: Layout, w: int) -> Tuple[int, int]:
    """``(s, sp)``: worker w's sp shard at ``layout`` and the shard
    count.  Shard s holds pages ``[s*ns, (s+1)*ns)`` of each slot."""
    return place(layout, w)[1], layout.sp


def mlp_shards(t: int, S: int, d_ff: int) -> Tuple[int, int]:
    """``(tp, ff)`` for the padded FFN on one worker's MLP at degree
    ``t``: the ``S/t`` Eq. 2 shards its tensor holds and their real
    columns in all."""
    assert S % t == 0 and d_ff % t == 0, (S, d_ff, t)
    return S // t, d_ff // t


def check_degree(plan: PaddingPlan, layout) -> None:
    """Raise unless every tp shard of ``layout`` (a ``Layout`` or a TP
    degree) holds whole q heads and kv slots, and its kv slots copy whole
    kv heads or lie inside one."""
    t = Layout.of(layout).tp
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
    of ``src``; None stays None) on the workers of ``dst``: a worker of
    both keeps its own, an adopted worker receives a copy."""
    out = []
    for w, wk in enumerate(dst.workers):
        if wk in src.workers:
            out.append(xs[src.workers.index(wk)])
            continue
        x = xs[w % src.W]
        if isinstance(x, dict):
            x = {k: None if v is None else v.to(wk.device, copy=True)
                 for k, v in x.items()}
        elif x is not None:
            x = x.to(wk.device, copy=True)
        out.append(x)
    return out


def reshard(ps: List[Params], src, la: Layout, dst, lb: Layout,
            fn: Callable) -> Tuple[List[Params], int, int]:
    """One layer's weights (one dict a worker of ``src``, at layout
    ``la``) at layout ``lb`` on the workers of ``dst``.  Only the tp
    factors matter: every sp shard holds its tp position's weights.
    ``fn(group, ta, tb, p, device)`` builds position p's shard from one
    source TP group (``reshard_attn`` or ``reshard_mlp``).  A worker of
    ``src`` draws on its own TP group and keeps its tensors when its
    shard does not change; an adopted worker draws on a group of
    ``src``.  The bytes of a new shard beyond the share of the split
    its worker held before count as gathered from its peers
    (``comm_analysis.TALLY``): 0 when each worker slices its own
    replica.  Returns the shards, those gathered bytes, and the bytes
    of every new shard tensor (a worker's own slice copied included)."""
    ta, tb = la.tp, lb.tp
    out, moved, copied = [], 0, 0
    for w, wk in enumerate(dst.workers):
        p = w % tb
        own = 0.0      # the share of the new shard the worker held
        if wk in src.workers:
            u = src.workers.index(wk)
            if ta == tb and u % ta == p:
                out.append(ps[u])
                continue
            g = u // ta
            i = u % ta
            own = max(0.0, min((p + 1) / tb, (i + 1) / ta)
                      - max(p / tb, i / ta)) * tb
        else:
            g = (w // tb) % (src.W // ta)
        out.append(fn(ps[g * ta:(g + 1) * ta], ta, tb, p, wk.device))
        new = _nbytes(out[-1])
        copied += new
        moved += round((1.0 - own) * new)
    TALLY.add("all-gather", moved)
    return out, moved, copied


def _nbytes(p: Params) -> int:
    return sum(t.numel() * t.element_size() for t in p.values()
               if t is not None)


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


def attn_views(p: Params, t: int, pos: int, plan: PaddingPlan) -> Params:
    """Position ``pos``'s TP-t shard of a whole attention replica as
    VIEWS of its tensors (no copy): the q-head columns of ``wq`` and rows
    of ``wo``, and the ``wk``/``wv`` columns of the kv heads its kv slots
    copy (``kv_heads_of``), the slices ``shard_attn`` copies out."""
    if t == 1:
        return dict(p)
    check_degree(plan, t)
    Hq = plan.q_heads_padded
    dh = p["wq"].shape[1] // Hq
    per = Hq // t
    q0, q1 = pos * per * dh, (pos + 1) * per * dh
    lo, hi = kv_heads_of(plan, t, pos)
    return {"wq": p["wq"][:, q0:q1], "wk": p["wk"][:, lo * dh:hi * dh],
            "wv": p["wv"][:, lo * dh:hi * dh], "wo": p["wo"][q0:q1]}


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
    an Eq. 2 layout (``mlp_shards``).  A MoE layer's expert tensors
    ``wi (Ep, d, 2*ffp)`` / ``wo (Ep, ffp, d)`` split the same way with
    the expert axis in front (every shard holds every expert, as the
    reference shards ``wi``'s last axis and ``wo``'s second-to-last), its
    shared expert as a dense MLP; the router is replicated
    (``move_mlp``) and is not part of the shard."""
    out = {}
    for a_key, b_key in MLP_PAIRS:
        if a_key not in group[0]:
            continue
        wi0 = group[0][a_key]
        lead, d = wi0.shape[:-2], wi0.shape[-2]
        per = S // ta
        fs = group[0][b_key].shape[-2] // per
        # [gate | up] halves, or one for an ungated MLP, whose S blocks
        # are contiguous column runs of its own layout (the reference's
        # split of ``wi``'s last axis)
        g = wi0.shape[-1] // group[0][b_key].shape[-2]
        runs = _runs(p * S // tb, (p + 1) * S // tb, per)
        wi = _join([group[i][a_key].view(*lead, d, g, per, fs)[..., a:b, :]
                    for i, a, b in runs], -2, device)
        wo = _join([group[i][b_key].view(*lead, per, fs, d)[..., a:b, :, :]
                    for i, a, b in runs], -3, device)
        out[a_key], out[b_key] = wi.view(*lead, d, -1), wo.view(*lead, -1, d)
    return out


def shard_mlp(p: Params, t: int, pos: int, S: int, device=None) -> Params:
    """Position ``pos``'s TP-t shard of a full MLP replica laid out for
    ``S`` Eq. 2 shards."""
    dev = p["wi"].device if device is None else device
    return reshard_mlp([p], 1, t, pos, S, dev)


def shard_static(st: Dict, t: int, pos: int, plan: PaddingPlan, S: int,
                 device=None) -> Dict:
    """Position ``pos``'s TP-t shard of one worker's static weights: an
    encoder-decoder's encoder layers (attention by heads, the ungated MLP
    by column blocks) and each decoder group's cross weights (``ln_x``
    whole, {wq, wk, wv, wo} by heads), as the reference's name rules
    place them (``repro/launch/sharding.py:72-76``); ``frame_proj``,
    norms, the embedding and the head stay whole.  Without an encoder,
    ``st`` itself."""
    if "encoder" not in st or t == 1:
        return st
    enc = st["encoder"]
    layers = [{**lp, "attn": shard_attn(lp["attn"], t, pos, plan, device),
               "mlp": shard_mlp(lp["mlp"], t, pos, S, device)}
              for lp in enc["layers"]]
    cross = [{"ln_x": c["ln_x"], **shard_attn(c, t, pos, plan, device)}
             for c in st["cross"]]
    return {**st, "encoder": {**enc, "layers": layers}, "cross": cross}


def place_at(layers: List[WorkerLayer], static: List[Dict], lay: Layout,
             plan: PaddingPlan, batch: int, cache_of: Callable
             ) -> List[Dict]:
    """Re-lay layers that ``place_replicas`` put at TP1 x W at the
    pure-TP layout ``lay`` on the same workers, in place: each worker
    slices its own replica (mixer and MLP shards of its tp position, as
    compact tensors), its cache a fresh one at ``lay``
    (``cache_of(kind, batch, device)`` gives the global cache of
    ``batch`` slots, ``split_cache`` its parts), and the layers' layouts
    flip.  Returns the static weights sharded likewise
    (``shard_static``): how an engine that never changes degree live
    (an encoder-decoder) is placed at TP>1."""
    tp, S = lay.tp, plan.max_tp
    check_degree(plan, lay)
    mesh = layers[0].mesh if layers else None
    for layer in layers:
        devs = layer.mesh.devices
        if layer.cache[0].recurrent:
            layer.attn = [reshard_rec([a], 1, tp, w % tp, devs[w])
                          for w, a in enumerate(layer.attn)]
        else:
            layer.attn = [shard_attn(a, tp, w % tp, plan, devs[w])
                          for w, a in enumerate(layer.attn)]
        if layer.has_mlp:
            layer.mlp = [{**shard_mlp(m, tp, w % tp, S, devs[w]),
                          **({"router": m["router"]} if "router" in m
                             else {})}
                         for w, m in enumerate(layer.mlp)]
        layer.cache = split_cache(cache_of(layer.kind, batch, devs[0]),
                                  lay, devs)
        layer.attn_layout = layer.mlp_layout = lay
    devs = mesh.devices if mesh is not None else [None] * len(static)
    return [shard_static(st, tp, w % tp, plan, S, devs[w])
            for w, st in enumerate(static)]


def move_mlp(layer: WorkerLayer, dst, lb: Layout, S: int) -> None:
    """The layer's MLP at layout ``lb`` on the workers of ``dst`` (its
    ``mesh`` still names the source assembly).  A MoE router follows as
    a replicated value.  A layer without an MLP only takes the layout."""
    if not layer.has_mlp:
        layer.mlp = [None] * dst.W
        layer.mlp_layout = lb
        return
    new, _, _ = reshard(
        layer.mlp, layer.mesh, layer.mlp_layout, dst, lb,
        lambda g, ta, b, p, dev: reshard_mlp(g, ta, b, p, S, dev))
    if "router" in layer.mlp[0]:
        routers = replicas_across([p["router"] for p in layer.mlp],
                                  layer.mesh, dst)
        new = [{**p, "router": r} for p, r in zip(new, routers)]
    layer.mlp = new
    layer.mlp_layout = lb


def pages_per_slot(layer: WorkerLayer) -> int:
    """A slot's pages in all (``mps``): the shard's page-table columns
    times the layout's sp."""
    return layer.cache[0].page_table.shape[1] * layer.attn_layout.sp


#: recurrent-mixer leaves split by column and by row over tp (the
#: reference's ``_leaf_pspec`` by name); every other leaf is replicated
REC_COLUMN_LEAVES = ("w_in", "wq", "wk", "wv", "w_og", "w_zifo")
REC_ROW_LEAVES = ("w_out",)


def reshard_rec(group: List[Params], ta: int, tb: int, p: int, device
                ) -> Params:
    """Position p's recurrent-mixer shard at degree ``tb`` from the
    ``ta`` shards of one source TP group: columns ``[p*n/tb,
    (p+1)*n/tb)`` of each column leaf (``REC_COLUMN_LEAVES``, ``n``
    columns in all) and rows ``[p*n/tb, (p+1)*n/tb)`` of ``w_out``, each
    a compact tensor of its own on ``device``; the other leaves copied
    (replicated)."""
    out = {}
    for k, x in group[0].items():
        if k in REC_COLUMN_LEAVES or k in REC_ROW_LEAVES:
            dim = 1 if k in REC_COLUMN_LEAVES else 0
            n = x.shape[dim] * ta
            runs = _runs(p * n // tb, (p + 1) * n // tb, n // ta)
            out[k] = _join([group[i][k].narrow(dim, a, b - a)
                            for i, a, b in runs], dim, device)
        else:
            out[k] = _compact(group[p % ta][k], device)
    return out


def move_rec(layer: WorkerLayer, dst, lb: Layout) -> Tuple[int, int, int]:
    """A recurrent layer's state rows (``kv_transform.regroup_rec``) and
    mixer weights at layout ``lb`` on the workers of ``dst``; returns
    ``(state bytes copied, mixer bytes gathered, mixer bytes copied)``
    (``reshard``)."""
    from repro_torch.core.kv_transform import regroup_rec
    src, la = layer.mesh, layer.attn_layout
    layer.cache, moved = regroup_rec(layer.cache, src, la, dst, lb)
    layer.attn, gathered, copied = reshard(layer.attn, src, la, dst, lb,
                                           reshard_rec)
    layer.attn_layout = lb
    return moved, gathered, copied


def move_attn(layer: WorkerLayer, dst, lb: Layout, plan: PaddingPlan
              ) -> Tuple[int, int, int]:
    """The layer's paged cache (``kv_transform.migrate_sharded``) and
    attention weights at layout ``lb`` on the workers of ``dst``.
    Returns ``(kv, gathered, copied)``: the bytes the migration's
    kernels and exchange moved, the weight bytes that came from another
    worker, and the weight bytes written into new tensors.  Attention
    kept whole moves only to adopted workers and re-cuts the views
    (``attn_views``): ``(kv, b, b)`` with b the adopted copies' bytes.  A
    recurrent layer's state and mixer move instead (``move_rec``)."""
    from repro_torch.core.kv_transform import migrate_sharded
    if layer.cache[0].recurrent:
        return move_rec(layer, dst, lb)
    src, la = layer.mesh, layer.attn_layout
    mps = pages_per_slot(layer)
    new, moved = migrate_sharded([c.pool for c in layer.cache], src, la,
                                 dst, lb, mps)
    layer.cache = cache_to(layer.cache, new, src, la, dst, lb)
    if layer.attn_whole is not None:
        layer.attn_whole = replicas_across(layer.attn_whole, src, dst)
        gathered = copied = sum(
            _nbytes(p) for p, wk in zip(layer.attn_whole, dst.workers)
            if wk not in src.workers)
        layer.attn = [attn_views(p, lb.tp, w % lb.tp, plan)
                      for w, p in enumerate(layer.attn_whole)]
    else:
        layer.attn, gathered, copied = reshard(
            layer.attn, src, la, dst, lb,
            lambda g, a, b, p, dev: reshard_attn(g, a, b, p, plan, dev))
    layer.attn_layout = lb
    return moved, gathered, copied


# ---------------------------------------------------------------------------
# Paged caches
# ---------------------------------------------------------------------------

def place_replicas(blocks: Sequence[Tuple], static: Dict, mesh,
                   share: bool, batch: int, cache_of: Callable,
                   whole_attn: bool = False
                   ) -> Tuple[List[WorkerLayer], List[Dict]]:
    """Layers at TP1 x W on ``mesh``: every worker a replica of
    ``blocks`` (``(kind, ln1, ln2, attn, mlp)`` a layer, ``ln2`` and
    ``mlp`` None without an MLP) and its own empty cache of ``batch/W``
    slots, ``cache_of(kind, rows, device)`` (a paged pool, a window's
    ring, or a fresh recurrent state), and the replicated ``static``
    weights (embed, final_ln, lm_head; a vision model's
    ``vision_proj``; an encoder-decoder's ``encoder`` and ``cross``
    trees, dicts and lists of tensors, placed whole on every worker).
    With ``share`` worker 0 takes the given tensors and every other
    worker a copy; without it every worker copies.  ``whole_attn``:
    attention layers keep their replicas whole at every degree
    (``WorkerLayer.attn_whole``; at TP1 the views are the replica)."""
    devs = mesh.devices

    def per_worker(t):
        if t is None:
            return [None] * len(devs)
        if isinstance(t, dict):
            cols = {k: per_worker(v) for k, v in t.items()}
            return [{k: v[w] for k, v in cols.items()}
                    for w in range(len(devs))]
        if isinstance(t, list):
            cols = [per_worker(v) for v in t]
            return [[c[w] for c in cols] for w in range(len(devs))]
        return [own_copy(t.detach(), d, w) if share
                else t.detach().to(d, copy=True)
                for w, d in enumerate(devs)]

    tp1 = Layout(1, 1)
    rows = batch // len(devs)
    layers = [WorkerLayer(kind, tp1, tp1, per_worker(ln1), per_worker(ln2),
                          per_worker(attn), per_worker(mlp),
                          [cache_of(kind, rows, dev) for dev in devs], mesh)
              for kind, ln1, ln2, attn, mlp in blocks]
    if whole_attn:
        for layer in layers:
            if not layer.cache[0].recurrent:
                layer.attn_whole = layer.attn
                layer.attn = [dict(p) for p in layer.attn_whole]
    return layers, per_worker(static)


def identity_page_table(batch: int, mps: int, device) -> torch.Tensor:
    return (torch.arange(batch, device=device)[:, None] * mps
            + torch.arange(mps, device=device)[None, :]).to(torch.int32)


def join_cache(states: List, layout):
    """The global view of one layer's cache at ``layout`` (a ``Layout``
    or a TP degree; on worker 0's device): pool (NP, kvs, 2, P, dh) under
    global page ids, with the global page table, ``seq_lens`` and
    ``positions``: what the reference's sharded arrays hold.  A
    recurrent layer's: the state rows of every replica, in slot order."""
    lay = Layout.of(layout)
    if states[0].recurrent:
        return cat_rows(states[::lay.degree], states[0].device)
    dev = states[0].pool.device
    d, t = lay.degree, lay.tp
    pools, seqs, poss = [], [], []
    for r in range(0, len(states), d):
        shards = [torch.cat([x.pool.to(dev) for x in states[r + s * t:
                                                               r + s * t + t]],
                            dim=1) for s in range(lay.sp)]
        per, ns = states[r].page_table.shape
        pools.append(torch.cat([x.view(per, ns, *x.shape[1:])
                                for x in shards], dim=1))
        seqs.append(states[r].seq_lens.to(dev))
        poss.append(torch.cat([states[r + s * t].positions.to(dev)
                               for s in range(lay.sp)], dim=1))
    pool = torch.cat(pools)
    B, mps = pool.shape[:2]
    return pp.PagedState(pool.reshape(B * mps, *pool.shape[2:]),
                         identity_page_table(B, mps, dev), torch.cat(seqs),
                         torch.cat(poss))


def split_cache(state, layout, devices: Sequence) -> List:
    """A global cache (``join_cache``'s view) laid out at ``layout`` (a
    ``Layout`` or a TP degree) on ``devices``, each worker's part a
    compact copy: the cache an engine at that layout holds for the same
    bytes (a recurrent state: each worker its replica's rows)."""
    lay = Layout.of(layout)
    W = len(devices)
    if state.recurrent:
        return [state.rows(*rows_of(lay, state.batch, W, w)).to(dev)
                for w, dev in enumerate(devices)]
    B, mps = state.page_table.shape
    kvs = state.pool.shape[1]
    assert mps % lay.sp == 0, (
        f"{lay}: {mps} pages a slot do not split over {lay.sp} shards")
    ns, n, P = mps // lay.sp, kvs // lay.tp, state.pool.shape[3]
    pool = state.pool.view(B, mps, *state.pool.shape[1:])
    out = []
    for w, dev in enumerate(devices):
        lo, hi = rows_of(lay, B, W, w)
        _, s, p = place(lay, w)
        part = pool[lo:hi, s * ns:(s + 1) * ns, p * n:(p + 1) * n]
        out.append(pp.PagedState(
            _compact(part, dev).view((hi - lo) * ns, *part.shape[2:]),
            identity_page_table(hi - lo, ns, dev),
            _compact(state.seq_lens[lo:hi], dev),
            _compact(state.positions[lo:hi, s * ns * P:(s + 1) * ns * P],
                     dev)))
    return out


def cache_to(states: List[pp.PagedState], pools: List[torch.Tensor],
             src, a: Layout, dst, b: Layout) -> List[pp.PagedState]:
    """The cache at layout ``b`` on the workers of ``dst`` after a
    migration (``kv_transform.migrate_sharded``) from layout ``a`` on
    those of ``src``: the migrated pools, and each worker's replica's
    rows of ``seq_lens`` and of its shard's ``positions`` columns, as
    compact tensors of its own."""
    per, ns_a = states[0].page_table.shape
    P = states[0].positions.shape[1] // ns_a
    dev = states[0].positions.device
    # the global metadata, from one tp position of every replica's shards
    seq = torch.cat([states[r].seq_lens.to(dev)
                     for r in range(0, src.W, a.degree)])
    pos = torch.cat([torch.cat([states[r + s * a.tp].positions.to(dev)
                                for s in range(a.sp)], dim=1)
                     for r in range(0, src.W, a.degree)])
    B, mps = seq.shape[0], ns_a * a.sp
    ns = mps // b.sp
    out = []
    for w, wk in enumerate(dst.workers):
        lo, hi = rows_of(b, B, dst.W, w)
        s = place(b, w)[1]
        out.append(pp.PagedState(
            pools[w], identity_page_table(hi - lo, ns, wk.device),
            _compact(seq[lo:hi], wk.device),
            _compact(pos[lo:hi, s * ns * P:(s + 1) * ns * P], wk.device)))
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
    ``seed``; worker 0 takes them, every other worker a copy.
    ``transform_attn=False`` keeps every attention replica whole at each
    degree (the reference's faithful mode): only the MLP and the KV
    move."""

    def __init__(self, cfg, devices: Sequence, batch_per_replica: int,
                 max_seq: int, page_tokens: int = 16, seed: int = 0,
                 params=None, transform_attn: bool = True):
        from repro_torch.core.padding import make_plan
        from repro_torch.core.weight_transform import relayout_block_mlp
        from repro_torch.launch.mesh import InstanceMesh
        from repro_torch.models import model as M
        from repro_torch.models.blocks import init_block_cache

        self.mesh = InstanceMesh(devices, 1)
        self.devices, self.W = self.mesh.workers, self.mesh.W
        self.cfg = cfg
        self.plan = make_plan(cfg, self.W, mode="page")
        self.batch = batch_per_replica * self.W
        self.max_seq, self.page_tokens = max_seq, page_tokens
        self.tp = 1
        self.transform_attn = transform_attn
        self.transform_count = 0
        self._session = None
        if params is None:
            params = M.build(cfg, self.plan, seed,
                             device=self.mesh.devices[0])
            for blk in params.layers:
                relayout_block_mlp(blk.mlp, cfg.d_ff, self.plan.max_tp,
                                   cfg.activation)
        self.layers, self.static = place_replicas(
            [b.parts() for b in params.layers], params.static(), self.mesh,
            True, self.batch,
            lambda kind, rows, dev: init_block_cache(
                kind, cfg, self.plan, rows, max_seq, page_tokens,
                device=dev), whole_attn=not transform_attn)

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
