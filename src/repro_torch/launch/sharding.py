"""Placements of parameters, optimizer state, caches and batches on the
training grid: the counterpart of ``repro.launch.sharding``
(Megatron-style TP over ``model``, FSDP and data parallelism over pod x
data).

A placement is a tuple with one entry a dim, as a ``PartitionSpec``
has: None (whole), an axis name, or a tuple of names (the dim split over
those axes together, the first slowest).  A dim split over k workers is
cut in k contiguous chunks; worker w holds chunk ``grid.position(w,
names)``.

The decisions are the reference's, made leaf by leaf over the port's
named parameters.  The reference stacks the layers of each pattern
position over G groups (and an encoder's over its depth, the cross-
attention weights over G); the port keeps a list of layers.  Each port
leaf is therefore judged as the reference's leaf it maps to
(``reference_leaf``: the correspondence of ``models.convert``, with the
stacked leading dim), and the stacked dim's entry, which the rules
never fill, is dropped.  So a stacked norm ``(G, d)`` shards ``d`` over
data under FSDP, and a remainder layer's ``(d,)`` norm stays whole, as
in the reference.

``place`` gives each worker its own shard of every leaf (a tensor of its
own: no worker's tensor aliases another's, even on one device) and
``gather`` joins the shards into logical leaves.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.padding import PaddingPlan
from repro_torch.launch.mesh import Grid, spec_axes

MODEL = "model"

Spec = Tuple[Any, ...]


def _unit_len(cfg: ModelConfig) -> int:
    return len(cfg.layer_pattern) if cfg.layer_pattern else 1


def reference_leaf(name: str, shape: Sequence[int], cfg: ModelConfig
                   ) -> Tuple[str, Tuple[int, ...], int]:
    """The reference's leaf for the port's parameter ``name`` of
    ``shape``: (its path, its shape, the number of stacked leading dims
    the port's leaf lacks: 1 for a layer of a stacked group, an encoder
    layer or a group's cross-attention, else 0)."""
    shape = tuple(shape)
    parts = name.split(".")
    if parts[0] == "layers":
        li = int(parts[1])
        unit = _unit_len(cfg)
        G = cfg.num_layers // unit
        rest = parts[2:]
        if rest[0] == "rec":
            rest = rest[1:]               # recurrent leaves: top level
        elif rest[0] == "mlp" and rest[1].startswith("shared_"):
            rest = ["mlp", "shared", rest[1][len("shared_"):]]
        if li < G * unit:
            return ("/blocks/%d/" % (li % unit) + "/".join(rest),
                    (G,) + shape, 1)
        return ("/rem/%d/" % (li - G * unit) + "/".join(rest), shape, 0)
    if parts[0] == "encoder" and parts[1] == "layers":
        path = "/encoder/blocks/0/" + "/".join(parts[3:])
        return path, (cfg.encoder.num_layers,) + shape, 1
    if parts[0] == "cross":
        G = cfg.num_layers // _unit_len(cfg)
        return "/cross/" + "/".join(parts[2:]), (G,) + shape, 1
    return "/" + "/".join(parts), shape, 0


def _leaf_pspec(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                experts_padded: int, fsdp: bool, data_size: int,
                expert_mode: str) -> Spec:
    """The reference's rule for one leaf (``repro/launch/sharding.py:
    25-97``) on the reference's shape."""
    ndim = len(shape)

    def build(model_dim: Optional[int], extra: Dict[int, Any] = {}
              ) -> Spec:
        spec: list = [None] * ndim
        if model_dim is not None:
            spec[model_dim] = MODEL
        for i, ax in extra.items():
            spec[i] = ax
        if fsdp and ndim >= 2:
            # shard the other of the last two dims over data when divisible
            for j in (ndim - 1, ndim - 2):
                if spec[j] is None and shape[j] % data_size == 0 \
                        and shape[j] >= data_size:
                    spec[j] = "data"
                    break
        return tuple(spec)

    name = path.split("/")[-1]
    is_expert = (experts_padded > 0 and ndim >= 3
                 and shape[ndim - 3] == experts_padded
                 and name in ("wi", "wo"))
    if name == "router":
        if expert_mode == "tp":
            return build(None)
        return build(ndim - 1)
    if is_expert:
        inner = ndim - 1 if name == "wi" else ndim - 2
        if expert_mode == "tp":
            spec2: list = [None] * ndim
            spec2[inner] = MODEL
            return tuple(spec2)
        if expert_mode == "2d":
            spec3: list = [None] * ndim
            spec3[ndim - 3] = "data"
            spec3[inner] = MODEL
            return tuple(spec3)
        return build(None, {ndim - 3: MODEL})
    if name in ("wq", "wk", "wv", "w_in", "w_og", "w_zifo", "wi",
                "lm_head"):
        return build(ndim - 1)
    if name in ("wo", "w_out", "embed"):
        return build(ndim - 2)
    if fsdp and ndim >= 2:
        return build(None)
    return (None,) * ndim


def decide_expert_mode(cfg: ModelConfig, plan: Optional[PaddingPlan],
                       data_size: int) -> str:
    ep = plan.experts_padded if plan is not None else (
        cfg.moe.num_experts if cfg.moe else 0)
    if not ep:
        return "none"
    n_moe = sum(1 for k in cfg.pattern if k == "moe")
    ffp = plan.d_ff_padded if plan else cfg.d_ff
    total = n_moe * ep * 3 * cfg.d_model * ffp * 2
    return "2d" if (ep % data_size == 0 and total / 16 > 8e9) else "model"


def moe_hint_specs(expert_mode: str, data_size: int = 16) -> Dict[str, Any]:
    """The reference's hints for the blocked MoE dispatch: the block
    count (``moe_blocks``, the one the port's model code reads) and the
    placements the reference pins its dispatch buffer and hidden
    activations to."""
    if expert_mode in ("model", "blocked"):
        return {"moe_blocks": data_size,
                "moe_buf": ("data", MODEL, None, None),
                "moe_hidden": ("data", MODEL, None, None)}
    if expert_mode == "2d":
        return {"moe_blocks": data_size,
                "moe_buf": ("data", None, None, None),
                "moe_hidden": ("data", None, None, MODEL)}
    if expert_mode == "dp":
        return {"moe_blocks": data_size,
                "moe_buf": ("data", None, (MODEL,), None),
                "moe_hidden": ("data", None, (MODEL,), None)}
    if expert_mode == "tp":
        return {"moe_blocks": data_size,
                "moe_buf": ("data", None, None, None),
                "moe_hidden": ("data", None, None, MODEL)}
    return {}


def param_pspecs(params: Dict[str, Any], cfg: ModelConfig,
                 plan: Optional[PaddingPlan] = None, *, fsdp: bool = False,
                 data_size: int = 16, expert_mode: str = "auto"
                 ) -> Dict[str, Spec]:
    """A placement for each of the port's parameters (``params``: name ->
    anything with a ``shape``, e.g. ``dict(model.named_parameters())``
    of a model on ``meta``), the reference's ``param_pspecs`` of the
    leaf it maps to with the stacked dim dropped."""
    ep = plan.experts_padded if plan is not None else (
        cfg.moe.num_experts if cfg.moe else 0)
    if expert_mode == "auto":
        em = decide_expert_mode(cfg, plan, data_size)
        expert_mode = em if em != "none" else "model"
    out = {}
    for name, leaf in params.items():
        path, shape, lead = reference_leaf(name, leaf.shape, cfg)
        spec = _leaf_pspec(path, shape, cfg, ep, fsdp, data_size,
                           expert_mode)
        if any(spec[:lead]):
            raise NotImplementedError(
                f"{name}: the reference shards the stacked layer dim of "
                f"{path} {shape} ({spec}); a list of layers cannot")
        out[name] = spec[lead:]
    return out


def opt_pspecs(params_pspecs: Dict[str, Spec]) -> Tuple:
    """``AdamWState(step, mu, nu)``: the step whole, the moments placed
    like the parameters."""
    return ((), params_pspecs, params_pspecs)


def batch_pspecs(batch_specs: Dict[str, Any], grid: Grid,
                 batch_axes: Tuple[str, ...]) -> Dict[str, Spec]:
    """The batch dim over pod and data when they divide it, else
    whole."""
    n = grid.extent(batch_axes)

    def one(s):
        shape = tuple(s.shape)
        if shape and shape[0] % n == 0 and shape[0] >= n:
            return (batch_axes,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)
    return {k: one(v) for k, v in batch_specs.items()}


def cache_axes(grid: Grid, batch_axes: Tuple[str, ...], batch: int,
               decode_mode: str = "tp") -> Tuple[Any, Any]:
    """(the slots' axes or None, the kv heads' axis or None) of the
    reference's cache placement: slots (pages) over the batch axes when
    they divide the batch, kv-head slots over ``model``; ``tp1`` puts
    the slots over the batch axes and ``model`` together (when those
    divide the batch) and keeps the heads whole (the paper's TP1 decode
    at pod scale)."""
    n_batch = grid.extent(batch_axes)
    page_axes = batch_axes if (batch % n_batch == 0 and batch >= n_batch) \
        else ()
    if decode_mode == "tp1":
        combo = tuple(page_axes) + (MODEL,)
        total = n_batch * grid.shape[MODEL]
        slots = combo if (batch % total == 0 and batch >= total) \
            else page_axes
        return (tuple(slots) or None), None
    return (tuple(page_axes) or None), MODEL


def cache_pspecs(caches: List, grid: Grid, batch_axes: Tuple[str, ...],
                 batch: int, decode_mode: str = "tp", cross=None
                 ) -> Dict[str, Any]:
    """The reference's ``cache_pspecs`` over the port's caches (one state
    a layer, ``Model.init_decode_caches``): ``{"layers": [one dict of
    field -> placement a layer], "cross_kv": placement or None}``.  A
    paged pool ``(NP, kv_slots, 2, P, dh)`` puts its pages over the
    slots' axes and its kv slots over the heads' axis (``cache_axes``);
    its page table, ``seq_lens`` and ``positions`` rows and a recurrent
    state's rows follow the slots; an encoder-decoder's cross memory
    ``(B, F, kv_slots, dh)`` (``cross``, a ``CrossKV``) its batch."""
    slots, heads = cache_axes(grid, batch_axes, batch, decode_mode)

    def one(c):
        if not c.recurrent:
            return {"pool": (slots, heads, None, None, None),
                    "page_table": (slots, None), "seq_lens": (slots,),
                    "positions": (slots, None)}
        return {k: (slots,) + (None,) * (v.dim() - 1)
                for k, v in c.leaves.items()}
    return {"layers": [one(c) for c in caches],
            "cross_kv": None if cross is None else (slots, None, None, None)}


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

def shard_slices(shape: Sequence[int], spec: Spec, grid: Grid, w: int
                 ) -> List[slice]:
    """Worker w's chunk of a leaf of ``shape`` under ``spec``."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = spec_axes(entry)
        k = grid.extent(axes)
        if n % k:
            raise ValueError(f"dim {n} does not split over {axes} ({k})")
        i, c = grid.position(w, axes), n // k
        out.append(slice(i * c, (i + 1) * c))
    return out


def place(tree: Dict[str, torch.Tensor], placements: Dict[str, Spec],
          grid: Grid, requires_grad: bool = False
          ) -> Dict[str, List[torch.Tensor]]:
    """Each leaf of ``tree`` as one shard a worker: a compact tensor of
    its own on the worker's device (``to_shardings`` and ``device_put``
    of the reference)."""
    out = {}
    for name, leaf in tree.items():
        spec, shards = placements[name], []
        for w, dev in enumerate(grid.devices):
            piece = leaf[tuple(shard_slices(leaf.shape, spec, grid, w))]
            t = torch.empty(piece.shape, dtype=leaf.dtype, device=dev)
            t.copy_(piece.detach())
            shards.append(t.requires_grad_(requires_grad))
        out[name] = shards
    return out


def owners(spec: Spec, grid: Grid) -> List[int]:
    """One worker for each distinct shard under ``spec``: those at
    coordinate 0 on every axis the spec does not name."""
    named = {a for e in spec for a in spec_axes(e)}
    return [w for w in range(grid.W)
            if all(c == 0 for a, c in grid.coords(w).items()
                   if a not in named)]


def gather(shards: Dict[str, List[torch.Tensor]],
           placements: Dict[str, Spec], grid: Grid, device=None
           ) -> Dict[str, torch.Tensor]:
    """The logical leaves joined from their shards, on ``device``
    (default worker 0's)."""
    dev = grid.devices[0] if device is None else device
    out = {}
    for name, parts in shards.items():
        spec = placements[name]
        full = [n * grid.extent(spec_axes(e)) for n, e in
                zip(parts[0].shape, tuple(spec) + (None,) * parts[0].dim())]
        leaf = torch.empty(full, dtype=parts[0].dtype, device=dev)
        for w in owners(spec, grid):
            leaf[tuple(shard_slices(full, spec, grid, w))] = \
                parts[w].detach()
        out[name] = leaf
    return out
