"""Model-weight transformation (paper §4.2).

The counterpart of ``repro.core.weight_transform``: the Eq. 2 padded
splitting and the per-layer accounting.  The reference's PartitionSpec
helpers have no counterpart: the port's sharding rules are explicit
functions in ``core.instance``.

Layout of the fused MLP.  The reference splits ``wi (d, 2*ffp)`` over its
last axis and lets GSPMD insert the collectives that make a SwiGLU shard
out of it.  The port keeps each worker's shard as ``[gate_w | up_w]``,
the layout the padded FFN kernel reads: a replica at TP1 holds
``[gate | up]`` where each of gate and up is ``tp`` shards of ``ff/tp``
real columns followed by a zero tail (``pad_columns_for_tp``), and the
reference's weights, whose zero padding sits at the global tail, are
re-laid by ``relayout_mlp_for_tp``.  Padding is zero, so the function is
the same.  The bytes a weight step moves are still those of
``account_scale_up`` / ``account_scale_down``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_transform import LinkModel
from repro_torch.core.padding import DTYPE_BYTES, PAGE_BYTES, PaddingPlan
from repro_torch.models import layers as Lyr

# ---------------------------------------------------------------------------
# Padded splitting (Eq. 2)
# ---------------------------------------------------------------------------


def pad_columns_for_tp(w: torch.Tensor, ff: int, ffp: int, tp: int
                       ) -> torch.Tensor:
    """(..., d, ff) -> (..., d, ffp): the real columns in ``tp`` shards,
    each padded at its end with zeros (U' = [U1, 0, U2, 0, ...]); leading
    axes (an expert axis) are carried along."""
    lead = w.shape[:-1]
    assert ff % tp == 0, (ff, tp)
    shard, shard_p = ff // tp, ffp // tp
    w = w.reshape(*lead, tp, shard)
    return torch.nn.functional.pad(w, (0, shard_p - shard)).reshape(
        *lead, ffp)


def pad_rows_for_tp(w: torch.Tensor, ff: int, ffp: int, tp: int
                    ) -> torch.Tensor:
    """(..., ff, d) -> (..., ffp, d): D' = [D1; 0; D2; 0; ...] row
    padding."""
    lead, d = w.shape[:-2], w.shape[-1]
    shard, shard_p = ff // tp, ffp // tp
    w = w.reshape(*lead, tp, shard, d)
    return torch.nn.functional.pad(w, (0, 0, 0, shard_p - shard)).reshape(
        *lead, ffp, d)


def relayout_mlp_for_tp(wi: torch.Tensor, wo: torch.Tensor, ff: int,
                        tp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused gated MLP weights with their zero padding at the global tail
    (the reference's init: ``wi = [gate, 0 | up, 0]``, ``wo = [D; 0]``)
    -> the per-shard Eq. 2 layout the port keeps.  The same layout when
    there is no padding (``ffp == ff``) or one shard.  Works on the last
    two axes: ``wi (..., d, 2*ffp)``, ``wo (..., ffp, d)``, so MoE expert
    tensors (``(Ep, d, 2*ffp)``, ``(Ep, ffp, d)``) re-lay every expert."""
    ffp = wi.shape[-1] // 2
    if ffp == ff or tp == 1:
        return wi, wo
    gate, up = wi[..., :ff], wi[..., ffp:ffp + ff]
    wi_p = torch.cat([pad_columns_for_tp(gate, ff, ffp, tp),
                      pad_columns_for_tp(up, ff, ffp, tp)], dim=-1)
    return wi_p, pad_rows_for_tp(wo[..., :ff, :], ff, ffp, tp)


#: a layer's sharded MLP weight pairs (``wi``, ``wo``): the dense MLP or
#: the MoE experts, and a MoE layer's shared expert
MLP_PAIRS = (("wi", "wo"), ("shared_wi", "shared_wo"))


def relayout_block_mlp(mlp, ff: int, tp: int, activation: str) -> None:
    """Re-lay, in place, every weight pair of one layer's gated ``mlp``
    (a dict or ``nn.ParameterDict`` of the reference's layout) for ``tp``
    Eq. 2 shards (``relayout_mlp_for_tp``); a router stays as it is.
    A layer without an MLP (``mlp`` None) has nothing to re-lay, nor has
    an ungated ``activation`` (a gelu MLP, which no worker shards)."""
    if mlp is None or activation not in ("swiglu", "geglu"):
        return
    for a, b in MLP_PAIRS:
        if a in mlp:
            mlp[a].data, mlp[b].data = relayout_mlp_for_tp(
                mlp[a].data, mlp[b].data, ff, tp)


def ffn_reference(x, u, d_w, activation: str = "swiglu"):
    """Unpadded FFN(x) = f(x @ U) @ D (paper Eq. 1; a gated activation
    splits u into [gate | up])."""
    if activation in ("swiglu", "geglu"):
        g, up = torch.chunk(x @ u, 2, dim=-1)
        h = Lyr._act(activation, g) * up
    else:
        h = Lyr._act(activation, x @ u)
    return h @ d_w


# ---------------------------------------------------------------------------
# Accounting (Fig. 10)
# ---------------------------------------------------------------------------

PAGE_OP_OVERHEAD = 2e-6  # s per page map/unmap metadata op (a model)


@dataclass
class WeightTransformStats:
    bytes_copied: int = 0      # local copies (swap path)
    bytes_transferred: int = 0  # interconnect bytes (scale-down gather)
    page_ops: int = 0

    def time_s(self, link: LinkModel, overlap: bool = False) -> float:
        if overlap:
            return (self.bytes_copied / link.bandwidth
                    + self.bytes_transferred / link.bandwidth
                    * (1 - link.overlap_fraction)
                    + self.page_ops * PAGE_OP_OVERHEAD * 0.1)
        return (self.bytes_copied / link.bandwidth
                + self.bytes_transferred / link.bandwidth
                + self.page_ops * PAGE_OP_OVERHEAD)


def mlp_layer_bytes(cfg: ModelConfig, plan: PaddingPlan,
                    padded: bool = True) -> int:
    ff = plan.d_ff_padded if padded else cfg.d_ff
    n = 3 if cfg.activation in ("swiglu", "geglu") else 2
    per = n * cfg.d_model * ff * DTYPE_BYTES
    if cfg.moe is not None:
        e = plan.experts_padded if padded else cfg.moe.num_experts
        per = per * e + cfg.d_model * e * DTYPE_BYTES
    return per


def account_scale_up(cfg: ModelConfig, plan: PaddingPlan, tp: int,
                     method: str) -> WeightTransformStats:
    """Per-layer MLP transformation cost, TP1 -> TPtp."""
    layer_bytes = mlp_layer_bytes(cfg, plan, padded=(method == "padded"))
    shard_bytes = layer_bytes // tp
    pages = max(1, (layer_bytes - shard_bytes) // PAGE_BYTES)
    if method == "padded" and plan.page_aligned:
        # zero copy: unmap the released pages, keep the local shard
        return WeightTransformStats(page_ops=pages)
    # partial swap: the kept shard is copied to a fresh allocation first
    return WeightTransformStats(bytes_copied=shard_bytes, page_ops=pages)


def account_scale_down(cfg: ModelConfig, plan: PaddingPlan, tp: int,
                       method: str) -> WeightTransformStats:
    layer_bytes = mlp_layer_bytes(cfg, plan, padded=(method == "padded"))
    shard_bytes = layer_bytes // tp
    gathered = layer_bytes - shard_bytes      # (tp-1)/tp from peers
    pages = max(1, gathered // PAGE_BYTES)
    if method == "padded" and plan.page_aligned:
        return WeightTransformStats(bytes_transferred=gathered,
                                    page_ops=pages)
    return WeightTransformStats(bytes_copied=shard_bytes,
                                bytes_transferred=gathered, page_ops=pages)


def account_regroup(cfg: ModelConfig, plan: PaddingPlan, tp_from: int,
                    tp_to: int, method: str) -> WeightTransformStats:
    """Per-layer MLP cost of a partial ``tp_from -> tp_to`` inside each
    TP group: a worker's S/a-shard tensor becomes an S/b-shard one.  On
    a scale-up it keeps 1/b of the layer and releases the rest of its
    1/a; on a scale-down it gathers the 1/b - 1/a it lacks from its
    peers.  From TP1 or to TP1 this is ``account_scale_up`` /
    ``account_scale_down``."""
    if tp_from == 1 or tp_to == 1:
        if tp_to > tp_from:
            return account_scale_up(cfg, plan, tp_to, method)
        return account_scale_down(cfg, plan, tp_from, method)
    layer_bytes = mlp_layer_bytes(cfg, plan, padded=(method == "padded"))
    held, kept = layer_bytes // tp_from, layer_bytes // tp_to
    swap = not (method == "padded" and plan.page_aligned)
    if tp_to > tp_from:
        pages = max(1, (held - kept) // PAGE_BYTES)
        return WeightTransformStats(bytes_copied=kept if swap else 0,
                                    page_ops=pages)
    gathered = kept - held
    return WeightTransformStats(bytes_copied=held if swap else 0,
                                bytes_transferred=gathered,
                                page_ops=max(1, gathered // PAGE_BYTES))
