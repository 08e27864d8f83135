"""Per-block parameter init and apply functions for the dense decoder.

The counterpart of ``repro.models.blocks`` for the ATTN and SLIDING
kinds (attention + dense MLP).  Parameters are plain dicts of tensors
(``nn.ParameterDict`` inside the model); padded slots (heads, d_ff)
carry zero weights so the padded model equals the unpadded one.

Attention goes through the kernel wrappers, which run the hand-written
CUDA kernel for tensors on the card and the plain version on the CPU:
``attention_seq`` -> flash prefill, ``attention_chunk`` -> chunk prefill
with its in-place scatter, ``attention_decode`` -> paged decode over the
pool in place (no gather).  The query/key/value/output projections and
the MLP are plain ``torch.matmul``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (ATTN, MLSTM, MOE, RGLRU, SLIDING,
                                      SLSTM, ModelConfig)
from repro_torch.core.padding import PaddingPlan
from repro_torch.kernels import chunk_prefill as CP
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as Lyr
from repro_torch.paged import pool as pp

Params = Dict[str, torch.Tensor]

#: block kinds of other architectures, and the ROADMAP item that ports them
NOT_PORTED = {
    MOE: "ROADMAP queue 1 item 10 (MoE)",
    RGLRU: "ROADMAP queue 1 item 10 (RG-LRU)",
    MLSTM: "ROADMAP queue 1 item 10 (xLSTM)",
    SLSTM: "ROADMAP queue 1 item 10 (xLSTM)",
}


def check_kind(kind: str) -> None:
    if kind not in (ATTN, SLIDING):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: "
            f"{NOT_PORTED.get(kind, 'unknown kind')}")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense(gen: torch.Generator, fan_in: int, shape, dtype, device
           ) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w / math.sqrt(fan_in)).to(dtype)


def _head_mask(mask, dh: int, dtype, device) -> torch.Tensor:
    """(n_slots * dh,) column mask zeroing padded head slots."""
    m = torch.tensor(mask, dtype=dtype, device=device)
    return m.repeat_interleave(dh)


# ===========================================================================
# Attention sub-layer
# ===========================================================================

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   plan: PaddingPlan, device) -> Params:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = plan.q_heads_padded, plan.kv_padded
    dt = dtype_of(cfg)
    qmask = _head_mask(plan.q_head_mask(), dh, dt, device)
    kvmask = _head_mask(plan.kv_head_mask(), dh, dt, device)
    wq = _dense(gen, d, (d, Hq * dh), dt, device) * qmask[None, :]
    wk = _dense(gen, d, (d, Hkv * dh), dt, device) * kvmask[None, :]
    wv = _dense(gen, d, (d, Hkv * dh), dt, device) * kvmask[None, :]
    # zero rows of wo for padded q slots -> padded heads cannot contribute
    wo = _dense(gen, Hq * dh, (Hq * dh, d), dt, device) * qmask[:, None]
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 plan: PaddingPlan, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> q: (B,S,Hq,dh); k,v replicated to kv_slots."""
    B, S, d = x.shape
    dh = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, plan.q_heads_padded, dh)
    k = (x @ p["wk"]).reshape(B, S, plan.kv_padded, dh)
    v = (x @ p["wv"]).reshape(B, S, plan.kv_padded, dh)
    q = Lyr.apply_rope(q, positions, cfg.rope_theta)
    k = Lyr.apply_rope(k, positions, cfg.rope_theta)
    if plan.kv_replication > 1:
        k = torch.repeat_interleave(k, plan.kv_replication, dim=2)
        v = torch.repeat_interleave(v, plan.kv_replication, dim=2)
    return q, k, v.contiguous()


def attention_seq(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  plan: PaddingPlan, positions: torch.Tensor,
                  window: int = 0
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Whole-prompt self-attention (positions 0..S-1) through the flash
    prefill kernel.  Returns (out, (k, v)) with k, v: (B, S, kv_slots,
    dh) for the cache fill."""
    B, S, d = x.shape
    q, k, v = _project_qkv(p, x, cfg, plan, positions)
    attn = FA.flash_attention(q, k, v, causal=True, window=window)
    out = attn.reshape(B, S, -1) @ p["wo"]
    return out, (k, v)


def attention_chunk(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    plan: PaddingPlan, positions: torch.Tensor,
                    cache: pp.PagedState, window: int = 0,
                    first_chunk: bool = False
                    ) -> Tuple[torch.Tensor, pp.PagedState]:
    """Chunk-continuation prefill: the chunk's queries (x: (B,S,d),
    positions: (B,S) global) attend over the cached prefix and then the
    chunk, and the chunk's K/V are written into the cache — both by the
    chunk-prefill kernel, which updates the pool in place.
    ``first_chunk=True`` skips the (known-empty) prefix walk."""
    B, S, d = x.shape
    q, k, v = _project_qkv(p, x, cfg, plan, positions)
    attn = CP.chunk_prefill_attention(
        q, k, v, cache.pool, cache.page_table, cache.positions, positions,
        window=window, attend_prefix=not first_chunk)
    cache = pp.adopt_chunk_pool(cache, positions)
    out = attn.reshape(B, S, -1) @ p["wo"]
    return out, cache


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     plan: PaddingPlan, positions: torch.Tensor,
                     cache: pp.PagedState, window: int = 0
                     ) -> Tuple[torch.Tensor, pp.PagedState]:
    """One-token decode. x: (B,1,d); positions: (B,1) global positions.
    The token's K/V are appended at each row's cursor, then the
    paged-decode kernel walks the pool in place, masked by the stored
    positions."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, plan, positions)
    cache = pp.append_token(cache, k[:, 0], v[:, 0])
    attn = PA.paged_decode(q[:, 0].contiguous(), cache.pool,
                           cache.page_table, cache.positions,
                           positions[:, 0].contiguous(), window=window)
    out = attn.reshape(B, 1, -1) @ p["wo"]
    return out, cache


# ===========================================================================
# Dense MLP sub-layer
# ===========================================================================

def init_mlp(gen: torch.Generator, cfg: ModelConfig, plan: PaddingPlan,
             device) -> Params:
    d, ff, ffp = cfg.d_model, cfg.d_ff, plan.d_ff_padded
    dt = dtype_of(cfg)
    gated = cfg.activation in ("swiglu", "geglu")
    col_mask = (torch.arange(ffp, device=device) < ff).to(dt)
    wi = _dense(gen, d, (d, 2 * ffp if gated else ffp), dt, device)
    wi = wi * (torch.cat([col_mask, col_mask]) if gated else col_mask)
    wo = _dense(gen, ff, (ffp, d), dt, device) * col_mask[:, None]
    return {"wi": wi, "wo": wo}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return Lyr.dense_mlp(x, p["wi"], p["wo"], cfg.activation)


# ===========================================================================
# Block apply
# ===========================================================================

def _window_of(kind: str, cfg: ModelConfig) -> int:
    """Effective attention window for a block: SLIDING blocks always use
    cfg.window; ATTN blocks become windowed under the long-context
    variant (cfg.attention == "sliding")."""
    if kind == SLIDING:
        return cfg.window
    if kind == ATTN and cfg.attention == "sliding":
        return cfg.window
    return 0


def apply_block_seq(kind: str, p, cfg: ModelConfig, plan: PaddingPlan,
                    x: torch.Tensor, positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Whole-prompt forward for one block; returns (y, (k, v))."""
    check_kind(kind)
    h = Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps)
    attn_out, kv = attention_seq(p["attn"], h, cfg, plan, positions,
                                 window=_window_of(kind, cfg))
    x = x + attn_out
    h = Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg), kv


def apply_block_chunk(kind: str, p, cfg: ModelConfig, plan: PaddingPlan,
                      x: torch.Tensor, positions: torch.Tensor,
                      cache: pp.PagedState, first_chunk: bool = False):
    """Prefill-chunk forward for one block, continuing from its cache."""
    check_kind(kind)
    h = Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps)
    attn_out, cache = attention_chunk(
        p["attn"], h, cfg, plan, positions, cache,
        window=_window_of(kind, cfg), first_chunk=first_chunk)
    x = x + attn_out
    h = Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg), cache


def apply_block_decode(kind: str, p, cfg: ModelConfig, plan: PaddingPlan,
                       x: torch.Tensor, positions: torch.Tensor,
                       cache: pp.PagedState):
    """Single-token decode for one block. x: (B,1,d)."""
    check_kind(kind)
    h = Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps)
    attn_out, cache = attention_decode(
        p["attn"], h, cfg, plan, positions, cache,
        window=_window_of(kind, cfg))
    x = x + attn_out
    h = Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg), cache


def init_block_cache(kind: str, cfg: ModelConfig, plan: PaddingPlan,
                     batch: int, max_seq: int, page_tokens: int,
                     device="cpu") -> pp.PagedState:
    """The block's slot-partitioned header-centric paged cache (the
    kernels' canonical layout): full attention holds
    ``max_seq`` tokens per slot, a window holds ``min(max_seq, window)``
    (a ring), page-rounded."""
    check_kind(kind)
    w = _window_of(kind, cfg)
    cap = max_seq if w == 0 else min(max_seq, w)
    cap = -(-cap // page_tokens) * page_tokens
    mps = cap // page_tokens
    return pp.make_state(batch * mps, plan.kv_slots, page_tokens,
                         cfg.resolved_head_dim, batch, mps, dtype_of(cfg),
                         device=device)
