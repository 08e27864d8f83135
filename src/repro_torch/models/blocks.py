"""Per-block parameter init and apply functions for the decoder.

The counterpart of ``repro.models.blocks`` for the ATTN and SLIDING
kinds (attention + dense MLP), MOE (attention + a capacity-routed
mixture of experts), RGLRU (Griffin's recurrent mixer + dense MLP) and
xLSTM's MLSTM and SLSTM (a recurrent mixer alone).
Parameters are plain dicts of tensors
(``nn.ParameterDict`` inside the model); padded slots (heads, d_ff,
experts) carry zero weights so the padded model equals the unpadded one.

Attention goes through the kernel wrappers, which run the hand-written
CUDA kernel for tensors on the card and the plain version on the CPU:
``attention_seq`` -> flash prefill, ``attention_chunk`` -> chunk prefill
with its in-place scatter, ``attention_decode`` -> paged decode over the
pool in place (no gather).  The query/key/value/output projections are
plain ``torch.matmul``; so is the single-device engine's MLP
(``apply_mlp``), while an engine with workers runs the padded FFN kernel
(``apply_padded_mlp``).  The MoE routing, dispatch, expert products
(``torch.bmm`` over the capacity buffer) and combine are plain PyTorch,
as the reference's are plain ``jnp``.

An encoder-decoder's encoder layers are ATTN blocks whose attention is
bidirectional (``attention_seq(..., causal=False)``: the flash kernel's
non-causal branch), and each decoder layer group ends in a
cross-attention sub-layer over the encoder's output (``cross_kv``,
``cross_attention``: plain PyTorch, as the reference's is plain
``jnp``).

A recurrent block's mixer is the reference's ``apply_block_seq`` /
``apply_block_decode`` branch of its kind: RGLRU's (``rglru_mix``,
``repro/models/blocks.py:443-459``, ``:551-563``: input projection
``w_in`` to ``[x | y]``, the causal conv and the two gates on x, the
RG-LRU scan, ``y`` gated by gelu, ``w_out``), MLSTM's (``mlstm_mix``,
``:461-477``, ``:566-580``: ``q/k/v`` and the gates from the normed
input, the chunkwise mLSTM or its step, the output gate, ``w_out``) and
SLSTM's (``slstm_mix``, ``:479-485``, ``:582-587``: ``zifo``, the sLSTM
scan, ``w_out``).  Its per-slot state is a ``paged.recurrent.RecState``
updated in place.  It is plain PyTorch, as the reference's is plain
``jnp``: no TPU kernel computes it.  The xLSTM kinds have no MLP: a
block is ``ln``, the mixer and its residual.

Training (``apply_block_train``) runs a block over a whole sequence
with no cache, through autograd: ``attention_train`` (the plain
``layers.chunked_attention``, as the reference's ``attention_seq``;
the kernels have no backward), ``rec_train`` (the recurrent mixers'
functional forms, which give the serving forms' bits in fp32 on the
CPU) and ``apply_moe_mlp_train`` (the MoE MLP with the reference's
load-balance loss, ``moe_aux``).

Sequence-parallel layouts (``attention_decode_sp``, ``attention_chunk_sp``:
the counterparts of the reference's ``attention_decode`` /
``attention_chunk`` with ``sp > 1``) run over every worker of a layer's
assembly at once: each sp shard walks its own pages with the partial
entry of the decode or chunk kernel, the shards of each sp group
exchange their partial states (``InstanceMesh.sp_all_gather``), and one
combine launch a worker merges them before ``wo``.
"""
from __future__ import annotations

import math
import operator
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (ATTN, MLSTM, MOE, RGLRU, SLIDING,
                                      SLSTM, ModelConfig)
from repro_torch.core.instance import shard_of
from repro_torch.core.padding import PaddingPlan
from repro_torch.kernels import chunk_prefill as CP
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import padded_ffn as PF
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref as KR
from repro_torch.launch.mesh import Layout
from repro_torch.models import layers as Lyr
from repro_torch.models import shardhints
from repro_torch.paged import pool as pp
from repro_torch.paged.recurrent import CONV_K, RecState, make_state_of

Params = Dict[str, torch.Tensor]

#: the block kinds whose mixer is attention over a paged KV cache
ATTENTION_KINDS = (ATTN, SLIDING, MOE)
#: the block kinds whose mixer keeps a per-slot recurrent state
RECURRENT_KINDS = (RGLRU, MLSTM, SLSTM)
#: the block kinds with no MLP: ``ln``, the mixer and its residual
MIXER_ONLY_KINDS = (MLSTM, SLSTM)
#: the block kinds the port runs (every kind the registry names)
PORTED_KINDS = ATTENTION_KINDS + RECURRENT_KINDS
#: block kinds of other architectures the port does not run yet, and the
#: ROADMAP item that ports them (none since the xLSTM kinds)
NOT_PORTED: Dict[str, str] = {}


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported: "
            f"{NOT_PORTED.get(kind, 'unknown kind')}")


def has_mlp(kind: str) -> bool:
    """Whether a block of ``kind`` has an MLP (and ``ln1`` / ``ln2``)."""
    return kind not in MIXER_ONLY_KINDS


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
    """x: (B,S,d) -> q: (B,S,Hq,dh); k,v replicated to kv_slots.  A
    worker's TP shard holds a slice of the q heads and the kv heads its
    kv slots copy (``core.instance.kv_heads_of``), so the copies a head
    gets here are the shard's own count: its slots (q heads over the
    plan's q heads per slot) over its kv heads."""
    B, S, d = x.shape
    dh = cfg.resolved_head_dim
    # heads by -1: a worker's TP shard holds a slice of them
    q = (x @ p["wq"]).reshape(B, S, -1, dh)
    k = (x @ p["wk"]).reshape(B, S, -1, dh)
    v = (x @ p["wv"]).reshape(B, S, -1, dh)
    q = Lyr.apply_rope(q, positions, cfg.rope_theta)
    k = Lyr.apply_rope(k, positions, cfg.rope_theta)
    if plan.kv_replication > 1:
        slots = q.shape[2] * plan.kv_slots // plan.q_heads_padded
        rep = slots // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return q, k, v.contiguous()


def attention_seq(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  plan: PaddingPlan, positions: torch.Tensor,
                  window: int = 0, causal: bool = True
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Whole-prompt self-attention (positions 0..S-1) through the flash
    prefill kernel: causal for a decoder, bidirectional (``causal=False``)
    for an encoder.  Returns (out, (k, v)) with k, v: (B, S, kv_slots,
    dh) for the cache fill."""
    B, S, d = x.shape
    q, k, v = _project_qkv(p, x, cfg, plan, positions)
    attn = FA.flash_attention(q, k, v, causal=causal, window=window)
    out = attn.reshape(B, S, -1) @ p["wo"]
    return out, (k, v)


def attention_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    plan: PaddingPlan, positions: torch.Tensor,
                    window: int = 0, causal: bool = True,
                    banded: bool = False) -> torch.Tensor:
    """Whole-sequence self-attention for training: the plain
    ``layers.chunked_attention``, as the reference's ``attention_seq``
    runs it, so autograd reaches ``wq``, ``wk`` and ``wv`` (the flash
    kernel has no backward); ``banded`` takes ``layers.
    banded_attention`` where the reference does (a window, S a multiple
    of 512 and longer than the window).  Returns the sub-layer's output
    (B, S, d)."""
    B, S, d = x.shape
    q, k, v = _project_qkv(p, x, cfg, plan, positions)
    if banded and causal and window > 0 and S % 512 == 0 and S > window:
        attn = Lyr.banded_attention(q, k, v, positions, positions, window)
    else:
        attn = Lyr.chunked_attention(q, k, v, positions, positions,
                                     causal=causal, window=window)
    return attn.reshape(B, S, -1) @ p["wo"]


def attention_chunk(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    plan: PaddingPlan, positions: torch.Tensor,
                    cache: pp.PagedState, window: int = 0,
                    first_chunk: bool = False,
                    shard: Tuple[int, int] = (0, 1)
                    ) -> Tuple[torch.Tensor, pp.PagedState]:
    """Chunk-continuation prefill: the chunk's queries (x: (B,S,d),
    positions: (B,S) global) attend over the cached prefix and then the
    chunk, and the chunk's K/V are written into the cache — both by the
    chunk-prefill kernel, which updates the pool in place.
    ``first_chunk=True`` skips the (known-empty) prefix walk; on an sp
    shard (``shard``) it is the whole attention of a first chunk, and
    only the tokens whose page the shard holds are written.  A
    token-first pool runs the kernel on its canonical copy, scattered
    into and written back in the storage order (``paged.pool.
    kernel_pool``); a header-centric one in place, with no copy."""
    B, S, d = x.shape
    q, k, v = _project_qkv(p, x, cfg, plan, positions)
    pool_c = pp.kernel_pool(cache)
    attn = CP.chunk_prefill_attention(
        q, k, v, pool_c, cache.page_table, cache.positions, positions,
        window=window, attend_prefix=not first_chunk, shard=shard)
    pp.commit_kernel_pool(cache, pool_c)
    cache = pp.adopt_chunk_pool(cache, positions, shard)
    out = attn.reshape(B, S, -1) @ p["wo"]
    return out, cache


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     plan: PaddingPlan, positions: torch.Tensor,
                     cache: pp.PagedState, window: int = 0
                     ) -> Tuple[torch.Tensor, pp.PagedState]:
    """One-token decode. x: (B,1,d); positions: (B,1) global positions.
    The token's K/V are appended at each row's cursor, then the
    paged-decode kernel walks the pool in place, masked by the stored
    positions (a token-first pool: its canonical copy, which the kernel
    only reads)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, plan, positions)
    cache = pp.append_token(cache, k[:, 0], v[:, 0])
    attn = PA.paged_decode(q[:, 0].contiguous(), pp.kernel_pool(cache),
                           cache.page_table, cache.positions,
                           positions[:, 0].contiguous(), window=window)
    out = attn.reshape(B, 1, -1) @ p["wo"]
    return out, cache


def _combine_sp(bufs: List[Optional[torch.Tensor]], geo: Dict,
                ps: List[Params], xs: List[torch.Tensor], mesh,
                layout: Layout) -> List[Optional[torch.Tensor]]:
    """Exchange the shards' partial states inside each sp group, then
    each worker's combine launch and ``wo``: the attention sub-layer's
    partial output (before the TP all-reduce), one a worker."""
    mesh.sp_all_gather(bufs, layout)
    outs: List[Optional[torch.Tensor]] = []
    for w, buf in enumerate(bufs):
        if buf is None:
            outs.append(None)
            continue
        g = geo[w]
        attn = PA.softmax_combine(buf, g["rows"], g["kvs"], g["splits"],
                                  g["rep"], g["dh"], xs[w].dtype)
        B, S = xs[w].shape[:2]
        outs.append(attn.reshape(B, S, -1) @ ps[w]["wo"])
    return outs


def attention_decode_sp(ps: List[Params], xs: List[Optional[torch.Tensor]],
                        cfg: ModelConfig, plan: PaddingPlan,
                        positions: List[torch.Tensor],
                        caches: List[Optional[pp.PagedState]], lay: Layout,
                        mesh, window: int = 0
                        ) -> List[Optional[torch.Tensor]]:
    """One-token decode of every worker of ``mesh`` at the sp layout
    ``lay`` (lists: one entry a worker; a worker whose cache is None
    holds none of the rows).  Each worker projects q/k/v for its heads
    over its replica's rows; the shard holding a row's position appends
    its K/V; every shard runs the decode kernel's split launch over its
    own pages into row s of a buffer of ``sp`` partial states; the sp
    group's exchange fills the other rows, and one combine launch merges
    them (``_combine_sp``)."""
    bufs: List[Optional[torch.Tensor]] = [None] * len(caches)
    geo: Dict[int, Dict] = {}
    for w, cache in enumerate(caches):
        if cache is None:
            continue
        s, sp = shard_of(lay, w)
        q, k, v = _project_qkv(ps[w], xs[w], cfg, plan, positions[w])
        pp.append_token(cache, k[:, 0], v[:, 0], shard=(s, sp))
        B, _, Hq, dh = q.shape
        kvs, n = cache.pool.shape[1], cache.page_table.shape[1]
        g = {"rows": B, "kvs": kvs, "rep": Hq // kvs, "dh": dh,
             "splits": PA.partial_splits(B, kvs, n, q.device)}
        buf = torch.empty((sp, KR.partials_numel(**g)),
                          dtype=torch.float32, device=q.device)
        PA.paged_decode_partials(q[:, 0].contiguous(), cache.pool,
                                 cache.page_table, cache.positions,
                                 positions[w][:, 0].contiguous(), buf[s],
                                 window=window, shard=(s, sp))
        bufs[w], geo[w] = buf, g
    return _combine_sp(bufs, geo, ps, xs, mesh, lay)


def attention_chunk_sp(ps: List[Params], xs: List[Optional[torch.Tensor]],
                       cfg: ModelConfig, plan: PaddingPlan,
                       positions: List[torch.Tensor],
                       caches: List[Optional[pp.PagedState]], lay: Layout,
                       mesh, window: int = 0, first_chunk: bool = False
                       ) -> List[Optional[torch.Tensor]]:
    """A prefill chunk of every worker of ``mesh`` at the sp layout
    ``lay`` (lists as ``attention_decode_sp``'s).  A first chunk has
    no prefix: every shard computes the chunk's whole attention for its
    heads and writes only its own pages (``attention_chunk`` on a
    shard).  A later chunk: each shard runs the chunk kernel's partial
    entry over its own prefix pages, shard 0 also over the chunk's own
    keys, and scatters the tokens whose pages it holds; the partial
    states are exchanged and combined as in decode."""
    if first_chunk:
        return [None if c is None else attention_chunk(
            ps[w], xs[w], cfg, plan, positions[w], c, window=window,
            first_chunk=True, shard=shard_of(lay, w))[0]
            for w, c in enumerate(caches)]
    bufs: List[Optional[torch.Tensor]] = [None] * len(caches)
    geo: Dict[int, Dict] = {}
    for w, cache in enumerate(caches):
        if cache is None:
            continue
        s, sp = shard_of(lay, w)
        q, k, v = _project_qkv(ps[w], xs[w], cfg, plan, positions[w])
        B, S, Hq, dh = q.shape
        kvs = cache.pool.shape[1]
        g = {"rows": B * S, "kvs": kvs, "rep": Hq // kvs, "dh": dh,
             "splits": 1}
        buf = torch.empty((sp, KR.partials_numel(**g)),
                          dtype=torch.float32, device=q.device)
        CP.chunk_prefill_partials(
            q, k, v, cache.pool, cache.page_table, cache.positions,
            positions[w], buf[s], window=window, attend_self=s == 0,
            shard=(s, sp))
        pp.adopt_chunk_pool(cache, positions[w], (s, sp))
        bufs[w], geo[w] = buf, g
    return _combine_sp(bufs, geo, ps, xs, mesh, lay)


# ===========================================================================
# Cross-attention sub-layer (an encoder-decoder's decoder)
# ===========================================================================
#
# The reference's ``cross_attention`` and ``encode_cross_kv``
# (``repro/models/model.py:188-214``): the decoder's queries attend over
# the encoder's output, bidirectionally, with no rope on either side
# (query and key positions all 0).  The reference computes it in plain
# ``jnp`` and no TPU kernel takes it; the flash kernel needs as many keys
# as queries.  So it is the plain ``layers.chunked_attention`` here.


def init_cross(gen: torch.Generator, cfg: ModelConfig, plan: PaddingPlan,
               device) -> Params:
    """One decoder layer group's cross-attention: ``ln_x`` and the
    attention weights {wq, wk, wv, wo} (the reference's
    ``init_attention`` beside ``ln_x``)."""
    return {"ln_x": torch.zeros((cfg.d_model,), dtype=dtype_of(cfg),
                                device=device),
            **init_attention(gen, cfg, plan, device)}


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig,
             plan: PaddingPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The memory keys and values of one group: enc_out (B, F, d) ->
    (B, F, kv_slots, dh) each, replicated kv heads repeated as the
    reference's ``encode_cross_kv`` repeats them."""
    dh = cfg.resolved_head_dim
    B, F = enc_out.shape[:2]
    # heads by -1: a worker's TP shard holds the kv heads its slots copy
    k = (enc_out @ p["wk"]).reshape(B, F, -1, dh)
    v = (enc_out @ p["wv"]).reshape(B, F, -1, dh)
    if plan.kv_replication > 1:
        slots = (p["wq"].shape[1] // dh * plan.kv_slots
                 // plan.q_heads_padded)
        k = torch.repeat_interleave(k, slots // k.shape[2], dim=2)
        v = torch.repeat_interleave(v, slots // v.shape[2], dim=2)
    return k, v


def cross_attention(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    plan: PaddingPlan, mem_k: torch.Tensor,
                    mem_v: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); mem_k, mem_v: (B, F, kv_slots, dh).  Returns the
    sub-layer's output (B, S, d), before the residual; on a worker's TP
    shard of the weights and its own kv slots of the memory, the
    partial output (before the group's all-reduce)."""
    B, S, d = x.shape
    h = Lyr.rmsnorm(x, p["ln_x"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, -1, cfg.resolved_head_dim)
    qpos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((B, mem_k.shape[1]), dtype=torch.int32,
                       device=x.device)
    attn = Lyr.chunked_attention(q, mem_k, mem_v, qpos, kpos, causal=False)
    return attn.reshape(B, S, -1) @ p["wo"]


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


def apply_padded_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig, tp: int,
                     ff: int) -> torch.Tensor:
    """The MLP of an engine with workers: the padded FFN kernel over
    weights in the per-shard Eq. 2 layout (``tp`` shards of ``ff/tp``
    real columns each).  x: (..., d)."""
    shape = x.shape
    out = PF.padded_ffn(x.reshape(-1, shape[-1]), p["wi"], p["wo"], tp=tp,
                        ff=ff, activation=cfg.activation)
    return out.reshape(shape)


# ===========================================================================
# MoE MLP sub-layer (capacity-based top-k routing, expert axis padded)
# ===========================================================================
#
# The reference's ``apply_moe_mlp`` (``repro/models/blocks.py:256-332``)
# with ``nb = 1``, the only block count a serving path uses.  Routing
# (``moe_route``) and buffer positions (``moe_positions``) are split out
# so that an engine whose workers each hold a part of one call's rows
# can route over the call's rows in their global order (the capacity
# and the positions depend on every row routed together) and then run
# the experts for its own rows only (``moe_experts``): a token's expert
# output depends only on its own input and on whether its choice was
# kept.  The reference's Switch-style load-balance loss is training-only
# (``apply_moe_mlp_train``, ``moe_aux``); no serving caller computes it.


def init_moe_mlp(gen: torch.Generator, cfg: ModelConfig, plan: PaddingPlan,
                 device) -> Params:
    """``router (d, Ep)``, ``wi (Ep, d, 2*ffp)``, ``wo (Ep, ffp, d)``
    (padded experts and d_ff columns zero) and, for a shared expert,
    its dense MLP as ``shared_wi`` / ``shared_wo`` (the reference's
    ``shared/wi``, ``shared/wo``)."""
    d, ff, ffp = cfg.d_model, cfg.d_ff, plan.d_ff_padded
    E, Ep = plan.num_experts, plan.experts_padded
    dt = dtype_of(cfg)
    gated = cfg.activation in ("swiglu", "geglu")
    col_mask = (torch.arange(ffp, device=device) < ff).to(dt)
    emask = (torch.arange(Ep, device=device) < E).to(dt)[:, None, None]
    cm = torch.cat([col_mask, col_mask]) if gated else col_mask
    wi = _dense(gen, d, (Ep, d, cm.shape[0]), dt, device) * emask * cm
    wo = (_dense(gen, ff, (Ep, ffp, d), dt, device) * emask
          * col_mask[None, :, None])
    out = {"router": _dense(gen, d, (d, Ep), dt, device), "wi": wi, "wo": wo}
    if cfg.moe.shared_expert:
        sh = init_mlp(gen, cfg, plan, device)
        out["shared_wi"], out["shared_wo"] = sh["wi"], sh["wo"]
    return out


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots each expert's buffer has for a call routing ``tokens``
    tokens together (the reference's ``cap``, real experts only)."""
    moe = cfg.moe
    return max(1, int(tokens * moe.top_k * moe.capacity_factor
                      / moe.num_experts))


def moe_gates(router: torch.Tensor, x: torch.Tensor, plan: PaddingPlan
              ) -> torch.Tensor:
    """The router's gates: x (T, d) -> (T, Ep) fp32 softmax of the
    router logits, padded experts at -inf (gate 0)."""
    logits = (x @ router).float()
    real = torch.arange(logits.shape[-1], device=x.device) < plan.num_experts
    logits = torch.where(real, logits, float("-inf"))
    return torch.softmax(logits, dim=-1)


def moe_route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
              plan: PaddingPlan, gates: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's ``top_k`` experts: x (T, d) -> (topv (T, k) fp32
    weights renormalised to sum 1, topi (T, k) int64 experts, in
    descending gate order), from ``moe_gates`` (or the given
    ``gates``)."""
    if gates is None:
        gates = moe_gates(router, x, plan)
    topv, topi = torch.topk(gates, cfg.moe.top_k, dim=-1)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return topv, topi


def moe_positions(topi: torch.Tensor, experts: int, cap: int, nb: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each choice's position in its expert's buffer, counted in
    flattened ``(token, k)`` order (the reference's cumsum), and whether
    it falls inside the capacity ``cap``: (pos (T, k) int64, keep (T, k)
    bool).  With ``nb`` blocks of tokens (the reference's block-local
    cumsum), each block counts its own positions against its own
    capacity, and pos is the block times ``cap`` plus the position in
    the block, so an expert's buffer holds ``nb * cap`` rows, block
    after block.  The one-hot is laid out ``(Ep, nb, T*k/nb)`` so the
    count is a scan along the inner axis, one row an expert."""
    T, k = topi.shape
    blk = topi.reshape(nb, (T // nb) * k)
    hit = torch.arange(experts, device=topi.device)[:, None, None] == blk
    pos = torch.cumsum(hit, dim=2).gather(0, blk[None])[0] - 1
    slot = pos + torch.arange(nb, device=topi.device)[:, None] * cap
    return slot.reshape(T, k), (pos < cap).reshape(T, k)


def moe_experts(p: Params, x: torch.Tensor, topv: torch.Tensor,
                topi: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
                cap: int, activation: str) -> torch.Tensor:
    """The routed experts' output for x (T, d) under a routing decision:
    every kept choice's token is written at (expert, pos) of a
    ``(Ep, cap, d)`` buffer, the gated expert products run as two
    ``torch.bmm`` over it, and each token sums its kept choices' outputs
    weighted by ``topv``.  A dropped choice writes nothing and adds
    nothing.  (The reference writes a dropped choice's zero row at
    position ``cap - 1``, over whatever kept choice sits there: ROADMAP
    queue 3.)  ``wi`` / ``wo`` may be a TP shard of the expert columns
    (``[gate | up]`` halves of the shard's columns): the output is then
    that shard's partial sum."""
    T, d = x.shape
    Ep = p["wi"].shape[0]
    tok = torch.arange(T, device=x.device)[:, None].expand_as(topi)
    # dropped choices land in a sink row past the capacity, which the
    # products never read (no host sync to select the kept ones)
    buf = x.new_zeros((Ep, cap + 1, d))
    buf[topi, torch.where(keep, pos, cap)] = x[tok]
    h = torch.bmm(buf[:, :cap], p["wi"])
    if activation in ("swiglu", "geglu"):
        g, u = h.chunk(2, dim=-1)
        h = Lyr._act(activation, g) * u
    else:
        h = Lyr._act(activation, h)
    yb = torch.bmm(h, p["wo"])                            # (Ep, cap, d)
    w = torch.where(keep, topv, 0.0).to(x.dtype)
    return (yb[topi, torch.where(keep, pos, 0)] * w[..., None]).sum(dim=1)


def _moe_call(p: Params, x: torch.Tensor, cfg: ModelConfig,
              plan: PaddingPlan, gates: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_moe_mlp`` under the call's ``gates`` (None: computed
    here), and each token's choices (topi (T, k))."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    topv, topi = moe_route(p["router"], xt, cfg, plan, gates)
    cap = moe_capacity(xt.shape[0], cfg)
    pos, keep = moe_positions(topi, p["wi"].shape[0], cap)
    y = moe_experts(p, xt, topv, topi, pos, keep, cap, cfg.activation)
    y = y.reshape(shape)
    if "shared_wi" in p:
        y = y + Lyr.dense_mlp(x, p["shared_wi"], p["shared_wo"],
                              cfg.activation)
    return y, topi


def apply_moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  plan: PaddingPlan) -> torch.Tensor:
    """The MoE MLP of one call: x (B, S, d), every row routed together
    (T = B * S tokens), plus the shared expert's dense MLP when the
    config has one."""
    return _moe_call(p, x, cfg, plan, None)[0]


def moe_aux(gates: torch.Tensor, first: torch.Tensor, plan: PaddingPlan
            ) -> torch.Tensor:
    """The reference's Switch-style load-balance loss of one call
    (``repro/models/blocks.py:320-325``): the share of tokens whose
    first choice (``first`` (T,)) is each expert times that expert's
    mean gate (gates: (T, Ep) fp32), summed, times E."""
    E = plan.num_experts
    frac_tokens = F.one_hot(first, gates.shape[-1]).float().mean(dim=0)
    frac_probs = gates.mean(dim=0)
    return (frac_tokens * frac_probs).sum() * (E ** 2) / max(E, 1)


def moe_blocks(tokens: int) -> int:
    """The blocks a training call routes its ``tokens`` in: the
    ``moe_blocks`` shard hint (1, global routing, when unset) halved
    until it divides the tokens, as the reference's ``nb``
    (``repro/models/blocks.py:272-275``)."""
    nb = shardhints.get("moe_blocks") or 1
    while tokens % nb:
        nb //= 2
    return max(nb, 1)


def apply_moe_mlp_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                        plan: PaddingPlan
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_moe_mlp`` and the call's load-balance loss (training):
    (y (B, S, d), aux scalar).  Under a ``moe_blocks`` hint the tokens
    route in blocks (``moe_blocks``), each with the capacity of its own
    tokens; without one, all together."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    gates = moe_gates(p["router"], xt, plan)
    topv, topi = moe_route(p["router"], xt, cfg, plan, gates)
    nb = moe_blocks(xt.shape[0])
    cap = moe_capacity(xt.shape[0] // nb, cfg)
    slot, keep = moe_positions(topi, p["wi"].shape[0], cap, nb)
    y = moe_experts(p, xt, topv, topi, slot, keep, nb * cap,
                    cfg.activation).reshape(shape)
    if "shared_wi" in p:
        y = y + Lyr.dense_mlp(x, p["shared_wi"], p["shared_wo"],
                              cfg.activation)
    return y, moe_aux(gates, topi[:, 0], plan)


# ===========================================================================
# Recurrent mixer (RG-LRU block: Griffin)
# ===========================================================================

def init_rglru(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """The reference's RGLRU mixer leaves (``repro/models/blocks.py:
    348-358``): ``w_in (d, 2d)`` = ``[x | y]``, ``conv_w (K, d)``,
    ``conv_b (d,)``, the gates ``w_gx`` / ``w_ga (d, d)``, ``a_param
    (d,)`` (fp32 in every model dtype: ``linspace(0.5, 2.0, d)``) and
    ``w_out (d, d)``."""
    d, dt = cfg.d_model, dtype_of(cfg)
    return {"w_in": _dense(gen, d, (d, 2 * d), dt, device),
            "conv_w": _dense(gen, CONV_K, (CONV_K, d), dt, device),
            "conv_b": torch.zeros((d,), dtype=dt, device=device),
            "w_gx": _dense(gen, d, (d, d), dt, device),
            "w_ga": _dense(gen, d, (d, d), dt, device),
            "a_param": torch.linspace(0.5, 2.0, d, dtype=torch.float32,
                                      device=device),
            "w_out": _dense(gen, d, (d, d), dt, device)}


def rglru_mix(p: Params, u: torch.Tensor, state: RecState, mode: str,
              part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The recurrent mixer after its input projection: ``u = h @ w_in``
    (B, S, 2d), the x and y branches side by side.  ``mode``: ``seq``
    (a whole prompt from a zero state), ``chunk`` (continuing from
    ``state``'s carry) or ``decode`` (S = 1, one RG-LRU step); the
    final state is written into ``state`` in place.  ``part = (p, t)``:
    the caller holds row shard p of t of ``w_out`` (a TP-t worker), and
    the result is that shard's partial product; every worker of a TP
    group runs the conv, gates and scan on the whole ``u``."""
    d = u.shape[-1] // 2
    xb, yb = u[..., :d], u[..., d:]
    carry = mode != "seq"
    xb, conv = Lyr.causal_conv1d(xb, p["conv_w"], p["conv_b"],
                                 state.conv if carry else None)
    gx = xb @ p["w_gx"]
    ga = xb @ p["w_ga"]
    if mode == "decode":
        y, h = Lyr.rglru_step(xb[:, 0], gx[:, 0], ga[:, 0], p["a_param"],
                              state.h)
        y = y[:, None]
    else:
        y, h = Lyr.rglru(xb, gx, ga, p["a_param"],
                         h0=state.h if carry else None, block=state.block)
    state.conv.copy_(conv)
    state.h.copy_(h)
    y = y * Lyr._act("geglu", yb)           # jax.nn.gelu: the tanh form
    w, t = part
    if t > 1:
        y = y[..., w * d // t:(w + 1) * d // t]
    return y @ p["w_out"]


# ===========================================================================
# Recurrent mixers without an MLP (xLSTM's mLSTM and sLSTM blocks)
# ===========================================================================

def init_mlstm(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """The reference's MLSTM mixer leaves (``repro/models/blocks.py:
    360-371``), ``up = 2 * d``: ``wq`` / ``wk`` / ``wv`` / ``w_og (d,
    up)``, the input and forget gates ``w_if (d, 2H)``, ``w_out (up,
    d)``."""
    d, dt, H = cfg.d_model, dtype_of(cfg), cfg.num_heads
    up = 2 * d
    return {"wq": _dense(gen, d, (d, up), dt, device),
            "wk": _dense(gen, d, (d, up), dt, device),
            "wv": _dense(gen, d, (d, up), dt, device),
            "w_if": _dense(gen, d, (d, 2 * H), dt, device),
            "w_og": _dense(gen, d, (d, up), dt, device),
            "w_out": _dense(gen, up, (up, d), dt, device)}


def init_slstm(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """The reference's SLSTM mixer leaves (``:372-377``): ``w_zifo (d,
    4d)``, the diagonal recurrent weights ``r_diag (4, d)`` (zero) and
    ``w_out (d, d)``."""
    d, dt = cfg.d_model, dtype_of(cfg)
    return {"w_zifo": _dense(gen, d, (d, 4 * d), dt, device),
            "r_diag": torch.zeros((4, d), dtype=dt, device=device),
            "w_out": _dense(gen, d, (d, d), dt, device)}


def mlstm_mix(p: Params, u: torch.Tensor, h: torch.Tensor, state: RecState,
              mode: str, part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The mLSTM mixer after its input products: ``u`` (B, S, 3, up) is
    ``[q; k; v]`` (``rec_project``), ``h`` (B, S, d) the normed input,
    from which the gates ``h @ w_if`` (replicated) and the output gate
    ``sigmoid(h @ w_og)`` are taken.  ``mode`` as ``rglru_mix``'s: the
    chunkwise form in blocks of ``state.block`` tokens from a fresh
    state (``seq``) or the carry (``chunk``), or one step (``decode``,
    updating ``C`` and ``n`` in place); the final state lands in
    ``state``.  ``part = (p, t)``: the caller holds column shard p of t
    of ``w_og`` and row shard p of ``w_out``, and the result is that
    shard's partial product."""
    B, S, _, up = u.shape
    H = p["w_if"].shape[1] // 2
    q, k, v = (u[..., j, :].reshape(B, S, H, up // H) for j in range(3))
    gif = h @ p["w_if"]
    ig, fg = gif[..., :H], gif[..., H:]
    leaves = (state.C, state.n, state.m)
    if mode == "decode":
        y, _ = Lyr.mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0],
                              leaves, out=leaves)
        y = y[:, None]
    else:
        y, new = Lyr.mlstm_chunkwise(
            q, k, v, ig, fg, state=None if mode == "seq" else leaves,
            block=state.block)
        for dst, src in zip(leaves, new):
            dst.copy_(src)
    w, t = part
    y = y.reshape(B, S, up)[..., w * up // t:(w + 1) * up // t]
    return (y * torch.sigmoid(h @ p["w_og"])) @ p["w_out"]


def slstm_mix(p: Params, u: torch.Tensor, state: RecState, mode: str,
              part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The sLSTM mixer after its input product ``u = h @ w_zifo`` (B, S,
    4d): the sLSTM scan from a fresh state (``seq``) or the carry, token
    by token (a decode is a one-token scan), the final state into
    ``state``; then row shard p of t of ``w_out`` (``part``)."""
    B, S, d4 = u.shape
    d = d4 // 4
    leaves = tuple(state.leaves[k] for k in "cnmh")
    y, new = Lyr.slstm_seq(u.reshape(B, S, 4, d), p["r_diag"],
                           state=None if mode == "seq" else leaves)
    for dst, src in zip(leaves, new):
        dst.copy_(src)
    w, t = part
    return y[..., w * d // t:(w + 1) * d // t] @ p["w_out"]


def rec_project(kind: str, p: Params, h: torch.Tensor) -> torch.Tensor:
    """A recurrent mixer's input product(s) over its column-sharded
    weights, their columns on the last axis (a TP group all-gathers it):
    RGLRU ``h @ w_in`` (B, S, 2d), MLSTM ``[h @ wq; h @ wk; h @ wv]``
    (B, S, 3, up), SLSTM ``h @ w_zifo`` (B, S, 4d)."""
    if kind == RGLRU:
        return h @ p["w_in"]
    if kind == MLSTM:
        return torch.stack([h @ p["wq"], h @ p["wk"], h @ p["wv"]], dim=-2)
    return h @ p["w_zifo"]


def rec_mix(kind: str, p: Params, u: torch.Tensor, h: torch.Tensor,
            state: RecState, mode: str, part: Tuple[int, int] = (0, 1)
            ) -> torch.Tensor:
    """A recurrent mixer of ``kind`` on its gathered input products ``u``
    (``rec_project``) and normed input ``h``: its (partial) output."""
    if kind == RGLRU:
        return rglru_mix(p, u, state, mode, part)
    if kind == MLSTM:
        return mlstm_mix(p, u, h, state, mode, part)
    return slstm_mix(p, u, state, mode, part)


def rec_train(kind: str, p: Params, h: torch.Tensor, block: int
              ) -> torch.Tensor:
    """A recurrent mixer of ``kind`` over a whole sequence from a fresh
    state, for training: the operations of ``rec_mix``'s ``seq`` mode
    (scans in blocks of ``block`` tokens) with no state cache and no
    write in place, so autograd runs through it; in fp32 on the CPU it
    gives the serving form's bits.  h: the normed input (B, S, d)."""
    u = rec_project(kind, p, h)
    if kind == RGLRU:
        d = u.shape[-1] // 2
        xb, _ = Lyr.causal_conv1d(u[..., :d], p["conv_w"], p["conv_b"])
        y, _ = Lyr.rglru(xb, xb @ p["w_gx"], xb @ p["w_ga"], p["a_param"],
                         block=block)
        return (y * Lyr._act("geglu", u[..., d:])) @ p["w_out"]
    B, S = h.shape[:2]
    if kind == MLSTM:
        up = u.shape[-1]
        H = p["w_if"].shape[1] // 2
        q, k, v = (u[..., j, :].reshape(B, S, H, up // H) for j in range(3))
        gif = h @ p["w_if"]
        y = Lyr.mlstm_chunkwise_train(q, k, v, gif[..., :H], gif[..., H:],
                                      block=block)
        return (y.reshape(B, S, up) * torch.sigmoid(h @ p["w_og"])) \
            @ p["w_out"]
    y = Lyr.slstm_seq_train(u.reshape(B, S, 4, -1), p["r_diag"])
    return y @ p["w_out"]


# ===========================================================================
# Block apply
# ===========================================================================

def _window_of(kind: str, cfg: ModelConfig) -> int:
    """Effective attention window for a block: SLIDING blocks always use
    cfg.window; ATTN and MOE blocks become windowed under the
    long-context variant (cfg.attention == "sliding")."""
    if kind == SLIDING:
        return cfg.window
    if kind in (ATTN, MOE) and cfg.attention == "sliding":
        return cfg.window
    return 0


def _mlp(kind: str, p, x: torch.Tensor, cfg: ModelConfig,
         plan: PaddingPlan) -> torch.Tensor:
    """The block's MLP sub-layer: dense, or the MoE MLP."""
    if kind == MOE:
        return apply_moe_mlp(p, x, cfg, plan)
    return apply_mlp(p, x, cfg)


def _mixer(kind: str, p, h: torch.Tensor, cfg: ModelConfig,
           plan: PaddingPlan, positions: torch.Tensor, cache, mode: str,
           first_chunk: bool = False):
    """The block's mixer sub-layer on the normed input ``h``: attention
    over the paged cache, or the recurrent mixer over its state (both
    updated in place).  Returns (out, (k, v) of a whole prompt's
    attention or None)."""
    if kind in RECURRENT_KINDS:
        p = p["rec"]
        return rec_mix(kind, p, rec_project(kind, p, h), h, cache,
                       mode), None
    window = _window_of(kind, cfg)
    if mode == "seq":
        return attention_seq(p["attn"], h, cfg, plan, positions,
                             window=window)
    if mode == "chunk":
        return attention_chunk(p["attn"], h, cfg, plan, positions, cache,
                               window=window, first_chunk=first_chunk)[0], \
            None
    return attention_decode(p["attn"], h, cfg, plan, positions, cache,
                            window=window)[0], None


def _apply_block(kind: str, p, cfg: ModelConfig, plan: PaddingPlan,
                 x: torch.Tensor, positions: torch.Tensor, cache, mode: str,
                 first_chunk: bool = False):
    check_kind(kind)
    if not has_mlp(kind):
        h = Lyr.rmsnorm(x, p["ln"], cfg.norm_eps)
        return x + _mixer(kind, p, h, cfg, plan, positions, cache, mode)[0], \
            None
    h = Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps)
    out, kv = _mixer(kind, p, h, cfg, plan, positions, cache, mode,
                     first_chunk)
    x = x + out
    h = Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(kind, p["mlp"], h, cfg, plan), kv


def train_block(kind: str, x, norm, mixer, mlp, add=operator.add):
    """The residual skeleton of one block in training: ``norm(x, name)``
    the RMS norm under weight ``name`` (``ln``, ``ln1``, ``ln2``),
    ``mixer(h)`` the attention or recurrence, ``mlp(h)`` -> (y, the MoE
    load-balance loss or None), ``add`` the residual sum.
    ``apply_block_train`` runs it on one device's tensors and
    ``training.sharded.ShardedStep`` on one tensor a worker.  Returns
    (y, aux)."""
    if not has_mlp(kind):
        return add(x, mixer(norm(x, "ln"))), None
    x = add(x, mixer(norm(x, "ln1")))
    y, aux = mlp(norm(x, "ln2"))
    return add(x, y), aux


def apply_block_train(kind: str, p, cfg: ModelConfig, plan: PaddingPlan,
                      x: torch.Tensor, positions: torch.Tensor, block: int,
                      banded: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Whole-sequence forward for one block in training (the
    reference's ``apply_block_seq`` as ``forward_train`` calls it):
    attention through ``attention_train`` (``banded`` as there), a
    recurrent mixer through ``rec_train`` (scans in blocks of ``block``
    tokens), no cache.  Returns (y, the MoE load-balance loss or
    None)."""
    check_kind(kind)

    def mixer(h):
        if kind in RECURRENT_KINDS:
            return rec_train(kind, p["rec"], h, block)
        return attention_train(p["attn"], h, cfg, plan, positions,
                               window=_window_of(kind, cfg), banded=banded)

    def mlp(h):
        if kind == MOE:
            return apply_moe_mlp_train(p["mlp"], h, cfg, plan)
        return apply_mlp(p["mlp"], h, cfg), None
    return train_block(kind, x, lambda h, n: Lyr.rmsnorm(h, p[n],
                                                         cfg.norm_eps),
                       mixer, mlp)


def apply_block_seq(kind: str, p, cfg: ModelConfig, plan: PaddingPlan,
                    x: torch.Tensor, positions: torch.Tensor, cache=None):
    """Whole-prompt forward for one block; returns (y, (k, v)) for an
    attention block (the caller fills its cache) and (y, None) for a
    recurrent one, whose final state lands in ``cache``."""
    return _apply_block(kind, p, cfg, plan, x, positions, cache, "seq")


def apply_block_chunk(kind: str, p, cfg: ModelConfig, plan: PaddingPlan,
                      x: torch.Tensor, positions: torch.Tensor, cache,
                      first_chunk: bool = False):
    """Prefill-chunk forward for one block, continuing from its cache
    (a recurrent block: from the state's carry, as the reference's
    ``apply_block_chunk`` delegates to the sequence form)."""
    y, _ = _apply_block(kind, p, cfg, plan, x, positions, cache, "chunk",
                        first_chunk)
    return y, cache


def apply_block_decode(kind: str, p, cfg: ModelConfig, plan: PaddingPlan,
                       x: torch.Tensor, positions: torch.Tensor, cache):
    """Single-token decode for one block. x: (B,1,d)."""
    y, _ = _apply_block(kind, p, cfg, plan, x, positions, cache, "decode")
    return y, cache


def slot_pages(kind: str, cfg: ModelConfig, max_seq: int,
               page_tokens: int) -> int:
    """Pages a slot of an attention block's cache holds: ``max_seq``
    tokens for full attention, a window's ring ``min(max_seq, window)``,
    page-rounded."""
    w = _window_of(kind, cfg)
    cap = max_seq if w == 0 else min(max_seq, w)
    return -(-cap // page_tokens)


def init_block_cache(kind: str, cfg: ModelConfig, plan: PaddingPlan,
                     batch: int, max_seq: int, page_tokens: int, *,
                     device, layout: str = "header_centric"):
    """The block's slot-partitioned paged cache, stored in ``layout``
    (default header-centric, the kernels' canonical order): full
    attention holds ``max_seq`` tokens per slot, a window holds
    ``min(max_seq, window)`` (a ring), page-rounded.  A recurrent
    block's is its fresh state (``RecState``), scanned in blocks of the
    page size."""
    check_kind(kind)
    if kind in RECURRENT_KINDS:
        return make_state_of(kind, cfg, batch, page_tokens, device=device)
    mps = slot_pages(kind, cfg, max_seq, page_tokens)
    return pp.make_state(batch * mps, plan.kv_slots, page_tokens,
                         cfg.resolved_head_dim, batch, mps, dtype_of(cfg),
                         layout, device=device)
