"""Paged chunk-prefill attention with its in-place K/V scatter: the CUDA
kernel ``csrc/chunk_prefill.cu`` (replacing the TPU kernel
``repro/kernels/chunk_prefill.py``) and its plain version
``ref.chunk_prefill_ref``.

bf16 runs on the tensor-core tile (``csrc/attn_wgmma.cuh``), fp32 on the
CUDA-core tile (``csrc/attn_tile.cuh``); the bf16 tolerance is
``flash_attention.BF16_ROW_TOL``.

Both update ``pool`` IN PLACE (the TPU kernel returns an aliased new
pool) and return the chunk's attention; the pool's bytes equal
``paged.pool.write_chunk``'s exactly.  The caller applies the metadata
half (``pool.adopt_chunk_pool``).

On a sequence-parallel shard (``shard=(s, sp)``: the pool holds pages
``[s*n, (s+1)*n)`` of rows of ``sp * n`` pages) the scatter writes only
the tokens whose page the shard holds, and ``chunk_prefill_partials``
leaves each query row's partial state (``ref.partials_numel(B * S, kvs,
1, rep, dh)`` floats) in a buffer the caller owns instead of the output,
for ``paged_attention.softmax_combine`` to merge across the shards;
``attend_self=False`` leaves the chunk's own keys to another shard.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_attention import BF16_ROW_TOL  # noqa: F401

#: kernel launches since the last reset (the card only; one per call,
#: counting the attention and scatter launches of a call as one), and
#: those of the partial entry
launches = 0
partial_launches = 0
plain = ref.chunk_prefill_ref

HEAD_DIMS = FA.HEAD_DIMS
MAX_REP = FA.MAX_REP
TILE_KEYS = 64   # keys of a bf16 tile


def supports(Hq: int, kvs: int, dh: int, dtype: torch.dtype,
             P: int = 64) -> bool:
    """Whether the CUDA kernel takes this head shape, dtype and page
    size: the flash kernel's head shapes (the two share their tiles); in
    bfloat16 a page of a size that divides ``TILE_KEYS`` or that it
    divides (a key tile is whole pages or part of one)."""
    return (FA.supports(Hq, kvs, dh, dtype)
            and (dtype != torch.bfloat16
                 or TILE_KEYS % P == 0 or P % TILE_KEYS == 0))



def chunk_prefill_attention(q, k_new, v_new, pool, page_table,
                            kv_positions, q_positions, *, window: int = 0,
                            attend_prefix: bool = True,
                            shard: Tuple[int, int] = (0, 1)
                            ) -> torch.Tensor:
    """q: (B, S, Hq, dh) chunk queries (RoPE applied);
    k_new, v_new: (B, S, kvs, dh) chunk K/V (replicated to kv_slots);
    pool: (NP, kvs, 2, P, dh) canonical header-centric pool, written;
    page_table: (B, n) int32; kv_positions: (B, n*P) int32 slot
    positions (-1 = empty); q_positions: (B, S) int32 chunk positions,
    where -1 marks a padding token: it is no key, its K/V is not
    written, and its output row is undefined.  ``attend_prefix=False``
    skips the pool walk (the first chunk of a prompt).  On an sp shard
    (``shard``) only the tokens whose page it holds are written.
    Returns the attention (B, S, Hq, dh)."""
    if not ops.on_card(q, k_new, v_new, pool, page_table, kv_positions,
                       q_positions):
        return plain(q, k_new, v_new, pool, page_table, kv_positions,
                     q_positions, window=window, attend_prefix=attend_prefix,
                     shard=shard)
    global launches
    out = torch.empty_like(q)
    _launch(q, k_new, v_new, pool, page_table, kv_positions, q_positions,
            out, None, window, attend_prefix, True, shard)
    launches += 1
    return out


def chunk_prefill_partials(q, k_new, v_new, pool, page_table, kv_positions,
                           q_positions, out: torch.Tensor, *,
                           window: int = 0, attend_prefix: bool = True,
                           attend_self: bool = True,
                           shard: Tuple[int, int] = (0, 1)) -> None:
    """One sp shard's chunk attention as the query rows' partial states,
    written into ``out`` (1-D fp32, ``ref.partials_numel(B * S, kvs, 1,
    rep, dh)`` floats): the queries over the shard's prefix pages and,
    with ``attend_self``, the chunk's own keys; then the chunk's K/V
    scattered into the pages the shard holds.  Other arguments as
    ``chunk_prefill_attention``'s."""
    B, S, Hq, dh = q.shape
    if not ops.on_card(q, k_new, v_new, pool, page_table, kv_positions,
                       q_positions, out):
        ref.pack_partials(*ref.chunk_prefill_partials_ref(
            q, k_new, v_new, pool, page_table, kv_positions, q_positions,
            window=window, attend_prefix=attend_prefix,
            attend_self=attend_self, shard=shard), out)
        return
    global partial_launches
    n = ref.partials_numel(B * S, pool.shape[1], 1, Hq // pool.shape[1], dh)
    ops.require(out.dtype == torch.float32 and out.is_contiguous()
                and out.numel() == n,
                f"chunk partials take {n} contiguous fp32 floats")
    _launch(q, k_new, v_new, pool, page_table, kv_positions, q_positions,
            None, out, window, attend_prefix, attend_self, shard)
    partial_launches += 1


def _launch(q, k_new, v_new, pool, page_table, kv_positions, q_positions,
            out: Optional[torch.Tensor], part: Optional[torch.Tensor],
            window: int, attend_prefix: bool, attend_self: bool,
            shard: Tuple[int, int]) -> None:
    """Check the inputs, then the attention launch (the output, or the
    partials) and the scatter launch, in stream order: every block has
    attended the prefix before any byte of it is overwritten."""
    B, S, Hq, dh = q.shape
    NP, kvs, two, P, dh2 = pool.shape
    n = page_table.shape[1]
    s, sp = shard
    ops.require(two == 2 and dh2 == dh and Hq % kvs == 0
                and tuple(k_new.shape) == (B, S, kvs, dh)
                and k_new.shape == v_new.shape,
                f"shapes q {tuple(q.shape)} / k_new {tuple(k_new.shape)} "
                f"/ pool {tuple(pool.shape)}")
    ops.require(supports(Hq, kvs, dh, q.dtype, P),
                f"chunk prefill takes dh in {HEAD_DIMS}, rep <= {MAX_REP} "
                f"in float32 or bfloat16 and, in bfloat16, pages of a "
                f"size that divides {TILE_KEYS} or that {TILE_KEYS} "
                f"divides; not Hq {Hq} / kv {kvs} / dh {dh} / P {P} in "
                f"{q.dtype}")
    ops.require(page_table.shape[0] == B
                and tuple(kv_positions.shape) == (B, n * P)
                and tuple(q_positions.shape) == (B, S),
                "page_table / positions shapes")
    # a chunk longer than the ring would scatter one slot twice
    ops.require(0 < S <= sp * n * P, f"chunk of {S} tokens exceeds the "
                f"slot capacity {sp * n * P}")
    ops.check_cuda_inputs(q.dtype, (q, k_new, v_new, pool),
                          (page_table, kv_positions, q_positions))
    if q.dtype == torch.bfloat16:
        ops.require_tma(q, k_new, v_new, pool)
    lib = _build.library("chunk_prefill")
    code, st = ops.dtype_code(q), ops.stream(q.device)
    err = lib.repro_chunk_prefill_attention(
        ops.ptr(q), ops.ptr(k_new), ops.ptr(v_new), ops.ptr(pool), NP,
        ops.ptr(page_table), ops.ptr(kv_positions), ops.ptr(q_positions),
        None if out is None else ops.ptr(out),
        None if part is None else ops.ptr(part), B, S, kvs, Hq // kvs, dh,
        P, n, int(attend_prefix), int(attend_self), int(window), code, st)
    _build.check(err, "chunk prefill attention launch")
    err = lib.repro_chunk_scatter(
        ops.ptr(k_new), ops.ptr(v_new), ops.ptr(q_positions),
        ops.ptr(page_table), ops.ptr(pool), B, S, kvs, dh, P, n, s * n,
        sp * n, code, st)
    _build.check(err, "chunk prefill scatter launch")
