"""Paged chunk-prefill attention with its in-place K/V scatter: the CUDA
kernel ``csrc/chunk_prefill.cu`` (replacing the TPU kernel
``repro/kernels/chunk_prefill.py``) and its plain version
``ref.chunk_prefill_ref``.

Both update ``pool`` IN PLACE (the TPU kernel returns an aliased new
pool) and return the chunk's attention; the pool's bytes equal
``paged.pool.write_chunk``'s exactly.  The caller applies the metadata
half (``pool.adopt_chunk_pool``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ops, ref

#: kernel launches since the last reset (the card only; one per call,
#: counting the attention and scatter launches of a call as one)
launches = 0
plain = ref.chunk_prefill_ref

HEAD_DIMS = (64, 128)
TILE_ROWS = 64   # query rows per block: rep must divide it


def chunk_prefill_attention(q, k_new, v_new, pool, page_table,
                            kv_positions, q_positions, *, window: int = 0,
                            attend_prefix: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, dh) chunk queries (RoPE applied);
    k_new, v_new: (B, S, kvs, dh) chunk K/V (replicated to kv_slots);
    pool: (NP, kvs, 2, P, dh) canonical header-centric pool, written;
    page_table: (B, n) int32; kv_positions: (B, n*P) int32 slot
    positions (-1 = empty); q_positions: (B, S) int32 chunk positions,
    where -1 marks a padding token: it is no key, its K/V is not
    written, and its output row is undefined.  ``attend_prefix=False``
    skips the pool walk (the first chunk of a prompt).  Returns the
    attention (B, S, Hq, dh)."""
    if not ops.on_card(q, k_new, v_new, pool, page_table, kv_positions,
                       q_positions):
        return plain(q, k_new, v_new, pool, page_table, kv_positions,
                     q_positions, window=window, attend_prefix=attend_prefix)
    global launches
    B, S, Hq, dh = q.shape
    NP, kvs, two, P, dh2 = pool.shape
    n = page_table.shape[1]
    rep = Hq // kvs
    ops.require(two == 2 and dh2 == dh and Hq % kvs == 0
                and tuple(k_new.shape) == (B, S, kvs, dh)
                and k_new.shape == v_new.shape,
                f"shapes q {tuple(q.shape)} / k_new {tuple(k_new.shape)} "
                f"/ pool {tuple(pool.shape)}")
    ops.require(dh in HEAD_DIMS and TILE_ROWS % rep == 0,
                f"chunk prefill takes dh in {HEAD_DIMS} and rep dividing "
                f"{TILE_ROWS}")
    ops.require(page_table.shape[0] == B
                and tuple(kv_positions.shape) == (B, n * P)
                and tuple(q_positions.shape) == (B, S),
                "page_table / positions shapes")
    # a chunk longer than the ring would scatter one slot twice
    ops.require(0 < S <= n * P, f"chunk of {S} tokens exceeds the slot "
                f"capacity {n * P}")
    ops.check_cuda_inputs(q.dtype, (q, k_new, v_new, pool),
                          (page_table, kv_positions, q_positions))
    out = torch.empty_like(q)
    lib = _build.library("chunk_prefill")
    code, st = ops.dtype_code(q), ops.stream(q.device)
    # stream order: every block has attended the prefix before any byte
    # of it is overwritten
    err = lib.repro_chunk_prefill_attention(
        ops.ptr(q), ops.ptr(k_new), ops.ptr(v_new), ops.ptr(pool),
        ops.ptr(page_table), ops.ptr(kv_positions), ops.ptr(q_positions),
        ops.ptr(out), B, S, kvs, rep, dh, P, n, int(attend_prefix),
        int(window), code, st)
    _build.check(err, "chunk prefill attention launch")
    err = lib.repro_chunk_scatter(
        ops.ptr(k_new), ops.ptr(v_new), ops.ptr(q_positions),
        ops.ptr(page_table), ops.ptr(pool), B, S, kvs, dh, P, n, code, st)
    _build.check(err, "chunk prefill scatter launch")
    launches += 1
    return out
