"""Paged decode attention: the CUDA kernel ``csrc/paged_attention.cu``
(replacing the TPU kernel ``repro/kernels/paged_attention.py``) and its
plain version ``ref.paged_decode_ref``.

``paged_decode`` is the engine's entry: one query token per row over
the rows' pages of the header-centric pool, masked by stored positions.
``paged_attention`` keeps the TPU kernel's signature (mask by
``seq_lens``) and runs the same kernel on positions built from
``seq_lens``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ops, ref

#: kernel launches since the last reset (the card only; one per call,
#: counting the split and combine launches of a call as one)
launches = 0
plain = ref.paged_decode_ref

HEAD_DIMS = (64, 128)
MAX_REP = 8
MAX_SMEM = 227 * 1024


def paged_decode(q: torch.Tensor, pool: torch.Tensor,
                 page_table: torch.Tensor, kv_positions: torch.Tensor,
                 q_positions: torch.Tensor, window: int = 0
                 ) -> torch.Tensor:
    """q: (B, Hq, dh); pool: (NP, kvs, 2, P, dh) canonical;
    page_table: (B, n) int32; kv_positions: (B, n*P) int32;
    q_positions: (B,) int32.  Returns (B, Hq, dh)."""
    if not ops.on_card(q, pool, page_table, kv_positions, q_positions):
        return plain(q, pool, page_table, kv_positions, q_positions,
                     window=window)
    global launches
    B, Hq, dh = q.shape
    NP, kvs, two, P, dh2 = pool.shape
    n = page_table.shape[1]
    rep = Hq // kvs
    ops.require(two == 2 and dh2 == dh and Hq % kvs == 0,
                f"shapes q {tuple(q.shape)} / pool {tuple(pool.shape)}")
    # a block stages one page's K (fp32, padded rows) and V, the (rep, P)
    # scores, the rep queries and the page's positions
    smem = (4 * (P * (dh + 1) + rep * P + rep * dh)
            + P * dh * q.element_size() + 4 * P)
    ops.require(dh in HEAD_DIMS and 1 <= rep <= MAX_REP
                and smem <= MAX_SMEM,
                f"paged decode takes dh in {HEAD_DIMS}, rep <= {MAX_REP} "
                f"and pages of at most {MAX_SMEM} bytes of shared memory")
    ops.require(page_table.shape[0] == B
                and tuple(kv_positions.shape) == (B, n * P)
                and tuple(q_positions.shape) == (B,),
                "page_table / positions shapes")
    ops.check_cuda_inputs(q.dtype, (q, pool),
                          (page_table, kv_positions, q_positions))
    # split each row's pages so that about two blocks per SM are in
    # flight; the combine launch merges the splits' partial states
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = max(1, min(n, -(-2 * sms // (B * kvs))))
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((B, kvs, splits, rep), **f32)
    part_l = torch.empty((B, kvs, splits, rep), **f32)
    part_acc = torch.empty((B, kvs, splits, rep, dh), **f32)
    out = torch.empty_like(q)
    lib = _build.library("paged_attention")
    err = lib.repro_paged_decode(
        ops.ptr(q), ops.ptr(pool), ops.ptr(page_table),
        ops.ptr(kv_positions), ops.ptr(q_positions), ops.ptr(part_m),
        ops.ptr(part_l), ops.ptr(part_acc), ops.ptr(out),
        B, kvs, rep, dh, P, n, splits, int(window), ops.dtype_code(q),
        ops.stream(q.device))
    _build.check(err, "paged decode launch")
    launches += 1
    return out


def paged_attention(q: torch.Tensor, pool: torch.Tensor,
                    page_table: torch.Tensor, seq_lens: torch.Tensor
                    ) -> torch.Tensor:
    """The TPU kernel's signature: keys of row b are its first
    ``seq_lens[b]`` tokens.  Positions are built from ``seq_lens`` (slot
    j holds position j when j < seq_len) and the query sits at
    ``seq_len - 1``, so masking by position equals masking by length."""
    if not ops.on_card(q, pool, page_table, seq_lens):
        return ref.paged_attention_ref(q, pool, page_table, seq_lens)
    B = q.shape[0]
    n, P = page_table.shape[1], pool.shape[3]
    idx = torch.arange(n * P, dtype=torch.int32, device=q.device)
    sl = seq_lens.to(torch.int32)
    kv_positions = torch.where(idx[None, :] < sl[:, None], idx[None, :],
                               -1).to(torch.int32).contiguous()
    return paged_decode(q, pool, page_table, kv_positions,
                        (sl - 1).contiguous(), window=0)
