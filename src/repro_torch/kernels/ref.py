"""Plain PyTorch versions of the port's CUDA kernels.

Each computes the same function as its kernel, on any device.  The
kernel wrappers run them for CPU tensors; ``chip_smoke.py`` holds each
kernel against its plain version on the card.  They are built on the
layer math in ``repro_torch.models.layers`` (online softmax over key
chunks or pages) so none of them forms a full score matrix for long
keys.

Rows whose keys are all masked: the plain versions follow the
reference's finite ``NEG_INF`` arithmetic (every masked key gets weight
1, so the row is the mean of the masked values); the kernels skip
masked key tiles and return 0 there.  No caller reads such a row: the
engine's decode masks idle slots that way, and its outputs are dropped.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as Lyr
from repro_torch.paged import pool as pp


def paged_attention_ref(q: torch.Tensor, pool: torch.Tensor,
                        page_table: torch.Tensor, seq_lens: torch.Tensor
                        ) -> torch.Tensor:
    """Decode attention over a header-centric pool with the TPU kernel's
    signature (mask by ``seq_lens``, no ring).  Dense mirror of
    ``repro.kernels.ref.paged_attention_ref``.

    q: (B, Hq, dh); pool: (NP, kvs, 2, P, dh); page_table: (B, n) int32;
    seq_lens: (B,) int32.  Returns (B, Hq, dh)."""
    B, Hq, dh = q.shape
    NP, kvs, _, P, _ = pool.shape
    rep = Hq // kvs
    scale = 1.0 / math.sqrt(dh)
    pages = pool[page_table.long()]               # (B, n, kvs, 2, P, dh)
    n = pages.shape[1]
    k = pages[:, :, :, 0].transpose(1, 2).reshape(B, kvs, n * P, dh)
    v = pages[:, :, :, 1].transpose(1, 2).reshape(B, kvs, n * P, dh)
    qg = q.reshape(B, kvs, rep, dh).float() * scale
    s = qg @ k.float().transpose(-1, -2)          # (B, kvs, rep, n*P)
    pos = torch.arange(n * P, device=q.device)[None, None, None, :]
    s = torch.where(pos < seq_lens[:, None, None, None], s, Lyr.NEG_INF)
    o = torch.softmax(s, dim=-1) @ v.float()
    return o.reshape(B, Hq, dh).to(q.dtype)


def paged_decode_ref(q: torch.Tensor, pool: torch.Tensor,
                     page_table: torch.Tensor, kv_positions: torch.Tensor,
                     q_positions: torch.Tensor, window: int = 0
                     ) -> torch.Tensor:
    """Decode attention masked by stored positions, as the engine decodes.
    q: (B, Hq, dh); pool: (NP, kvs, 2, P, dh) canonical; page_table:
    (B, n); kv_positions: (B, n*P); q_positions: (B,)."""
    pages = pool[page_table.long()]               # (B, n, kvs, 2, P, dh)
    return Lyr.paged_decode_attention(q, pages, kv_positions, q_positions,
                                      window=window)


def chunk_prefill_ref(q, k_new, v_new, pool, page_table, kv_positions,
                      q_positions, *, window: int = 0,
                      attend_prefix: bool = True) -> torch.Tensor:
    """A chunk's attention over its paged prefix and then itself, then
    the chunk's K/V written into ``pool`` IN PLACE at the bytes
    ``pool.write_chunk`` writes.  Returns the attention (B, S, Hq, dh).

    The prefix is gathered BEFORE the scatter, so on a ring cache the
    keys the chunk evicts are still attended.

    q: (B, S, Hq, dh); k_new/v_new: (B, S, kvs, dh); pool: (NP, kvs, 2,
    P, dh) canonical; page_table: (B, n); kv_positions: (B, cap);
    q_positions: (B, S), -1 for a padding token (no key, not written)."""
    B, S = q_positions.shape
    state = pp.PagedState(pool, page_table,
                          torch.zeros((B,), dtype=torch.int32,
                                      device=q.device), kv_positions)
    kk, vv, kpos, valid = k_new, v_new, q_positions, q_positions >= 0
    if attend_prefix:
        pk, pv, ppos, pvalid = pp.gather_kv(state)
        kk = torch.cat([pk, kk], dim=1)
        vv = torch.cat([pv, vv], dim=1)
        kpos = torch.cat([ppos, kpos], dim=1)
        valid = torch.cat([pvalid, valid], dim=1)
    out = Lyr.chunked_attention(q, kk, vv, q_positions, kpos,
                                kv_valid=valid, causal=True, window=window)
    # the pool half of write_chunk (metadata stays the caller's)
    pp.scatter_chunk(state, k_new, v_new, q_positions)
    return out


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """Prefill attention over one contiguous sequence (positions 0..S-1).
    q: (B, S, Hq, dh); k, v: (B, S, Hkv, dh)."""
    B, S = q.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    pos = pos[None, :].expand(B, S)
    return Lyr.chunked_attention(q, k, v, pos, pos, causal=causal,
                                 window=window)
