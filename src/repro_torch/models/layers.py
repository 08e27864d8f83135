"""Core layer math of the dense decoder, in PyTorch.

The counterpart of ``repro.models.layers`` for the ATTN / SLIDING block
kinds at sequence-parallel degree 1.  Attention here is the plain
online-softmax version (chunked over keys, never forming a full score
matrix for long keys); on the card the CUDA kernels in
``repro_torch.kernels`` compute the same functions.

Numerical contract kept from the reference: ``NEG_INF`` is the FINITE
-1e30 and normalisers are floored at 1e-20, so a row whose keys are all
masked gives a finite output instead of NaN; RoPE splits each head in
halves (not interleaved); ``rmsnorm`` scales by ``1 + scale``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / RoPE / MLP
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (..., S, hd/2)
    angles = angles[..., None, :]                             # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "swiglu":   # silu-gated
        return F.silu(x)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def dense_mlp(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
              activation: str) -> torch.Tensor:
    """Gated MLP. wi: (d, 2*ff_padded) fused [gate|up] for gated acts, or
    (d, ff_padded) for plain gelu. wo: (ff_padded, d).  Two plain matrix
    products (``torch.matmul``), as the reference leaves them to XLA."""
    if activation in ("swiglu", "geglu"):
        gate, up = torch.chunk(x @ wi, 2, dim=-1)
        h = _act(activation, gate) * up
    else:
        h = _act(activation, x @ wi)
    return h @ wo


# ---------------------------------------------------------------------------
# Attention (online softmax over key chunks, GQA, causal / sliding window)
# ---------------------------------------------------------------------------

def _online_update(m, l, acc, s, v):
    """One online-softmax step. s: (..., Sq, K) masked scores, v: the
    matching values (..., K, dh); m, l: (..., Sq); acc: (..., Sq, dh)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + p @ v
    return m_new, l, acc


def chunked_attention(
    q: torch.Tensor,               # (B, Sq, Hq, dh)
    k: torch.Tensor,               # (B, Sk, Hkv, dh)
    v: torch.Tensor,               # (B, Sk, Hkv, dh)
    q_positions: torch.Tensor,     # (B, Sq) global positions of queries
    kv_positions: torch.Tensor,    # (B, Sk) global positions of keys
    kv_valid: Optional[torch.Tensor] = None,  # (B, Sk) bool validity
    causal: bool = True,
    window: int = 0,               # 0 -> unlimited; >0 -> sliding window
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over key chunks; never forms (Sq, Sk).
    The plain version of the flash and chunk-prefill kernels."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(dh)
    # (B, G, rep, Sq, dh) queries; (B, G, Sk, dh) keys and values
    qg = (q.reshape(B, Sq, Hkv, rep, dh).float() * scale).permute(0, 2, 3, 1, 4)
    kg = k.float().permute(0, 2, 1, 3)
    vg = v.float().permute(0, 2, 1, 3)
    valid = (kv_valid if kv_valid is not None
             else torch.ones((B, Sk), dtype=torch.bool, device=q.device))
    qp = q_positions[:, None, None, :, None]
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, rep, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, rep, Sq, dh), device=q.device)
    for c0 in range(0, Sk, kv_chunk):
        c1 = min(c0 + kv_chunk, Sk)
        s = qg @ kg[:, :, None, c0:c1].transpose(-1, -2)   # (B,G,rep,Sq,ck)
        pj = kv_positions[:, None, None, None, c0:c1]
        mask = valid[:, None, None, None, c0:c1]
        if causal:
            mask = mask & (pj <= qp)
        if window > 0:
            mask = mask & (pj > qp - window)
        s = torch.where(mask, s, NEG_INF)
        m, l, acc = _online_update(m, l, acc, s, vg[:, :, None, c0:c1])
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dh)
    return out.to(q.dtype)


def combine_softmax_partials(m: torch.Tensor, l: torch.Tensor,
                             acc: torch.Tensor, axis: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Combine per-shard online-softmax partial states (m, l, acc) along
    ``axis`` into the exact full-softmax state — the same rescale-and-sum
    as the per-chunk merge inside ``chunked_attention``, applied once
    across shards (the sequence-parallel reduction)."""
    m_new = m.amax(dim=axis)
    corr = torch.exp(m - m_new.unsqueeze(axis))
    l_new = (l * corr).sum(dim=axis)
    acc_new = (acc * corr[..., None]).sum(dim=axis)
    return m_new, l_new, acc_new


def paged_decode_attention(
    q: torch.Tensor,               # (B, Hq, dh) one query token per row
    pages: torch.Tensor,           # (B, n, kvs, 2, P, dh) the rows' pages
    kv_positions: torch.Tensor,    # (B, n*P) global positions (-1 = empty)
    q_positions: torch.Tensor,     # (B,)
    window: int = 0,
) -> torch.Tensor:
    """Decode attention walking each row's pages with an online softmax,
    masked by stored POSITIONS (``pos >= 0``, ``pos <= q_pos``, window) —
    the plain version of the paged-decode kernel."""
    B, n, kvs, _, P, dh = pages.shape
    Hq = q.shape[1]
    rep = Hq // kvs
    scale = 1.0 / math.sqrt(dh)
    qg = (q.reshape(B, kvs, rep, dh).float() * scale)
    pos = kv_positions.reshape(B, n, P)
    qp = q_positions[:, None]
    m = torch.full((B, kvs, rep), NEG_INF, device=q.device)
    l = torch.zeros((B, kvs, rep), device=q.device)
    acc = torch.zeros((B, kvs, rep, dh), device=q.device)
    for j in range(n):
        kj = pages[:, j, :, 0].float()                # (B, kvs, P, dh)
        vj = pages[:, j, :, 1].float()
        pj = pos[:, j]
        mask = (pj >= 0) & (pj <= qp)
        if window > 0:
            mask = mask & (pj > qp - window)
        s = qg @ kj.transpose(-1, -2)                 # (B, kvs, rep, P)
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        m, l, acc = _online_update(m, l, acc, s, vj)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(B, Hq, dh).to(q.dtype)
