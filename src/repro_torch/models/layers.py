"""Core layer math of the dense decoder, in PyTorch.

The counterpart of ``repro.models.layers`` for the ATTN / SLIDING block
kinds.  Attention here is the plain online-softmax version (chunked over
keys, never forming a full score matrix for long keys); on the card the
CUDA kernels in ``repro_torch.kernels`` compute the same functions.  The
walks also return their unnormalised partial state (``chunked_partials``,
``paged_partials``: the reference's ``_chunked_partials`` /
``_paged_partials``), which ``combine_softmax_partials`` merges across
sequence-parallel shards; ``sp > 1`` computes the sharded forms as the
reference does, each shard a contiguous slice of the keys.

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


def chunked_partials(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor, kv_positions: torch.Tensor,
                     valid: torch.Tensor, causal: bool, window: int,
                     kv_chunk: int) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Online-softmax partial state (m, l, acc) of one key walk, m in
    natural-log units: the reference's ``_chunked_partials``.  qg: (B,
    G, rep, Sq, dh) scaled fp32 queries; k, v: (B, Sk, G, dh);
    positions: (B, Sq) / (B, Sk); valid: (B, Sk).  Returns m, l: (B, G,
    rep, Sq), acc: (B, G, rep, Sq, dh)."""
    B, Hkv, rep, Sq, dh = qg.shape
    Sk = k.shape[1]
    # the last chunk padded with invalid keys, as the reference's scan
    # walks whole chunks (a row whose keys are all masked counts them)
    kv_chunk = min(kv_chunk, Sk)
    pad = (-Sk) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
        valid = F.pad(valid, (0, pad), value=False)
        Sk += pad
    kg = k.float().permute(0, 2, 1, 3)
    vg = v.float().permute(0, 2, 1, 3)
    qp = q_positions[:, None, None, :, None]
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, device=qg.device)
    l = torch.zeros((B, Hkv, rep, Sq), device=qg.device)
    acc = torch.zeros((B, Hkv, rep, Sq, dh), device=qg.device)
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
    return m, l, acc


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
    sp: int = 1,
) -> torch.Tensor:
    """Online-softmax attention over key chunks; never forms (Sq, Sk).
    The plain version of the flash and chunk-prefill kernels.  ``sp >
    1``: the keys split into ``sp`` contiguous slices (padded with
    invalid keys to equal length), each walked alone, and the partial
    states combined once, as the reference's sequence-parallel form.
    No engine path sets ``sp``: a sharded engine runs
    ``chunked_partials`` and ``combine_softmax_partials`` itself; the
    option mirrors the reference's signature for the parity tests."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(dh)
    # (B, G, rep, Sq, dh) queries
    qg = (q.reshape(B, Sq, Hkv, rep, dh).float() * scale
          ).permute(0, 2, 3, 1, 4)
    valid = (kv_valid if kv_valid is not None
             else torch.ones((B, Sk), dtype=torch.bool, device=q.device))
    if sp > 1 and Sk > sp:
        pad = (-Sk) % sp
        if pad:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            kv_positions = F.pad(kv_positions, (0, pad), value=-1)
            valid = F.pad(valid, (0, pad), value=False)
        Sks = (Sk + pad) // sp

        def fold(x):
            return x.reshape(B * sp, Sks, *x.shape[2:])

        m, l, acc = chunked_partials(
            qg.repeat_interleave(sp, dim=0), fold(k), fold(v),
            q_positions.repeat_interleave(sp, dim=0), fold(kv_positions),
            fold(valid), causal, window, kv_chunk)
        m, l, acc = combine_softmax_partials(
            m.reshape(B, sp, *m.shape[1:]), l.reshape(B, sp, *l.shape[1:]),
            acc.reshape(B, sp, *acc.shape[1:]), axis=1)
    else:
        m, l, acc = chunked_partials(qg, k, v, q_positions, kv_positions,
                                     valid, causal, window, kv_chunk)
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


def paged_partials(qg: torch.Tensor, pages: torch.Tensor,
                   kv_positions: torch.Tensor, q_positions: torch.Tensor,
                   window: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Online-softmax partial state (m, l, acc) of one page walk, m in
    natural-log units: the reference's ``_paged_partials``.  qg: (B, kvs,
    rep, dh) scaled fp32 queries; pages: (B, n, kvs, 2, P, dh);
    kv_positions: (B, n*P); q_positions: (B,).  Returns m, l: (B, kvs,
    rep), acc: (B, kvs, rep, dh)."""
    B, n, kvs, _, P, dh = pages.shape
    rep = qg.shape[2]
    pos = kv_positions.reshape(B, n, P)
    qp = q_positions[:, None]
    m = torch.full((B, kvs, rep), NEG_INF, device=qg.device)
    l = torch.zeros((B, kvs, rep), device=qg.device)
    acc = torch.zeros((B, kvs, rep, dh), device=qg.device)
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
    return m, l, acc


def paged_decode_attention(
    q: torch.Tensor,               # (B, Hq, dh) one query token per row
    pages: torch.Tensor,           # (B, n, kvs, 2, P, dh) the rows' pages
    kv_positions: torch.Tensor,    # (B, n*P) global positions (-1 = empty)
    q_positions: torch.Tensor,     # (B,)
    window: int = 0,
    sp: int = 1,
) -> torch.Tensor:
    """Decode attention walking each row's pages with an online softmax,
    masked by stored POSITIONS (``pos >= 0``, ``pos <= q_pos``, window) —
    the plain version of the paged-decode kernel.  ``sp > 1`` (with
    ``n % sp == 0`` and ``n > sp``): each of ``sp`` contiguous page
    slices walked alone and the partial states combined once, as the
    reference's sequence-parallel form.  No engine path sets ``sp`` (a
    sharded engine runs ``paged_partials`` and the combine itself); the
    option mirrors the reference's signature for the parity tests."""
    B, n, kvs, _, P, dh = pages.shape
    Hq = q.shape[1]
    rep = Hq // kvs
    scale = 1.0 / math.sqrt(dh)
    qg = (q.reshape(B, kvs, rep, dh).float() * scale)
    if sp > 1 and n % sp == 0 and n > sp:
        ns = n // sp
        m, l, acc = paged_partials(
            qg.repeat_interleave(sp, dim=0),
            pages.reshape(B * sp, ns, *pages.shape[2:]),
            kv_positions.reshape(B * sp, ns * P),
            q_positions.repeat_interleave(sp, dim=0), window)
        m, l, acc = combine_softmax_partials(
            m.reshape(B, sp, kvs, rep), l.reshape(B, sp, kvs, rep),
            acc.reshape(B, sp, kvs, rep, dh), axis=1)
    else:
        m, l, acc = paged_partials(qg, pages, kv_positions, q_positions,
                                   window)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(B, Hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma / Griffin)  [arXiv:2402.19427]
# ---------------------------------------------------------------------------
#
# The reference's ``rglru`` / ``rglru_step`` / ``causal_conv1d``
# (``repro/models/layers.py:261-325``): fp32 inside, output and state
# cast to the model's dtype.  The reference runs the sequence form as a
# ``jax.lax.associative_scan``; here it is a BLOCKED scan of fixed
# order.  Inside each block of ``block`` tokens a log-depth
# (Hillis-Steele) scan runs from a zero carry, every block at once; the
# carries then pass across blocks in order, and each token adds its
# block's carry times its running product of ``a``.  A call whose start
# lies on a block boundary, carrying the state at that boundary, gives
# the same bits as one call over the whole sequence: the engine's chunk
# boundaries are page-aligned and the block is the page size, so in
# fp32 chunked prefill equals whole-prompt prefill bit for bit.  In a
# bf16 model the carry between chunks is stored in bf16, as the
# reference stores it, so there the two differ by that rounding.  Every
# step is a separate multiply and add (no fused multiply-add), so each
# value is rounded the same way whatever the shape of the call.

_C_RGLRU = 8.0


def _rglru_coeffs(x: torch.Tensor, gate_x: torch.Tensor,
                  gate_a: torch.Tensor, a_param: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence h_t = a_t * h_{t-1} + b_t, fp32."""
    log_a = (-_C_RGLRU * F.softplus(a_param.float())
             * torch.sigmoid(gate_a.float()))
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    gx = x.float() * torch.sigmoid(gate_x.float())
    return a, mult * gx


def rglru(x: torch.Tensor, gate_x: torch.Tensor, gate_a: torch.Tensor,
          a_param: torch.Tensor, h0: Optional[torch.Tensor] = None,
          block: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real-Gated Linear Recurrent Unit over a sequence.  x, gate_x,
    gate_a: (B, S, D); a_param: (D,) fp32; h0: (B, D) carried state (zero
    when None).  Returns (y (B, S, D), h_last (B, D)), both in x's
    dtype.  Depth: log2(block) whole-tensor steps, then one small step a
    block for the carries."""
    B, S, D = x.shape
    a, b = _rglru_coeffs(x, gate_x, gate_a, a_param)
    L = block
    nb = -(-S // L)
    pad = nb * L - S
    if pad:     # identity steps at the end: a = 1, b = 0
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    a = a.view(B, nb, L, D)
    b = b.view(B, nb, L, D)
    k = 1
    while k < L:
        b = torch.cat([b[:, :, :k],
                       b[:, :, k:] + a[:, :, k:] * b[:, :, :-k]], dim=2)
        a = torch.cat([a[:, :, :k], a[:, :, k:] * a[:, :, :-k]], dim=2)
        k *= 2
    c = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    carries = [c]
    for j in range(nb - 1):
        c = b[:, j, -1] + a[:, j, -1] * c
        carries.append(c)
    y = b + a * torch.stack(carries, dim=1)[:, :, None, :]
    y = y.view(B, nb * L, D)[:, :S]
    return y.to(x.dtype), y[:, -1].to(x.dtype)


def rglru_step(x: torch.Tensor, gate_x: torch.Tensor, gate_a: torch.Tensor,
               a_param: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x, gates: (B, D); h: (B, D).  Returns (y, new
    state), both the new state in x's dtype."""
    a, b = _rglru_coeffs(x, gate_x, gate_a, a_param)
    h_new = (a * h.float() + b).to(x.dtype)
    return h_new, h_new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal temporal conv.  x: (B, S, D), w: (K, D), b: (D,),
    state: (B, K-1, D) trailing inputs (zero when None).  Returns (y,
    new_state), y in x's dtype."""
    K = w.shape[0]
    B, S, D = x.shape
    if state is None:
        state = x.new_zeros((B, K - 1, D))
    xp = torch.cat([state.to(x.dtype), x], dim=1)       # (B, S+K-1, D)
    y = torch.zeros((B, S, D), dtype=torch.float32, device=x.device)
    for i in range(K):                  # K is tiny (4): unrolled
        y = y + xp[:, i:i + S].float() * w[i].float()
    y = (y + b.float()).to(x.dtype)
    return y, xp[:, S:]


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory cell)  [arXiv:2405.04517]
# ---------------------------------------------------------------------------
#
# The reference's ``mlstm_chunkwise`` / ``mlstm_step``
# (``repro/models/layers.py:328-431``): fp32 inside with the stabiliser
# ``m`` (``NEG_INF`` when fresh) and the floor ``max(|den|, 1)``, the
# output in q's dtype.  The reference runs chunks of ``min(256, S)``
# tokens and refuses a call longer than 256 tokens that 256 does not
# divide; the chunkwise form is exact for any blocking, so here the
# blocks are ``block`` tokens (the engine's page size) and the last may
# be shorter: it is padded with tokens whose input gate is ``NEG_INF``
# and whose forget gate is 1, which add nothing to the state.  Every
# block's state-free work (gates, decay matrix, the within-block
# attention-like products) runs for all blocks at once; a loop over the
# blocks carries ``m`` and, in place in one buffer, ``C`` and ``n``
# (each block's own ``k^T (w v)`` written there first, then the carried
# state times its decay added on).  Per-block quantities of ``(B, H)``
# shape are computed inside that loop, so a call that starts on a
# block boundary carrying the state there runs every block's
# operations on tensors of the same shapes as one call over the whole
# sequence: in fp32 chunked prefill equals whole-prompt prefill bit for
# bit (on the CPU at test widths).  The state stays fp32 at any model
# dtype, so the carry between chunks is never rounded.


def _mlstm_fresh(B: int, H: int, dh: int, device):
    f32 = torch.float32
    return (torch.zeros((B, H, dh, dh), dtype=f32, device=device),
            torch.zeros((B, H, dh), dtype=f32, device=device),
            torch.full((B, H), NEG_INF, dtype=f32, device=device))


def _mlstm_blocks(q, k, v, i_gate, f_gate, block: int):
    """The state-free work of every block at once: (qb, kb, vb, fcum,
    ftot, dmat, m_intra, tail, tail_max), each (nb, B, H, ...) fp32."""
    B, S, H, dh = q.shape
    L = block
    nb = -(-S // L)
    pad = nb * L - S
    scale = 1.0 / math.sqrt(dh)

    def blocks(t: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """(B, S, H, ...) -> (nb, B, H, L, ...) fp32, padded at the end."""
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=fill)
        t = t.reshape(B, nb, L, *t.shape[2:]).transpose(0, 1)
        return t.transpose(2, 3).contiguous()

    qb = blocks(q) * scale                              # (nb,B,H,L,dh)
    kb, vb = blocks(k), blocks(v)
    ig = blocks(i_gate, NEG_INF)                        # (nb,B,H,L)
    fcum = torch.cumsum(blocks(F.logsigmoid(f_gate.float())), dim=-1)
    ftot = fcum[..., -1]                                # (nb,B,H)
    # D[t, s] = sum_{r=s+1..t} log f + i_s, causal
    dmat = fcum[..., :, None] - fcum[..., None, :] + ig[..., None, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(causal, dmat, NEG_INF)           # (nb,B,H,L,L)
    m_intra = dmat.amax(dim=-1)                         # (nb,B,H,L)
    tail = ftot[..., None] - fcum + ig                  # (nb,B,H,L)
    tail_max = tail.amax(dim=-1)                        # (nb,B,H)
    return qb, kb, vb, fcum, ftot, dmat, m_intra, tail, tail_max


def _mlstm_stabilisers(m0, ftot, tail_max):
    """``m`` entering and leaving each block: (m_in, m_out) (nb, B, H)
    and the last block's ``m``."""
    m_in, m_out = [], []
    m = m0
    for j in range(ftot.shape[0]):
        m_in.append(m)
        m = torch.maximum(m + ftot[j], tail_max[j])
        m_out.append(m)
    return torch.stack(m_in), torch.stack(m_out), m


def _mlstm_read(qb, kb, vb, Cs, ns, m_in, fcum, dmat, m_intra, S: int
                ) -> torch.Tensor:
    """Each block's output from the state entering it (``Cs`` (nb, B, H,
    dh, dh), ``ns``) and its own tokens: h (B, S, H, dh) fp32."""
    nb, B, H, L, dh = qb.shape
    m_inter = m_in[..., None] + fcum                    # (nb,B,H,L)
    m_t = torch.maximum(m_inter, m_intra)
    w_inter = torch.exp(m_inter - m_t)
    h_inter = torch.matmul(qb, Cs) * w_inter[..., None]
    qn = torch.matmul(qb, ns[..., None])[..., 0] * w_inter
    pw = torch.exp(dmat - m_t[..., None]) * torch.matmul(
        qb, kb.transpose(-1, -2))                       # (nb,B,H,t,s)
    num = h_inter + torch.matmul(pw, vb)
    den = qn + pw.sum(dim=-1)
    h = num / torch.clamp_min(den.abs(), 1.0)[..., None]
    return h.transpose(2, 3).transpose(0, 1).reshape(B, nb * L, H, dh)[:, :S]


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor,
                    state: Optional[Tuple[torch.Tensor, ...]] = None,
                    block: int = 64
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Stabilised chunkwise mLSTM over a sequence.  q, k, v: (B, S, H,
    dh); i_gate, f_gate: (B, S, H) pre-activations; state: (C (B, H, dh,
    dh), n (B, H, dh), m (B, H)) carried in (fresh when None).  Returns
    (h (B, S, H, dh) in q's dtype, (C, n, m) fp32)."""
    B, S, H, dh = q.shape
    qb, kb, vb, fcum, ftot, dmat, m_intra, tail, tail_max = _mlstm_blocks(
        q, k, v, i_gate, f_gate, block)
    nb = qb.shape[0]
    C0, n0, m0 = (_mlstm_fresh(B, H, dh, q.device) if state is None
                  else tuple(s.float() for s in state))
    # Cs[j] / ns[j]: the state entering block j; each block's own
    # increment lands in slot j + 1 first, the carried part is added on
    Cs = torch.empty((nb + 1, B, H, dh, dh), dtype=torch.float32,
                     device=q.device)
    ns = torch.empty((nb + 1, B, H, dh), dtype=torch.float32,
                     device=q.device)
    Cs[0].copy_(C0)
    ns[0].copy_(n0)
    m_in, m_out, m = _mlstm_stabilisers(m0, ftot, tail_max)
    wgt = torch.exp(tail - m_out[..., None])            # (nb,B,H,L)
    kw = kb * wgt[..., None]
    torch.matmul(kw.transpose(-1, -2), vb, out=Cs[1:])
    torch.sum(kw, dim=-2, out=ns[1:])
    for j in range(nb):
        decay = torch.exp(m_in[j] + ftot[j] - m_out[j])  # (B,H)
        Cs[j + 1].add_(Cs[j] * decay[..., None, None])
        ns[j + 1].add_(ns[j] * decay[..., None])
    h = _mlstm_read(qb, kb, vb, Cs[:nb], ns[:nb], m_in, fcum, dmat,
                    m_intra, S)
    return h.to(q.dtype), (Cs[nb], ns[nb], m)


def mlstm_chunkwise_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          i_gate: torch.Tensor, f_gate: torch.Tensor,
                          block: int = 64) -> torch.Tensor:
    """``mlstm_chunkwise`` from a fresh state with no write in place, so
    autograd can run through it (training): the block states are
    stacked, not written into one buffer.  The same operations on the
    same values, so in fp32 on the CPU it gives ``mlstm_chunkwise``'s
    bits.  Returns h (B, S, H, dh) in q's dtype."""
    B, S, H, dh = q.shape
    qb, kb, vb, fcum, ftot, dmat, m_intra, tail, tail_max = _mlstm_blocks(
        q, k, v, i_gate, f_gate, block)
    C, n, m0 = _mlstm_fresh(B, H, dh, q.device)
    m_in, m_out, _ = _mlstm_stabilisers(m0, ftot, tail_max)
    kw = kb * torch.exp(tail - m_out[..., None])[..., None]
    incC = torch.matmul(kw.transpose(-1, -2), vb)       # (nb,B,H,dh,dh)
    incn = torch.sum(kw, dim=-2)
    Cs, ns = [], []
    for j in range(qb.shape[0]):
        Cs.append(C)
        ns.append(n)
        decay = torch.exp(m_in[j] + ftot[j] - m_out[j])  # (B,H)
        C = incC[j] + C * decay[..., None, None]
        n = incn[j] + n * decay[..., None]
    h = _mlstm_read(qb, kb, vb, torch.stack(Cs), torch.stack(ns), m_in,
                    fcum, dmat, m_intra, S)
    return h.to(q.dtype)


def mlstm_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_gate: torch.Tensor, f_gate: torch.Tensor,
               state: Tuple[torch.Tensor, ...],
               out: Optional[Tuple[torch.Tensor, ...]] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One decode token.  q, k, v: (B, H, dh); gates: (B, H); state (C,
    n, m).  ``out``: fp32 tensors (C, n, m) the new state is written
    into (they may be ``state``'s own: an update in place, reading and
    writing ``C`` once each for its decay and once for the new outer
    product).  Returns (h (B, H, dh) in q's dtype, the new state)."""
    C, n, m = (s.float() for s in state)
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    logf = F.logsigmoid(f_gate.float())
    i = i_gate.float()
    lm = logf + m
    m_new = torch.maximum(lm, i)
    fw = torch.exp(lm - m_new)
    iw = torch.exp(i - m_new)
    kf, vf, qf = k.float(), v.float(), q.float() * scale
    Co, no, mo = out if out is not None else (None, None, None)
    C_new = torch.mul(C, fw[..., None, None], out=Co)
    C_new.addcmul_((iw[..., None] * kf)[..., :, None], vf[..., None, :])
    n_new = torch.mul(n, fw[..., None], out=no)
    n_new.add_(iw[..., None] * kf)
    if mo is not None:
        m_new = mo.copy_(m_new)
    num = torch.matmul(qf[..., None, :], C_new)[..., 0, :]
    den = torch.clamp_min(torch.matmul(
        qf[..., None, :], n_new[..., None])[..., 0, 0].abs(), 1.0)
    h = num / den[..., None]
    return h.to(q.dtype), (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, exponential gating, diagonal recurrent weights)
# ---------------------------------------------------------------------------
#
# The reference's ``slstm_seq`` (``repro/models/layers.py:434-469``): a
# true nonlinear recurrence (each token's gates read the previous h), so
# it runs token by token, fp32 inside, the state fp32.  The step is cut
# to 15 launches (fused multiply-adds where the reference's sums are
# products plus a term, one exp for both gate weights).


def _slstm_fresh(B: int, D: int, device):
    f32 = torch.float32
    z = torch.zeros((B, D), dtype=f32, device=device)
    return z, torch.ones((B, D), dtype=f32, device=device), z.clone(), \
        z.clone()


def slstm_step(zt: torch.Tensor, r: torch.Tensor,
               state: Tuple[torch.Tensor, ...],
               out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, ...]:
    """One token: zt (B, 4, D) fp32 pre-activations of z, i, f, o; r (4,
    D) fp32 diagonal recurrent weights; state (c, n, m, h) fp32.  The new
    h is written into ``out`` when given.  Returns the new (c, n, m,
    h)."""
    c, n, m, h = state
    pre = torch.addcmul(zt, r, h[:, None])             # (B,4,D)
    z = torch.tanh(pre[:, 0])
    lm = F.logsigmoid(pre[:, 2]) + m
    m_new = torch.maximum(lm, pre[:, 1])
    w = torch.exp(torch.stack((pre[:, 1], lm)) - m_new)  # i_w, f_w
    c_new = torch.addcmul(w[1] * c, w[0], z)
    n_new = torch.addcmul(w[0], w[1], n)
    h_new = torch.div(torch.sigmoid(pre[:, 3]) * c_new,
                      torch.clamp_min(n_new, 1.0), out=out)
    return c_new, n_new, m_new, h_new


def slstm_seq(zifo: torch.Tensor, r_diag: torch.Tensor,
              state: Optional[Tuple[torch.Tensor, ...]] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """zifo: (B, S, 4, D) pre-activations; r_diag: (4, D); state (c, n,
    m, h) (fresh when None: n = 1, the rest 0).  Returns (h (B, S, D) in
    zifo's dtype, the final state, fp32)."""
    B, S, _, D = zifo.shape
    st = (_slstm_fresh(B, D, zifo.device) if state is None
          else tuple(s.float() for s in state))
    zs = zifo.float().transpose(0, 1)                   # (S,B,4,D)
    r = r_diag.float()
    hs = torch.empty((S, B, D), dtype=torch.float32, device=zifo.device)
    for t in range(S):
        st = slstm_step(zs[t], r, st, out=hs[t])
    return hs.transpose(0, 1).to(zifo.dtype), st


def slstm_seq_train(zifo: torch.Tensor, r_diag: torch.Tensor
                    ) -> torch.Tensor:
    """``slstm_seq`` from a fresh state with no write in place (each
    token's h is kept and the tokens stacked), so autograd can run
    through it (training); in fp32 on the CPU it gives ``slstm_seq``'s
    bits.  Returns h (B, S, D) in zifo's dtype."""
    B, S, _, D = zifo.shape
    st = _slstm_fresh(B, D, zifo.device)
    zs = zifo.float().transpose(0, 1)                   # (S,B,4,D)
    r = r_diag.float()
    hs = []
    for t in range(S):
        st = slstm_step(zs[t], r, st)
        hs.append(st[3])
    return torch.stack(hs).transpose(0, 1).to(zifo.dtype)
