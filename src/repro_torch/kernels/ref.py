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
from typing import Tuple

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


# ---------------------------------------------------------------------------
# Softmax partial states (sequence-parallel shards)
# ---------------------------------------------------------------------------
#
# A partial state is (m, l, acc) of ``parts = rows * kvs * splits * rep``
# (row, kv head, split, head) entries: m (natural-log units) and l, then
# the unnormalised acc of dh each, fp32, one flat buffer of
# ``partials_numel`` floats in that order.  The kernels write it, the
# shards exchange it, and ``softmax_combine`` merges sets of it.

def partials_numel(rows: int, kvs: int, splits: int, rep: int, dh: int
                   ) -> int:
    return rows * kvs * splits * rep * (2 + dh)


def pack_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  out: torch.Tensor) -> None:
    """(m, l, acc) in the buffer layout, into ``out`` (1-D fp32)."""
    n = m.numel()
    out[:n].copy_(m.reshape(-1))
    out[n:2 * n].copy_(l.reshape(-1))
    out[2 * n:].copy_(acc.reshape(-1))


def unpack_partials(buf: torch.Tensor, rows: int, kvs: int, splits: int,
                    rep: int, dh: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Views of a buffer's m, l: (rows, kvs, splits, rep) and acc: (rows,
    kvs, splits, rep, dh)."""
    n = rows * kvs * splits * rep
    shape = (rows, kvs, splits, rep)
    return (buf[:n].view(shape), buf[n:2 * n].view(shape),
            buf[2 * n:(2 + dh) * n].view(*shape, dh))


def softmax_combine_ref(parts: torch.Tensor, rows: int, kvs: int,
                        splits: int, rep: int, dh: int, dtype
                        ) -> torch.Tensor:
    """Merge ``parts`` (sets, numel): every set's splits of each (row,
    head), the rescale-and-sum of ``layers.combine_softmax_partials``,
    then the normalised output (rows, kvs * rep, dh) in ``dtype``."""
    sets = parts.shape[0]
    ms, ls, accs = zip(*(unpack_partials(p, rows, kvs, splits, rep, dh)
                         for p in parts))
    # (rows, kvs, rep, sets * splits[, dh])
    m = torch.cat(ms, dim=2).transpose(2, 3)
    l = torch.cat(ls, dim=2).transpose(2, 3)
    acc = torch.cat(accs, dim=2).transpose(2, 3)
    assert m.shape[-1] == sets * splits
    m, l, acc = Lyr.combine_softmax_partials(m, l, acc, axis=3)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(rows, kvs * rep, dh).to(dtype)


def paged_decode_partials_ref(q: torch.Tensor, pool: torch.Tensor,
                              page_table: torch.Tensor,
                              kv_positions: torch.Tensor,
                              q_positions: torch.Tensor, window: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """One shard's walk of its pages, as its partial state: m, l (B, kvs,
    rep), acc (B, kvs, rep, dh) (the reference's ``_paged_partials``).
    Arguments as ``paged_decode_ref``'s."""
    B, Hq, dh = q.shape
    kvs = pool.shape[1]
    qg = q.reshape(B, kvs, Hq // kvs, dh).float() * (1.0 / math.sqrt(dh))
    return Lyr.paged_partials(qg, pool[page_table.long()], kv_positions,
                              q_positions, window)


def chunk_prefill_partials_ref(q, k_new, v_new, pool, page_table,
                               kv_positions, q_positions, *,
                               window: int = 0, attend_prefix: bool = True,
                               attend_self: bool = True,
                               shard: Tuple[int, int] = (0, 1)
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """One shard's chunk attention as its partial state: the queries
    over the shard's prefix pages and, with ``attend_self``, the chunk's
    own keys (the reference's ``_chunked_partials``); then the chunk's
    K/V scattered into the pages the shard holds.  Returns m, l (B, S,
    kvs, rep) and acc (B, S, kvs, rep, dh).  Arguments as
    ``chunk_prefill_ref``'s."""
    B, S, Hq, dh = q.shape
    kvs = pool.shape[1]
    rep = Hq // kvs
    state = pp.PagedState(pool, page_table,
                          torch.zeros((B,), dtype=torch.int32,
                                      device=q.device), kv_positions)
    ks, vs, kp, valid = [], [], [], []
    if attend_prefix:
        pk, pv, ppos, pvalid = pp.gather_kv(state)
        ks, vs, kp, valid = [pk], [pv], [ppos], [pvalid]
    if attend_self:
        ks, vs = ks + [k_new], vs + [v_new]
        kp, valid = kp + [q_positions], valid + [q_positions >= 0]
    qg = (q.reshape(B, S, kvs, rep, dh).float() * (1.0 / math.sqrt(dh))
          ).permute(0, 2, 3, 1, 4)
    if ks:
        m, l, acc = Lyr.chunked_partials(
            qg, torch.cat(ks, dim=1), torch.cat(vs, dim=1), q_positions,
            torch.cat(kp, dim=1), torch.cat(valid, dim=1), True, window,
            1024)
    else:
        m = torch.full((B, kvs, rep, S), Lyr.NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, kvs, rep, S, dh), device=q.device)
    pp.scatter_chunk(state, k_new, v_new, q_positions, shard=shard)
    return (m.permute(0, 3, 1, 2), l.permute(0, 3, 1, 2),
            acc.permute(0, 3, 1, 2, 4))


def chunk_prefill_ref(q, k_new, v_new, pool, page_table, kv_positions,
                      q_positions, *, window: int = 0,
                      attend_prefix: bool = True,
                      shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """A chunk's attention over its paged prefix and then itself, then
    the chunk's K/V written into ``pool`` IN PLACE at the bytes
    ``pool.write_chunk`` writes.  Returns the attention (B, S, Hq, dh).

    The prefix is gathered BEFORE the scatter, so on a ring cache the
    keys the chunk evicts are still attended.

    q: (B, S, Hq, dh); k_new/v_new: (B, S, kvs, dh); pool: (NP, kvs, 2,
    P, dh) canonical; page_table: (B, n); kv_positions: (B, cap);
    q_positions: (B, S), -1 for a padding token (no key, not written).
    On an sp shard (``shard``) only the tokens whose page it holds are
    written."""
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
    pp.scatter_chunk(state, k_new, v_new, q_positions, shard=shard)
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


def copy_page_slices_ref(src: torch.Tensor, dst: torch.Tensor,
                         src_pages: torch.Tensor, src_hblocks: torch.Tensor,
                         dst_pages: torch.Tensor, dst_hblocks: torch.Tensor,
                         heads_per_slice: int) -> torch.Tensor:
    """Segment ``i`` (``heads_per_slice`` heads from head block
    ``src_hblocks[i]`` of page ``src_pages[i]``) written into ``dst`` IN
    PLACE at (``dst_pages[i]``, ``dst_hblocks[i]``); every other byte of
    ``dst`` is kept.  Returns ``dst``.  src: (NPs, Hs, 2, P, dh);
    dst: (NPd, Hd, 2, P, dh)."""
    hps = heads_per_slice
    NPs, Hs = src.shape[:2]
    NPd, Hd = dst.shape[:2]
    seg = src.reshape(NPs, Hs // hps, hps, *src.shape[2:])[
        src_pages.long(), src_hblocks.long()]
    dst.view(NPd, Hd // hps, hps, *dst.shape[2:])[
        dst_pages.long(), dst_hblocks.long()] = seg.to(dst.dtype)
    return dst


def gather_page_slices_ref(pool: torch.Tensor, pages: torch.Tensor,
                           hblocks: torch.Tensor, heads_per_slice: int
                           ) -> torch.Tensor:
    """Pack segments into a send buffer: row ``i`` is head block
    ``hblocks[i]`` of page ``pages[i]``.  pool: (NP, H, 2, P, dh) ->
    (n, heads_per_slice, 2, P, dh)."""
    hps = heads_per_slice
    NP, H = pool.shape[:2]
    return pool.reshape(NP, H // hps, hps, *pool.shape[2:])[
        pages.long(), hblocks.long()]


def real_ff_index(ff: int, ffp: int, tp: int, device=None) -> torch.Tensor:
    """Padded column of each real ff column: real column j of shard
    ``j // (ff/tp)`` sits at ``shard * (ffp/tp) + j % (ff/tp)``."""
    j = torch.arange(ff, device=device)
    real, per = ff // tp, ffp // tp
    return (j // real) * per + j % real


def padded_ffn_ref(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                   tp: int, ff: int, activation: str = "swiglu"
                   ) -> torch.Tensor:
    """Gated FFN over per-shard padded weights (paper Eq. 2), visiting
    only the real columns; the port of ``repro.kernels.ref.padded_ffn_ref``
    with the TPU kernel's column walk.  x: (T, d); wi: (d, 2*ffp) fused
    [gate | up], each of ``tp`` shards ``ff/tp`` real columns then zeros;
    wo: (ffp, d).  The products accumulate in fp32; h = f(gate) * up is
    rounded to x's type before the down product, as the kernel does.
    ``gelu`` (ungated) ignores the up half, as the TPU kernel does."""
    ffp = wi.shape[1] // 2
    cols = real_ff_index(ff, ffp, tp, x.device)
    xf = x.float()
    g = xf @ wi[:, cols].float()
    if activation == "gelu":
        h = Lyr._act("gelu", g)
    else:
        h = Lyr._act(activation, g) * (xf @ wi[:, ffp + cols].float())
    return (h.to(x.dtype).float() @ wo[cols].float()).to(x.dtype)
