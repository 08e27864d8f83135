"""Paged decode attention: the CUDA kernel ``csrc/paged_attention.cu``
(replacing the TPU kernel ``repro/kernels/paged_attention.py``) and its
plain version ``ref.paged_decode_ref``.

``paged_decode`` is the engine's entry: one query token per row over
the rows' pages of the header-centric pool, masked by stored positions.
``paged_attention`` keeps the TPU kernel's signature (mask by
``seq_lens``) and runs the same kernel on positions built from
``seq_lens``.

On a sequence-parallel shard, ``paged_decode_partials`` runs the split
launch alone and leaves each split's partial state in a buffer the
caller owns (``ref.partials_numel`` floats; the plain version walks the
shard's pages as one split), and ``softmax_combine`` merges any number
of such sets (the shards' buffers after their exchange, or the chunk
kernel's partials) into the output.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ops, ref

#: kernel launches since the last reset (the card only; one per call,
#: counting the split and combine launches of a call as one); the
#: partial entry's split launches and the combine's launches
launches = 0
partial_launches = 0
combine_launches = 0
plain = ref.paged_decode_ref

HEAD_DIMS = (64, 96, 128, 160, 256)
#: query heads a kv head, at most: the 16 rows of the bf16 tile's A operand
MAX_REP = 16
MAX_SMEM = 227 * 1024
RING_KEYS = 64   # keys of a bf16 ring stage, at least


def supports(Hq: int, kvs: int, dh: int, dtype: torch.dtype,
             P: int = 64) -> bool:
    """Whether the CUDA kernel takes this head shape, dtype and page
    size: dh in ``HEAD_DIMS`` and ``rep = Hq / kvs`` up to ``MAX_REP``;
    in bfloat16 pages of a multiple of 16 tokens (the tensor cores take
    16-key groups inside a page) whose ring stage (at least
    ``RING_KEYS`` keys: K and V in bf16 and their positions), or the
    warps' merge, fits shared memory (``bulk::ring_stages``).  The
    float32 kernel takes a page too large for shared memory in
    sub-tiles."""
    if not (kvs >= 1 and Hq % kvs == 0 and 1 <= Hq // kvs <= MAX_REP
            and dh in HEAD_DIMS and P >= 1):
        return False
    if dtype == torch.float32:
        return True
    if dtype != torch.bfloat16 or P % 16:
        return False
    stage = max(1, RING_KEYS // P) * P * (4 * dh + 4)
    merge = 4 * (Hq // kvs) * (dh + 2) * 4
    return max(stage, merge) + 16 <= MAX_SMEM


def num_splits(B: int, kvs: int, n: int, sms: int) -> int:
    """Splits of each row's pages: at most two blocks an SM over the
    (kv head, row) pairs (no partial second wave), at most one a page."""
    return max(1, min(n, 2 * sms // (B * kvs)))


def live_pages(q_pos: int, n: int, P: int, window: int = 0, page0: int = 0,
               n_total: int = 0) -> Tuple[int, int]:
    """The pages ``[lo, hi)`` of a row of ``n`` pages of ``P`` slots that
    can hold a key visible to a query at ``q_pos``: the bound the bf16
    kernel puts on its walk (``bulk::live_pages``; ``walk_ranges``
    holds the two together).  The pools put position p in slot ``p %
    (n_total * P)``, so a row that has not wrapped (``q_pos < n_total *
    P``) holds no visible key past slot ``q_pos``, nor, with a window,
    before slot ``q_pos - window + 1``; a wrapped row keeps every page,
    and ``q_pos < 0`` (an idle row) none.  An sp shard holds pages
    ``[page0, page0 + n)`` of the row's ``n_total`` (default: all ``n``)
    and walks the live ones among them, in its own page ids."""
    n_total = n_total or n
    if q_pos < 0:
        glo = ghi = 0
    elif q_pos >= n_total * P:
        glo, ghi = 0, n_total
    else:
        glo = max(0, q_pos - window + 1) // P if window > 0 else 0
        ghi = q_pos // P + 1
    lo = min(max(glo - page0, 0), n)
    return lo, max(min(ghi - page0, n), lo)


def split_pages(lo: int, hi: int, split: int, splits: int
                ) -> Tuple[int, int]:
    """Split ``split``'s even share of the live range ``[lo, hi)``."""
    return (lo + split * (hi - lo) // splits,
            lo + (split + 1) * (hi - lo) // splits)


def walk_ranges(q_positions: torch.Tensor, n: int, P: int, window: int,
                splits: int, page0: int = 0, n_total: int = 0
                ) -> torch.Tensor:
    """(B, splits, 2) int32: the pages ``[j0, j1)`` each split of each
    row walks.  The bf16 kernel computes its walk on the card from the
    rows' positions, so ``live_pages`` and ``split_pages`` above are its
    host model: for CUDA positions this launches the kernel's own range
    code (``bulk::split_range``) alone, for CPU positions it runs the
    model, and the card's check holds the one against the other."""
    n_total = n_total or n
    if not ops.on_card(q_positions):
        return torch.tensor(
            [[split_pages(*live_pages(q, n, P, window, page0, n_total), z,
                          splits)
              for z in range(splits)] for q in q_positions.tolist()],
            dtype=torch.int32).reshape(-1, splits, 2)
    B = q_positions.shape[0]
    ops.check_cuda_inputs(torch.int32, (), (q_positions,))
    out = torch.empty((B, splits, 2), dtype=torch.int32,
                      device=q_positions.device)
    err = _build.library("paged_attention").repro_decode_walk(
        ops.ptr(q_positions), ops.ptr(out), B, n, P, int(window), page0,
        n_total, splits, ops.stream(q_positions.device))
    _build.check(err, "decode walk launch")
    return out


def _check(q, pool, page_table, kv_positions, q_positions) -> None:
    """The kernel's refusals (shapes, head shape, dtype, alignment)."""
    B, Hq, dh = q.shape
    NP, kvs, two, P, dh2 = pool.shape
    n = page_table.shape[1]
    ops.require(two == 2 and dh2 == dh and Hq % kvs == 0,
                f"shapes q {tuple(q.shape)} / pool {tuple(pool.shape)}")
    ops.require(supports(Hq, kvs, dh, q.dtype, P),
                f"paged decode takes dh in {HEAD_DIMS} and rep <= "
                f"{MAX_REP} in float32 or bfloat16 and, in bfloat16, "
                f"pages of a multiple of 16 tokens whose ring stage fits "
                f"{MAX_SMEM} bytes; not Hq {Hq} / kv {kvs} / dh {dh} / "
                f"P {P} in {q.dtype}")
    if q.dtype == torch.bfloat16:
        # bulk copies from 16-byte aligned bases
        ops.require_tma(q, pool, kv_positions)
    ops.require(page_table.shape[0] == B
                and tuple(kv_positions.shape) == (B, n * P)
                and tuple(q_positions.shape) == (B,),
                "page_table / positions shapes")
    ops.check_cuda_inputs(q.dtype, (q, pool),
                          (page_table, kv_positions, q_positions))


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
    _check(q, pool, page_table, kv_positions, q_positions)
    B, Hq, dh = q.shape
    kvs, P = pool.shape[1], pool.shape[3]
    n = page_table.shape[1]
    rep = Hq // kvs
    # split each row's pages so that about two blocks per SM are in
    # flight (the bf16 kernel cuts each row's live range, the fp32 one
    # its capacity); the combine launch merges the splits' partial
    # states, kept in the reused per-stream workspace
    splits = num_splits(B, kvs, n, ops.sm_count(q.device))
    parts = B * kvs * splits * rep
    ws = ops.workspace(q.device, parts * (2 + dh))
    part_m, part_l, part_acc = ws[:parts], ws[parts:2 * parts], ws[2 * parts:]
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


def partial_splits(B: int, kvs: int, n: int, device) -> int:
    """The splits a shard's partial state carries for ``B`` rows of ``n``
    pages: the kernel's (``num_splits``) on the card, one (the plain
    walk) on the CPU."""
    if torch.device(device).type != "cuda":
        return 1
    return num_splits(B, kvs, n, ops.sm_count(device))


def paged_decode_partials(q: torch.Tensor, pool: torch.Tensor,
                          page_table: torch.Tensor,
                          kv_positions: torch.Tensor,
                          q_positions: torch.Tensor, out: torch.Tensor,
                          window: int = 0, shard: Tuple[int, int] = (0, 1)
                          ) -> int:
    """One sp shard's decode attention as partial states, written into
    ``out`` (1-D fp32, ``ref.partials_numel(B, kvs, splits, rep, dh)``
    floats, ``splits = partial_splits(B, kvs, n, q.device)``).  The
    shard holds pages ``[s*n, (s+1)*n)`` of rows of ``sp * n`` pages
    (``shard = (s, sp)``; ``page_table``: (B, n), ``kv_positions``: (B,
    n*P) global positions).  Other arguments as ``paged_decode``'s.
    Returns ``splits``."""
    B, Hq, dh = q.shape
    kvs, n = pool.shape[1], page_table.shape[1]
    s, sp = shard
    if not ops.on_card(q, pool, page_table, kv_positions, q_positions,
                       out):
        ref.pack_partials(*ref.paged_decode_partials_ref(
            q, pool, page_table, kv_positions, q_positions, window), out)
        return 1
    global partial_launches
    _check(q, pool, page_table, kv_positions, q_positions)
    rep, P = Hq // kvs, pool.shape[3]
    splits = partial_splits(B, kvs, n, q.device)
    parts = B * kvs * splits * rep
    ops.require(out.dtype == torch.float32 and out.is_contiguous()
                and out.numel() == parts * (2 + dh),
                f"partials take {parts * (2 + dh)} contiguous fp32 floats")
    lib = _build.library("paged_attention")
    err = lib.repro_paged_decode_partials(
        ops.ptr(q), ops.ptr(pool), ops.ptr(page_table),
        ops.ptr(kv_positions), ops.ptr(q_positions), ops.ptr(out),
        ops.ptr(out[parts:]), ops.ptr(out[2 * parts:]), B, kvs, rep, dh, P,
        n, splits, int(window), s * n, sp * n, ops.dtype_code(q),
        ops.stream(q.device))
    _build.check(err, "paged decode partials launch")
    partial_launches += 1
    return splits


def softmax_combine(parts: torch.Tensor, rows: int, kvs: int, splits: int,
                    rep: int, dh: int, dtype) -> torch.Tensor:
    """Merge the partial-state sets ``parts`` ((sets, numel) fp32, each
    ``ref.partials_numel(rows, kvs, splits, rep, dh)`` floats) of every
    (row, head) into the normalised output (rows, kvs * rep, dh) in
    ``dtype``: one launch on the card."""
    if not ops.on_card(parts):
        return ref.softmax_combine_ref(parts, rows, kvs, splits, rep, dh,
                                       dtype)
    global combine_launches
    sets, numel = parts.shape
    ops.require(parts.dtype == torch.float32 and parts.is_contiguous()
                and numel == ref.partials_numel(rows, kvs, splits, rep, dh)
                and numel < 2 ** 31 and dh in HEAD_DIMS
                and 1 <= rows <= 65535,
                f"combine of {tuple(parts.shape)} as {rows} rows x {kvs} "
                f"kv x {splits} splits x {rep} heads x dh {dh}")
    out = torch.empty((rows, kvs * rep, dh), dtype=dtype,
                      device=parts.device)
    code = ops.dtype_code(out)
    lib = _build.library("paged_attention")
    err = lib.repro_softmax_combine(
        ops.ptr(parts), sets, numel, rows, kvs, rep, dh, splits,
        ops.ptr(out), code, ops.stream(parts.device))
    _build.check(err, "softmax combine launch")
    combine_launches += 1
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
