"""Gated FFN over parallelism-padded weights: the CUDA kernel
``csrc/padded_ffn.cu`` (replacing the TPU kernel
``repro/kernels/padded_ffn.py``) and its plain version
``ref.padded_ffn_ref``.

The weights carry the per-shard layout of paper Eq. 2: each of the
``tp`` shards of the ``ffp`` columns holds ``ff/tp`` real columns and a
zero tail, and only real columns are visited.  Unlike the TPU kernel,
any token count ``T`` is taken (the ragged edge is masked).

bf16 runs on the tensor cores by the plan ``plan`` makes here on the
host: the decode tiling (one warpgroup of 64 weight columns a block,
tokens padded to 8-64, K split so about two blocks an SM stream the
weights) up to ``DECODE_MAX_T`` tokens, the prefill tiling (128 weight
columns a block, 128 or 256 tokens) above.  The plan is the kernel's
only tiling: every field of it is passed to the C entry point, which
checks that its tiles cover the problem and walks them as given.
``weight_boxes`` lists the TMA boxes that walk reads, which the CPU
tests hold against the real columns of every config's padding plan.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build, ops, ref

#: kernel launches since the last reset (the card only; one per call,
#: counting its gate/up and down launches as one)
launches = 0
plain = ref.padded_ffn_ref

ACTIVATIONS = {"swiglu": 0, "geglu": 1, "gelu": 2}
BM = 64        # weight columns of a warpgroup (the wgmma M side)
BK = 64        # K rows of a box (one 128-byte swizzled row)
#: the largest token count the decode tiling takes.  On an H100 80GB
#: HBM3 (700 W) at llama3-8b's full replica the decode tiling was 6-19%
#: faster at T <= 32, within 2% of the prefill tiling at 33-56 tokens
#: and 3-50% slower from 64 to 512 (``chip_smoke.py``'s ffn-tilings
#: line checks and times both; PERF.md has the numbers)
DECODE_MAX_T = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the bf16 kernel cuts one call: ``decode`` picks the tiling,
    ``wgs`` warpgroups of 64 weight columns share a token tile of
    ``nt_up`` / ``nt_down`` tokens, each product's K is cut into
    ``split_up`` / ``split_down`` splits (1: none), and ``workspace`` is
    the fp32 partials the splits need.  Every field but ``decode`` and
    ``workspace`` goes to the C entry point, which walks it as given."""
    decode: bool
    wgs: int
    nt_up: int
    nt_down: int
    col_tiles_up: int      # column tiles a shard (gate/up)
    col_tiles_down: int    # column tiles of d (down)
    k_tiles_up: int        # 64-deep K tiles of d
    kts: int               # 64-deep K tiles a shard (down)
    split_up: int
    split_down: int
    workspace: int


def plan(T: int, d: int, ff: int, tp: int, sms: int, gated: bool = True,
         decode: Optional[bool] = None) -> Plan:
    """The bf16 kernel's plan for ``T`` tokens on a card of ``sms`` SMs:
    the decode tiling if ``decode`` (by default ``T <= DECODE_MAX_T``),
    else the prefill tiling."""
    decode = T <= DECODE_MAX_T if decode is None else decode
    ffs = ff // tp
    wgs = 1 if decode else 2
    nt = next(n for n in (8, 16, 32, 64) if T <= n or n == 64)
    nt_up, nt_down = (nt, nt) if decode else (128, 256)
    ctu, ctd = _cdiv(ffs, wgs * BM), _cdiv(d, wgs * BM)
    ktu, kts = _cdiv(d, BK), _cdiv(ffs, BK)

    def split(blocks: int, k_tiles: int) -> int:
        # decode: about two blocks an SM, each split at least 4 K tiles
        # deep; prefill (one block an SM): split only a grid that would
        # leave SMs idle, each split at least 8 K tiles deep
        if decode:
            return max(1, min(_cdiv(2 * sms, blocks), k_tiles // 4))
        return max(1, min(sms // blocks, k_tiles // 8))

    su = split(tp * ctu * _cdiv(T, nt_up), ktu)
    sd = split(ctd * _cdiv(T, nt_down), tp * kts)
    nb = 2 if gated else 1
    ws = max(su * nb * T * ff if su > 1 else 0,
             sd * T * d if sd > 1 else 0)
    return Plan(decode, wgs, nt_up, nt_down, ctu, ctd, ktu, kts, su, sd, ws)


def weight_boxes(p: Plan, tp: int, ff: int, ffp: int
                 ) -> Tuple[List[range], List[range]]:
    """The padded weight columns each TMA box of the kernel reads: the
    gate (or up) columns of every (shard, column tile, warpgroup) box of
    the gate/up product, and the ``wo`` rows of every (shard, K tile)
    box of the down product.  A box is cut at its shard's real width
    ``ff/tp`` (the tensor maps' extent; TMA fills the rest with zeros),
    so it never reads a padding column."""
    ffs, per = ff // tp, ffp // tp
    up = []
    for tile in range(tp * p.col_tiles_up):
        shard, c0 = divmod(tile, p.col_tiles_up)
        for w in range(p.wgs):
            c = c0 * p.wgs * BM + w * BM
            up.append(range(shard * per + min(c, ffs),
                            shard * per + min(c + BM, ffs)))
    down = []
    for kt in range(tp * p.kts):
        shard, k = divmod(kt, p.kts)
        down.append(range(shard * per + k * BK,
                          shard * per + min((k + 1) * BK, ffs)))
    return up, down


def padded_ffn(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, *,
               tp: int, ff: int, activation: str = "swiglu",
               decode: Optional[bool] = None) -> torch.Tensor:
    """x: (T, d); wi: (d, 2*ffp) fused [gate | up]; wo: (ffp, d); ``ff``
    is the real d_ff and ``tp`` the number of padded shards.  Returns
    (T, d) in x's type.  ``decode`` forces the bf16 kernel's decode
    (True) or prefill (False) tiling; by default ``plan`` picks it by
    ``T``."""
    if not ops.on_card(x, wi, wo):
        return plain(x, wi, wo, tp, ff, activation)
    global launches
    T, d = x.shape
    ffp = wi.shape[1] // 2
    vec = 16 // x.element_size()
    ops.require(tuple(wi.shape) == (d, 2 * ffp)
                and tuple(wo.shape) == (ffp, d),
                f"shapes x {tuple(x.shape)} / wi {tuple(wi.shape)} / wo "
                f"{tuple(wo.shape)}")
    ops.require(activation in ACTIVATIONS, f"activation {activation!r}")
    ops.require(T >= 1 and ff % tp == 0 and ffp % tp == 0
                and ff // tp <= ffp // tp and (ff // tp) % vec == 0
                and (ffp // tp) % vec == 0 and d % vec == 0,
                f"padded FFN takes ff/tp, ffp/tp and d in multiples of "
                f"{vec} (ff {ff}, ffp {ffp}, tp {tp}, d {d})")
    ops.check_cuda_inputs(x.dtype, (x, wi, wo), ())
    h = torch.empty((T, ff), dtype=x.dtype, device=x.device)
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    tiles, part = (0,) * 9, None    # fp32 takes no plan
    if x.dtype == torch.bfloat16:   # the tensor-core kernel reads by TMA
        ops.require_tma(x, wi, wo, h)
        p = plan(T, d, ff, tp, ops.sm_count(x.device),
                 gated=activation != "gelu", decode=decode)
        tiles = (p.wgs, p.nt_up, p.nt_down, p.col_tiles_up,
                 p.col_tiles_down, p.k_tiles_up, p.kts, p.split_up,
                 p.split_down)
        if p.workspace:
            part = ops.workspace(x.device, p.workspace)
    err = _build.library("padded_ffn").repro_padded_ffn(
        ops.ptr(x), ops.ptr(wi), ops.ptr(wo), ops.ptr(h), ops.ptr(out),
        ops.ptr(part) if part is not None else None, T, d, ff, ffp, tp,
        ACTIVATIONS[activation], ops.dtype_code(x), *tiles,
        ops.stream(x.device))
    _build.check(err, "padded_ffn launch")
    launches += 1
    return out
