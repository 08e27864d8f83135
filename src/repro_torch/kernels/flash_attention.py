"""Flash prefill attention: the CUDA kernel ``csrc/flash_attention.cu``
(replacing the TPU kernel ``repro/kernels/flash_attention.py``) and its
plain version ``ref.flash_attention_ref``.

bf16 runs on the tensor-core tile (``csrc/attn_wgmma.cuh``), fp32 on the
CUDA-core tile (``csrc/attn_tile.cuh``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ops, ref

#: kernel launches since the last reset (the card only); of them, those
#: of the bidirectional branch (``causal=False``: an encoder's)
launches = 0
bidirectional_launches = 0
plain = ref.flash_attention_ref

HEAD_DIMS = (64, 96, 128, 160, 256)
#: query heads a kv head, at most: a block's 64 query rows hold at least
#: one token's heads
MAX_REP = 64
#: The tensor-core tile rounds P to bf16 before P.V (the row sum is taken
#: in fp32 before that), so its bf16 output differs from the plain
#: version's by up to one bf16 ulp plus this share of the output row's
#: RMS; ``tests/test_torch_prefill_numerics.py`` sizes it.
BF16_ROW_TOL = 2.0 ** -7


def supports(Hq: int, kvs: int, dh: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernel takes this head shape and dtype: dh in
    ``HEAD_DIMS`` and any ``rep = Hq / kvs`` up to ``MAX_REP`` (a block
    holds ``64 // rep`` tokens; the rows past them are padding)."""
    return (kvs >= 1 and Hq % kvs == 0 and 1 <= Hq // kvs <= MAX_REP
            and dh in HEAD_DIMS
            and dtype in (torch.float32, torch.bfloat16))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, Hq, dh); k, v: (B, S, Hkv, dh), Hq % Hkv == 0; positions
    are 0..S-1 and S may be any length.  ``causal=False`` lets every
    query see every key (an encoder's self-attention; the kernel's keys
    past S are masked by position, not by the causal frontier).
    Returns (B, S, Hq, dh)."""
    if not ops.on_card(q, k, v):
        return plain(q, k, v, causal=causal, window=window)
    global launches, bidirectional_launches
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    ops.require(tuple(k.shape) == (B, S, Hkv, dh) and k.shape == v.shape
                and Hq % Hkv == 0, f"shapes q {tuple(q.shape)} / k "
                f"{tuple(k.shape)} / v {tuple(v.shape)}")
    ops.require(supports(Hq, Hkv, dh, q.dtype),
                f"flash attention takes dh in {HEAD_DIMS} and rep <= "
                f"{MAX_REP} in float32 or bfloat16, not Hq {Hq} / kv "
                f"{Hkv} / dh {dh} in {q.dtype}")
    ops.check_cuda_inputs(q.dtype, (q, k, v), ())
    if q.dtype == torch.bfloat16:
        ops.require_tma(q, k, v)
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    err = lib.repro_flash_attention(
        ops.ptr(q), ops.ptr(k), ops.ptr(v), ops.ptr(out), B, S, Hkv, rep,
        dh, int(causal), int(window), ops.dtype_code(q),
        ops.stream(q.device))
    _build.check(err, "flash attention launch")
    launches += 1
    bidirectional_launches += not causal
    return out
