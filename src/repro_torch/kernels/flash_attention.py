"""Flash prefill attention: the CUDA kernel ``csrc/flash_attention.cu``
(replacing the TPU kernel ``repro/kernels/flash_attention.py``) and its
plain version ``ref.flash_attention_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ops, ref

#: kernel launches since the last reset (the card only)
launches = 0
plain = ref.flash_attention_ref

HEAD_DIMS = (64, 128)
TILE_ROWS = 64   # query rows per block: rep must divide it


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, Hq, dh); k, v: (B, S, Hkv, dh), Hq % Hkv == 0; positions
    are 0..S-1 and S may be any length.  Returns (B, S, Hq, dh)."""
    if not ops.on_card(q, k, v):
        return plain(q, k, v, causal=causal, window=window)
    global launches
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    ops.require(tuple(k.shape) == (B, S, Hkv, dh) and k.shape == v.shape
                and Hq % Hkv == 0, f"shapes q {tuple(q.shape)} / k "
                f"{tuple(k.shape)} / v {tuple(v.shape)}")
    ops.require(dh in HEAD_DIMS and TILE_ROWS % rep == 0,
                f"flash attention takes dh in {HEAD_DIMS} and rep "
                f"dividing {TILE_ROWS}")
    ops.check_cuda_inputs(q.dtype, (q, k, v), ())
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    err = lib.repro_flash_attention(
        ops.ptr(q), ops.ptr(k), ops.ptr(v), ops.ptr(out), B, S, Hkv, rep,
        dh, int(causal), int(window), ops.dtype_code(q),
        ops.stream(q.device))
    _build.check(err, "flash attention launch")
    launches += 1
    return out
