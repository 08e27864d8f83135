"""Where a kernel call runs: decided by the tensors' device alone.

There is no backend switch.  A wrapper whose tensors lie on the card
launches its CUDA kernel, and a failed build or launch raises; tensors
on the CPU run the plain version.  Mixed devices, or any other device,
raise.
"""
from __future__ import annotations

import ctypes

import torch


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every one
    is on the CPU; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: a kernel call "
                     "takes all CUDA or all CPU tensors")


def require(cond: bool, what: str) -> None:
    """Refuse an input the CUDA kernel does not take (no fallback)."""
    if not cond:
        raise ValueError(what)


def dtype_code(t: torch.Tensor) -> int:
    """The C entry points' dtype code (0 = float32, 1 = bfloat16)."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    require(t.dtype in codes, f"CUDA kernels take float32 or bfloat16, "
            f"not {t.dtype}")
    return codes[t.dtype]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_cuda_inputs(dtype: torch.dtype, floats, ints) -> None:
    """Contiguity and types of a kernel's tensor arguments."""
    for t in floats:
        require(t.dtype == dtype, f"mixed float dtypes {t.dtype} / {dtype}")
        require(t.is_contiguous(), "CUDA kernels take contiguous tensors")
    for t in ints:
        require(t.dtype == torch.int32, f"index tensors must be int32, "
                f"not {t.dtype}")
        require(t.is_contiguous(), "CUDA kernels take contiguous tensors")
