"""Where a kernel call runs: decided by the tensors' device alone.

There is no backend switch.  A wrapper whose tensors lie on the card
launches its CUDA kernel, and a failed build or launch raises; tensors
on the CPU run the plain version.  Tensors on ``meta`` (the dry run's,
which hold shapes and no data) run the plain version too, which then
only carries shapes through.  Mixed devices, or any other device,
raise.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every one
    is on the CPU (or every one on ``meta``); raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: a kernel call "
                     "takes all CUDA or all CPU tensors")


def require(cond: bool, what: str) -> None:
    """Refuse an input the CUDA kernel does not take (no fallback)."""
    if not cond:
        raise ValueError(what)


def require_tma(*tensors: torch.Tensor) -> None:
    """TMA (the bf16 prefill tile) reads from 16-byte aligned bases."""
    for t in tensors:
        require(t.data_ptr() % 16 == 0, "TMA takes 16-byte aligned tensors")


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


_sms: Dict[int, int] = {}
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, read once per device."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def workspace(device: torch.device, numel: int) -> torch.Tensor:
    """``numel`` fp32 scratch floats for a kernel's split partials, from
    one buffer per (device, current stream) that grows and is reused
    across calls.  Reuse is safe because the calls on one stream run in
    order: a call's kernels finish with the buffer before the next call's
    kernels start."""
    dev = torch.device(device)
    key = (dev.index if dev.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream(dev).cuda_stream)
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(max(numel, 1), dtype=torch.float32, device=dev)
        _workspaces[key] = buf
    return buf[:numel]
