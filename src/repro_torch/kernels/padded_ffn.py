"""Gated FFN over parallelism-padded weights: the CUDA kernel
``csrc/padded_ffn.cu`` (replacing the TPU kernel
``repro/kernels/padded_ffn.py``) and its plain version
``ref.padded_ffn_ref``.

The weights carry the per-shard layout of paper Eq. 2: each of the
``tp`` shards of the ``ffp`` columns holds ``ff/tp`` real columns and a
zero tail, and only real columns are visited.  Unlike the TPU kernel,
any token count ``T`` is taken (the ragged edge is masked).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ops, ref

#: kernel launches since the last reset (the card only; one per call,
#: counting its gate/up and down launches as one)
launches = 0
plain = ref.padded_ffn_ref

ACTIVATIONS = {"swiglu": 0, "geglu": 1, "gelu": 2}


def padded_ffn(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, *,
               tp: int, ff: int, activation: str = "swiglu"
               ) -> torch.Tensor:
    """x: (T, d); wi: (d, 2*ffp) fused [gate | up]; wo: (ffp, d); ``ff``
    is the real d_ff and ``tp`` the number of padded shards.  Returns
    (T, d) in x's type."""
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
    err = _build.library("padded_ffn").repro_padded_ffn(
        ops.ptr(x), ops.ptr(wi), ops.ptr(wo), ops.ptr(h), ops.ptr(out), T, d,
        ff, ffp, tp, ACTIVATIONS[activation], ops.dtype_code(x),
        ops.stream(x.device))
    _build.check(err, "padded_ffn launch")
    launches += 1
    return out
