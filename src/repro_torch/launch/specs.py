"""Shape stand-ins for every (architecture x input shape) combination:
the counterpart of ``repro.launch.specs``.

``model_inputs`` gives the model inputs as ``torch.empty`` tensors on
``meta``; ``param_specs``, ``opt_specs`` and ``cache_specs`` build the
weights, the AdamW moments and the decode caches on ``meta`` too, so
the dry run never allocates a byte (the reference's ``jax.eval_shape``).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.padding import PaddingPlan
from repro_torch.models.model import PAGE_TOKENS, Model
from repro_torch.training.optimizer import adamw

META = torch.device("meta")


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic variant for long_500k on full-attention archs:
    sliding-window attention (window 4096).  Recorded per run; SSM and
    hybrid archs run natively; whisper is skipped."""
    if cfg.sub_quadratic:
        return cfg
    lp = tuple("sliding" if k == "attn" else k for k in cfg.layer_pattern)
    return replace(cfg, attention="sliding", window=4096, layer_pattern=lp)


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k":
        if cfg.encoder is not None:
            return False, ("enc-dec audio decoder with 500k generated "
                           "tokens is semantically void and full-attention"
                           " (skip recorded)")
        return True, ("native sub-quadratic" if cfg.sub_quadratic
                      else "sliding-window variant (window=4096)")
    return True, ""


def model_inputs(cfg: ModelConfig, shape: ShapeConfig,
                 dtype: torch.dtype = torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """The inputs of one step of ``shape`` on ``meta``: a train step's
    ``tokens`` (B, S+1), a prefill's (B, S) (a vision model's patches
    taking the first positions of S), a decode's ``tokens`` and
    ``positions`` (B,); ``patches`` / ``frames`` where the model has a
    frontend."""
    B, S = shape.global_batch, shape.seq_len

    def e(*s, dt=torch.int32):
        return torch.empty(s, dtype=dt, device=META)

    if shape.kind == "decode":
        return {"tokens": e(B), "positions": e(B)}
    out = {"tokens": e(B, S + 1) if shape.kind == "train" else e(B, S)}
    if cfg.vision is not None:
        P = cfg.vision.num_patches
        if shape.kind == "prefill":
            out["tokens"] = e(B, S - P)
        out["patches"] = e(B, P, cfg.d_model, dt=dtype)
    if cfg.encoder is not None:
        out["frames"] = e(B, cfg.encoder.num_frames, cfg.d_model, dt=dtype)
    return out


def param_specs(cfg: ModelConfig, plan: PaddingPlan) -> Model:
    """The model on ``meta``: every weight's shape and dtype, nothing
    allocated."""
    return Model.empty(cfg, plan, device=META)


def opt_specs(params: Dict[str, torch.Tensor]):
    """AdamW's state for ``params`` (name -> tensor) on their device."""
    opt_init, _ = adamw(1e-3)
    return opt_init(params)


def cache_specs(cfg: ModelConfig, plan: PaddingPlan, shape: ShapeConfig,
                page_tokens: int = PAGE_TOKENS) -> Dict[str, Any]:
    """The decode caches of ``shape`` on ``meta``: one state a layer
    (``layers``) and an encoder-decoder's cross memory (``cross``)."""
    model = param_specs(cfg, plan)
    return {"layers": model.init_decode_caches(
                shape.global_batch, shape.seq_len, page_tokens),
            "cross": model.init_cross_cache(shape.global_batch)}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()

