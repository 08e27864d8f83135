"""LR schedules, including WSD (Warmup-Stable-Decay) as used by MiniCPM
[arXiv:2404.06395]: the counterpart of ``repro.training.schedule``.

Each schedule is a function from an integer step to a Python float.  It
computes in float32, as the reference's ``jnp`` form does, so both give
the optimizer the same rate."""
from __future__ import annotations

from typing import Callable

import numpy as np

f32 = np.float32


def wsd(peak_lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.1) -> Callable[[int], float]:
    """MiniCPM WSD: linear warmup -> constant -> exponential-ish decay."""
    def fn(step: int) -> float:
        s, w, st, d = f32(step), f32(warmup), f32(stable), f32(decay)
        if s < w:
            return float(f32(peak_lr) * s / max(w, f32(1.0)))
        if s < w + st:
            return float(f32(peak_lr))
        t = np.clip((s - w - st) / max(d, f32(1.0)), f32(0.0), f32(1.0))
        return float(f32(peak_lr) * f32(final_frac) ** t)
    return fn


def cosine(peak_lr: float, warmup: int, total: int,
           final_frac: float = 0.1) -> Callable[[int], float]:
    def fn(step: int) -> float:
        s, w = f32(step), f32(warmup)
        if s < w:
            return float(f32(peak_lr) * s / max(w, f32(1.0)))
        t = np.clip((s - w) / max(f32(total) - w, f32(1.0)), f32(0.0),
                    f32(1.0))
        return float(f32(peak_lr) * (
            f32(final_frac) + f32((1 - final_frac) * 0.5)
            * (f32(1.0) + np.cos(f32(np.pi) * t))))
    return fn
