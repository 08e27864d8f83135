"""A configuration's weights, made on the device from the run seed.

The benchmark's own copy, in the published layout (each matrix as
``x @ W``: (in, out); ``w_gate`` / ``w_up`` / ``w_down`` apart; no
padding).  The harness loads it into the program's model, and the
reference regenerates it layer by layer after the window: the same seed
gives the same tensors, so both sides compute on the same weights.

Each layer (and the embedding, head and projection, ``static``) is one
``torch.randn`` call into one flat buffer in the served dtype, cut into
views and scaled in place.  Scales keep activations of unit size:
``1/sqrt(fan_in)`` a matrix, except ``wq`` and ``wk`` at ``QK_GAIN``
times that, so the attention scores spread by about ``QK_GAIN**2`` and
the softmax is far from uniform (a dropped key moves the output).  An
RMS norm's weight is ``1 + s`` with ``s`` normal at ``NORM_SPREAD``;
``s`` is what is stored.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

QK_GAIN = 1.5
NORM_SPREAD = 0.1
EMBED_STD = 1.0


def dims(c: Dict) -> Tuple[int, int, int, int, int, int]:
    """(d, Hq, Hkv, dh, ff, vocab) of a configuration file."""
    d, hq = c["hidden_size"], c["num_attention_heads"]
    dh = c.get("head_dim") or d // hq
    return (d, hq, c["num_key_value_heads"], dh, c["intermediate_size"],
            c["vocab_size"])


def _seed(seed: int, tag: str) -> int:
    h = hashlib.sha256(f"weights:{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _draw(parts: Dict[str, Tuple[Tuple[int, ...], float]], seed: int,
          tag: str, device, dtype) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, tag))
    n = sum(math.prod(s) for s, _ in parts.values())
    flat = torch.randn(n, generator=g, device=device, dtype=dtype)
    out, o = {}, 0
    for k, (shape, scale) in parts.items():
        m = math.prod(shape)
        out[k] = flat[o:o + m].view(shape).mul_(scale)
        o += m
    return out


def layer_parts(c: Dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    d, hq, hkv, dh, ff, _ = dims(c)
    return {"ln1": ((d,), NORM_SPREAD),
            "wq": ((d, hq * dh), QK_GAIN / math.sqrt(d)),
            "wk": ((d, hkv * dh), QK_GAIN / math.sqrt(d)),
            "wv": ((d, hkv * dh), 1 / math.sqrt(d)),
            "wo": ((hq * dh, d), 1 / math.sqrt(hq * dh)),
            "ln2": ((d,), NORM_SPREAD),
            "w_gate": ((d, ff), 1 / math.sqrt(d)),
            "w_up": ((d, ff), 1 / math.sqrt(d)),
            "w_down": ((ff, d), 1 / math.sqrt(ff))}


def static_parts(c: Dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    d, _, _, _, _, vocab = dims(c)
    parts = {"embed": ((vocab, d), EMBED_STD),
             "final_ln": ((d,), NORM_SPREAD),
             "head": ((d, vocab), 1 / math.sqrt(d))}
    if c.get("patches"):
        parts["vision_proj"] = ((d, d), 1 / math.sqrt(d))
    return parts


def layer(c: Dict, seed: int, i: int, device, dtype=torch.bfloat16
          ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights (the same tensors for the same seed)."""
    return _draw(layer_parts(c), seed, f"layer{i}", device, dtype)


def static(c: Dict, seed: int, device, dtype=torch.bfloat16
           ) -> Dict[str, torch.Tensor]:
    """The embedding, the final norm, the head and (a vision model) the
    patch projection."""
    return _draw(static_parts(c), seed, "static", device, dtype)
