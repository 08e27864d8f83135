"""The yardstick's peaks and operation and byte counts.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the card's
full 700 W; a card set below that runs slower, so every reading is
printed beside the card's power limit).  The kernel counts are those of
the program's kernel checks (``chip_smoke.py``: ``bound_ms``,
``case_decode``, ``case_chunk``, ``case_flash``), frozen here: each
input byte read once and each output byte written once, for the work
these inputs need (the visible query-key pairs).
"""
from __future__ import annotations

from typing import Dict

HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the type's peak."""
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype])


def flash(B: int, S: int, hq: int, hkv: int, dh: int, elt: int = 2
          ) -> Dict[str, float]:
    """Kernel 3, causal, no window: q, k, v read once, out written once;
    ``4 * pairs * Hq * dh`` operations (QK^T and PV, two each a
    multiply-add) over the ``S (S + 1) / 2`` visible pairs a row."""
    pairs = B * S * (S + 1) // 2
    nbytes = elt * B * S * dh * (2 * hq + 2 * hkv)
    return {"bytes": nbytes, "flops": 4 * pairs * hq * dh}


def chunk(S: int, live_prefix: int, hq: int, hkv: int, dh: int,
          attend_prefix: bool, n_kv_positions: int, elt: int = 2
          ) -> Dict[str, float]:
    """Kernel 2, one row of ``S`` chunk tokens after ``live_prefix``
    cached keys (all visible): the prefix's keys and values read once,
    q, k, v and the positions read, out written, the chunk's keys and
    values scattered into the pool; pairs ``S * prefix + S (S + 1) / 2``."""
    prefix = live_prefix if attend_prefix else 0
    pairs = S * prefix + S * (S + 1) // 2
    nbytes = (prefix * hkv * 2 * dh * elt
              + elt * S * dh * (2 * hq + 2 * hkv) + 4 * S
              + (4 * n_kv_positions if attend_prefix else 0)
              + S * hkv * 2 * dh * elt)
    return {"bytes": nbytes, "flops": 4 * pairs * hq * dh}


def decode(B: int, pairs: int, hq: int, hkv: int, dh: int, n_pages: int,
           n_kv_positions: int, elt: int = 2) -> Dict[str, float]:
    """Kernel 1, ``B`` rows with ``pairs`` visible (row, key) pairs in
    all: each visible key's K and V read once a key head, q read, out
    written, the positions and the page table read."""
    nbytes = (pairs * hkv * 2 * dh * elt + 2 * B * hq * dh * elt
              + 4 * B * n_kv_positions + 4 * B + 4 * B * n_pages)
    return {"bytes": nbytes, "flops": 4 * pairs * hq * dh}


def linear_params(c: Dict) -> int:
    """Weights a token multiplies in one layer: q, k, v, o and the gated
    MLP's three matrices."""
    d, hq = c["hidden_size"], c["num_attention_heads"]
    dh = c.get("head_dim") or d // hq
    hkv, ff = c["num_key_value_heads"], c["intermediate_size"]
    return d * dh * (2 * hq + 2 * hkv) + 3 * d * ff


def token_flops(c: Dict, pos: int, head: bool) -> float:
    """Model operations of the token at position ``pos`` (0-based): two a
    weight in every layer, attention over its ``pos + 1`` visible keys
    (``4 * keys * Hq * dh`` a layer), and the head (``2 d V``) where a
    token is sampled from it."""
    d, hq = c["hidden_size"], c["num_attention_heads"]
    dh = c.get("head_dim") or d // hq
    L = c["num_hidden_layers"]
    f = L * (2 * linear_params(c) + 4 * (pos + 1) * hq * dh)
    return f + (2 * d * c["vocab_size"] if head else 0)


def prefill_flops(c: Dict, n_patches: int, n_text: int) -> float:
    """A whole prompt: every position's layers, the patch projection
    (``2 d^2`` a patch) and the head once, for the first token."""
    n = n_patches + n_text
    d, hq = c["hidden_size"], c["num_attention_heads"]
    dh = c.get("head_dim") or d // hq
    L = c["num_hidden_layers"]
    attn = 4 * hq * dh * L * n * (n + 1) // 2
    return (n * L * 2 * linear_params(c) + attn + 2 * d * d * n_patches
            + 2 * d * c["vocab_size"])
