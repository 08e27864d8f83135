"""KV-cache layouts (paper §4.1, Table 2), on torch tensors.

A layout is the axis order of the page-pool tensor over the logical axes

    block  — page index in the pool
    head   — kv head (after padding/replication: ``kv_slots``)
    kv     — K vs V (size 2)
    token  — slot within a page (``page_tokens``)

with ``head_dim`` always minor-most.  The three layouts the paper
compares:

    raw             [K/V, Block, Token, Header]   (mainstream engines)
    page_friendly   [Block, K/V, Token, Header]   (+ no shift on append)
    header_centric  [Block, Header, K/V, Token]   (+ O(1) trim on transform)

``to_layout`` re-expresses a pool in another layout as a permuted VIEW
(no copy), so writes through the canonical view land in the storage
tensor — the paper's ``permute(*stride_order)`` trick.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

AXES = ("block", "head", "kv", "token")  # head_dim implicit minor-most

LAYOUTS: Dict[str, Tuple[str, ...]] = {
    "raw": ("kv", "block", "token", "head"),
    "page_friendly": ("block", "kv", "token", "head"),
    "header_centric": ("block", "head", "kv", "token"),
}

# canonical order used by the attention math and the CUDA kernels
CANONICAL = "header_centric"


def pool_shape(layout: str, num_pages: int, kv_slots: int, page_tokens: int,
               head_dim: int) -> Tuple[int, ...]:
    sizes = {"block": num_pages, "head": kv_slots, "kv": 2,
             "token": page_tokens}
    return tuple(sizes[a] for a in LAYOUTS[layout]) + (head_dim,)


def kv_stride_order(src: str, dst: str) -> Tuple[int, ...]:
    """Permutation p such that ``pool.permute(*p, 4)`` re-expresses a
    ``src``-layout pool in ``dst`` layout (head_dim stays last)."""
    s, d = LAYOUTS[src], LAYOUTS[dst]
    return tuple(s.index(a) for a in d)


def to_layout(pool: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    if src == dst:
        return pool
    return pool.permute(*kv_stride_order(src, dst), 4)


def block_axis(layout: str) -> int:
    return LAYOUTS[layout].index("block")
