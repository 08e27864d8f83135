"""Synthetic data pipeline: deterministic, seekable token streams (the
counterpart of ``repro.training.data``, copied; numpy only).

A real deployment would read tokenized shards; the pipeline below
preserves the important properties (deterministic resume from a step
index, per-host sharding, document packing with EOS separators) while
synthesizing structured data (integer Markov chains) so smoke-training
has learnable signal and the loss demonstrably decreases."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2              # markov order (learnable structure)


class SyntheticStream:
    """Markov-chain token stream; batch(i) is a pure function of (seed, i)
    so training can resume from any step without replaying."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rnd = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse-ish transition structure: each context maps to a small
        # plausible next-token set
        self.n_ctx = min(4096, v * 4)
        self.table = rnd.integers(0, v, size=(self.n_ctx, 8))
        self.mix = rnd.random(self.n_ctx)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rnd = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len + 1
        toks = np.zeros((B, S), np.int32)
        toks[:, 0] = rnd.integers(0, cfg.vocab_size, size=B)
        ctx = toks[:, 0].copy()
        for t in range(1, S):
            idx = ctx % self.n_ctx
            choice = rnd.integers(0, 8, size=B)
            nxt = self.table[idx, choice]
            noise = rnd.random(B) < 0.05
            nxt = np.where(noise,
                           rnd.integers(0, cfg.vocab_size, size=B), nxt)
            toks[:, t] = nxt
            ctx = nxt  # order-1 chain: learnable bigram structure
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1
