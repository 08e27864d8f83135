"""Model assembly: embedding -> per-layer blocks -> final norm -> head.

The counterpart of ``repro.models.model`` for decoder-only dense models
(ATTN / SLIDING layers).  The reference stacks the layers of each
pattern position and runs them with ``lax.scan``; here layers are a
``ModuleList`` walked by a Python loop, and the decode caches are a list
with one ``PagedState`` per layer, updated in place.

Entry points (methods of ``Model``):
    prefill(tokens, caches)                    -> logits of the last token
    prefill_chunk(tokens, start_pos, caches)   -> logits of the last token
    decode_step(caches, tokens, positions)     -> logits (B, vocab_padded)
    lm_logits(x)
    init_decode_caches(batch, max_seq, page_tokens)
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.padding import PaddingPlan
from repro_torch.models import blocks as B
from repro_torch.models import layers as Lyr
from repro_torch.paged import pool as pp

PAGE_TOKENS = 64  # tokens per KV page (page bytes scale with kv_slots*dh)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _params(d) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v) for k, v in d.items()})


class Block(nn.Module):
    """One decoder layer: ``ln1``, ``ln2``, ``attn`` {wq, wk, wv, wo} and
    ``mlp`` {wi, wo}, named as in the reference's parameter tree."""

    def __init__(self, kind: str, attn, mlp, ln1, ln2):
        super().__init__()
        B.check_kind(kind)
        self.kind = kind
        self.attn = _params(attn)
        self.mlp = _params(mlp)
        self.ln1 = _param(ln1)
        self.ln2 = _param(ln2)

    def __getitem__(self, name):      # the block functions take p["..."]
        return getattr(self, name)


class Model(nn.Module):
    """Inference-only decoder.  Build with ``Model.random`` (weights from
    an explicit ``torch.Generator``, on a given device) or with
    ``Model.empty`` and ``load_state_dict`` (e.g. from
    ``models.convert.params_from_jax``)."""

    def __init__(self, cfg: ModelConfig, plan: PaddingPlan, embed,
                 blocks: List[Block], final_ln, lm_head=None):
        super().__init__()
        if cfg.encoder is not None or cfg.vision is not None:
            raise NotImplementedError(
                "encoder / vision models are not ported yet: ROADMAP "
                "queue 1 item 10")
        self.cfg, self.plan = cfg, plan
        self.embed = _param(embed)
        self.layers = nn.ModuleList(blocks)
        self.final_ln = _param(final_ln)
        self.lm_head = None if lm_head is None else _param(lm_head)

    @classmethod
    def random(cls, cfg: ModelConfig, plan: PaddingPlan,
               gen: torch.Generator, device="cpu") -> "Model":
        """Random weights in the reference's init scheme (padded slots
        zero); ``gen`` must live on ``device``."""
        d, dt = cfg.d_model, B.dtype_of(cfg)
        vmask = (torch.arange(plan.vocab_padded, device=device)
                 < plan.vocab).to(dt)

        def normal(shape):
            return torch.randn(shape, generator=gen, device=device) * 0.02

        embed = normal((plan.vocab_padded, d)).to(dt) * vmask[:, None]
        zeros = torch.zeros((d,), dtype=dt, device=device)
        blocks = [Block(kind, B.init_attention(gen, cfg, plan, device),
                        B.init_mlp(gen, cfg, plan, device), zeros.clone(),
                        zeros.clone())
                  for kind in cfg.pattern]
        head = None
        if not cfg.tie_embeddings:
            head = normal((d, plan.vocab_padded)).to(dt) * vmask[None, :]
        return cls(cfg, plan, embed, blocks, zeros.clone(), head)

    @classmethod
    def empty(cls, cfg: ModelConfig, plan: PaddingPlan, device="cpu"
              ) -> "Model":
        """Uninitialized weights of the right shapes (to be loaded)."""
        d, dh, dt = cfg.d_model, cfg.resolved_head_dim, B.dtype_of(cfg)
        gated = cfg.activation in ("swiglu", "geglu")
        ffp = plan.d_ff_padded

        def e(*shape):
            return torch.empty(shape, dtype=dt, device=device)

        blocks = [Block(kind,
                        {"wq": e(d, plan.q_heads_padded * dh),
                         "wk": e(d, plan.kv_padded * dh),
                         "wv": e(d, plan.kv_padded * dh),
                         "wo": e(plan.q_heads_padded * dh, d)},
                        {"wi": e(d, 2 * ffp if gated else ffp),
                         "wo": e(ffp, d)}, e(d), e(d))
                  for kind in cfg.pattern]
        head = None if cfg.tie_embeddings else e(d, plan.vocab_padded)
        return cls(cfg, plan, e(plan.vocab_padded, d), blocks, e(d), head)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- caches -----------------------------------------------------------
    def init_decode_caches(self, batch: int, max_seq: int,
                           page_tokens: int = PAGE_TOKENS
                           ) -> List[pp.PagedState]:
        """One slot-partitioned header-centric cache per layer."""
        return [B.init_block_cache(blk.kind, self.cfg, self.plan, batch,
                                   max_seq, page_tokens, device=self.device)
                for blk in self.layers]

    # -- head -------------------------------------------------------------
    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        x = Lyr.rmsnorm(x, self.final_ln, self.cfg.norm_eps)
        head = self.embed.T if self.lm_head is None else self.lm_head
        logits = (x @ head).float()
        # the padding plan's extra vocabulary columns never win
        vp = self.plan.vocab_padded
        mask = torch.where(torch.arange(vp, device=x.device)
                           < self.plan.vocab, 0.0, Lyr.NEG_INF)
        return logits + mask

    # -- forward passes ---------------------------------------------------
    def prefill(self, tokens: torch.Tensor, caches: List[pp.PagedState]
                ) -> torch.Tensor:
        """Whole prompt(s) from position 0. tokens: (B, S).  Fills every
        layer's cache (``write_prefill``) and returns the last token's
        logits (B, 1, vocab_padded)."""
        Bt, S = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(Bt, S)
        for blk, cache in zip(self.layers, caches):
            x, (k, v) = B.apply_block_seq(blk.kind, blk, self.cfg, self.plan,
                                          x, positions)
            pp.write_prefill(cache, k, v)
        return self.lm_logits(x[:, -1:, :])

    def prefill_chunk(self, tokens: torch.Tensor, start_pos: torch.Tensor,
                      caches: List[pp.PagedState],
                      first_chunk: bool = False) -> torch.Tensor:
        """ONE page-aligned prefill chunk folded into the caches.
        tokens: (B, S); start_pos: (B,) global position of the chunk's
        first token.  Returns the last token's logits (B, 1, Vp)."""
        S = tokens.shape[1]
        x = self.embed[tokens]
        positions = (start_pos[:, None].to(torch.int32)
                     + torch.arange(S, dtype=torch.int32,
                                    device=tokens.device)[None])
        for blk, cache in zip(self.layers, caches):
            x, _ = B.apply_block_chunk(blk.kind, blk, self.cfg, self.plan,
                                       x, positions, cache,
                                       first_chunk=first_chunk)
        return self.lm_logits(x[:, -1:, :])

    def decode_step(self, caches: List[pp.PagedState],
                    tokens: torch.Tensor, positions: torch.Tensor
                    ) -> torch.Tensor:
        """tokens: (B,) int; positions: (B,) int32 global positions.
        Returns logits (B, vocab_padded)."""
        x = self.embed[tokens][:, None, :]           # (B,1,d)
        pos2 = positions.to(torch.int32)[:, None]
        for blk, cache in zip(self.layers, caches):
            x, _ = B.apply_block_decode(blk.kind, blk, self.cfg, self.plan,
                                        x, pos2, cache)
        return self.lm_logits(x)[:, 0, :]


def build(cfg: ModelConfig, plan: PaddingPlan, seed: int, device="cpu"
          ) -> Model:
    """``Model.random`` from an integer seed, generated on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Model.random(cfg, plan, gen, device)
