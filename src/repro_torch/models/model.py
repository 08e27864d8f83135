"""Model assembly: embedding -> per-layer blocks -> final norm -> head.

The counterpart of ``repro.models.model`` for models of
ATTN / SLIDING / MOE / RGLRU / MLSTM / SLSTM layers (a pattern unit
such as ``(ATTN, MOE)``, Griffin's ``(RGLRU, RGLRU, SLIDING)`` or
xLSTM[7:1]'s seven MLSTM and one SLSTM tiles over the depth, and the
remainder layers of a depth the unit does not divide follow:
recurrentgemma's 38 = 12 * 3 + 2).  The reference stacks the layers of
each pattern position and runs them with ``lax.scan``; here layers are
a ``ModuleList`` walked by a Python loop, and the decode caches are a
list with one state per layer, updated in place: a ``PagedState`` for an
attention layer, a ``RecState`` for a recurrent one.

Two frontends, both stub inputs as in the reference's configs:

* a vision model (phi-3-vision) projects patch embeddings (``patches``,
  (B, P, d)) with ``vision_proj`` and puts them before the prompt's
  tokens (``embed_inputs``): positions 0..P+S-1 over the joined
  sequence;
* an encoder-decoder (whisper) runs frame embeddings (``frames``, (B, F,
  d)) through ``frame_proj`` and an ``Encoder`` of ATTN blocks whose
  attention is bidirectional (``run_encoder``: the flash kernel with
  ``causal=False``), turns the output into each decoder layer group's
  cross-attention keys and values (``encode_cross_kv``), held in a
  dense ``CrossKV`` cache whose batch axis is the slot, and ends each
  decoder group with a cross-attention sub-layer over them, after the
  whole block, MLP included, as the reference's group body does.
  Neither side of the cross-attention gets rope.

Such models prefill whole prompts only (the reference's
``prefill_chunk`` refuses them: their memory is not causal).

Training (``forward_train``) runs the whole sequence through autograd:
attention is the plain ``layers.chunked_attention`` (the kernels have
no backward), a recurrent mixer its functional form from a fresh state
(``blocks.apply_block_train``), each block under activation
checkpointing by default.  A model's weights take gradients once the
caller turns them on (``model.requires_grad_(True)``); they are built
without, for serving.

Entry points (methods of ``Model``):
    forward_train(tokens, frames=None, patches=None, remat=True)
                                               -> (logits, aux)
    prefill(tokens, caches, frames=None, patches=None, cross=None)
                                               -> logits of the last token
    prefill_chunk(tokens, start_pos, caches)   -> logits of the last token
    decode_step(caches, tokens, positions, cross=None)
                                               -> logits (B, vocab_padded)
    lm_logits(x)
    init_decode_caches(batch, max_seq, page_tokens)
    init_cross_cache(batch)
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, MLSTM, MOE, RGLRU, SLSTM,
                                      ModelConfig)
from repro_torch.core import instance as I
from repro_torch.core.padding import PaddingPlan
from repro_torch.launch.mesh import Layout
from repro_torch.models import blocks as B
from repro_torch.models import layers as Lyr
from repro_torch.paged import pool as pp
from repro_torch.paged.recurrent import RecState

PAGE_TOKENS = 64  # tokens per KV page (page bytes scale with kv_slots*dh)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _params(d) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v) for k, v in d.items()})


class Block(nn.Module):
    """One decoder layer: ``ln1``, ``ln2``, its mixer and ``mlp``, named
    as in the reference's parameter tree.  The mixer of an attention
    layer is ``attn`` {wq, wk, wv, wo}; that of a recurrent layer
    ``rec`` (the reference keeps these at the layer's top level): RGLRU
    {w_in, conv_w, conv_b, w_gx, w_ga, a_param, w_out}, MLSTM {wq, wk,
    wv, w_if, w_og, w_out}, SLSTM {w_zifo, r_diag, w_out}.  ``mlp``:
    {wi, wo} dense, or for a MOE layer {router (d, Ep), wi (Ep, d,
    2*ffp), wo (Ep, ffp, d)} and, with a shared expert, ``shared_wi`` /
    ``shared_wo`` (the reference's ``shared/wi``, ``shared/wo``).  An
    MLSTM or SLSTM layer has no MLP: one norm ``ln`` before its mixer,
    and ``mlp`` / ``ln2`` are None."""

    def __init__(self, kind: str, mixer, mlp, ln1, ln2=None):
        super().__init__()
        B.check_kind(kind)
        self.kind = kind
        if kind in B.RECURRENT_KINDS:
            self.rec = _params(mixer)
        else:
            self.attn = _params(mixer)
        if B.has_mlp(kind):
            self.mlp = _params(mlp)
            self.ln1 = _param(ln1)
            self.ln2 = _param(ln2)
        else:
            self.ln = _param(ln1)
            self.mlp = self.ln2 = None

    @property
    def mixer(self) -> nn.ParameterDict:
        """The mixer's weights: ``rec`` or ``attn``."""
        return self.rec if self.kind in B.RECURRENT_KINDS else self.attn

    @property
    def norm(self) -> nn.Parameter:
        """The norm before the mixer: ``ln1``, or ``ln`` without an
        MLP."""
        return self.ln1 if B.has_mlp(self.kind) else self.ln

    def parts(self) -> Tuple:
        """``(kind, norm, ln2, mixer, mlp)`` as plain dicts (None where
        the layer has no MLP): what ``core.instance.place_replicas``
        spreads over workers."""
        return (self.kind, self.norm, self.ln2, dict(self.mixer),
                None if self.mlp is None else dict(self.mlp))

    def __getitem__(self, name):      # the block functions take p["..."]
        return getattr(self, name)


class Encoder(nn.Module):
    """An encoder-decoder's encoder, the reference's
    ``params["encoder"]``: ``frame_proj`` (d, d), ATTN ``Block``s whose
    attention is bidirectional, and ``final_ln``."""

    def __init__(self, frame_proj, blocks: List[Block], final_ln):
        super().__init__()
        self.frame_proj = _param(frame_proj)
        self.layers = nn.ModuleList(blocks)
        self.final_ln = _param(final_ln)

    def tree(self) -> Dict:
        """The weights as plain dicts and lists (what ``run_encoder``
        reads and ``core.instance.place_replicas`` copies)."""
        return tree_of(dict(self.named_parameters()))


def tree_of(named: Dict[str, torch.Tensor]) -> Dict:
    """Dotted parameter names -> the nested dicts they name, a run of
    numeric parts ``0..n-1`` a list: ``Encoder.tree`` from its
    ``named_parameters``, or from a worker's gathered leaves."""
    root: Dict = {}
    for name, t in named.items():
        *path, last = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[last] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def cross_after(cfg: ModelConfig) -> Dict[int, int]:
    """Decoder layer index -> cross-attention group: an encoder-decoder
    ends each repetition of its pattern unit with group g's
    cross-attention (the reference's ``group_body``); remainder layers
    have none.  Empty without an encoder."""
    if cfg.encoder is None:
        return {}
    u = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    return {(g + 1) * u - 1: g for g in range(cfg.num_layers // u)}


class CrossKV:
    """An encoder-decoder's cross-attention memory: each decoder group's
    keys ``k[g]`` and values ``v[g]``, (B, F, kv_slots, dh), dense and
    not paged; the batch axis is the slot.  A request's prefill writes
    its slot whole (``write_``), every decode step reads all of it."""

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor]):
        self.k, self.v = k, v

    @classmethod
    def make(cls, cfg: ModelConfig, plan: PaddingPlan, batch: int, *,
             device, tp: int = 1) -> "CrossKV":
        """Zeros for ``batch`` slots; at TP ``tp`` a worker's memory holds
        its own kv slots, ``kv_slots / tp`` of them."""
        shape = (batch, cfg.encoder.num_frames, plan.kv_slots // tp,
                 cfg.resolved_head_dim)
        n = len(cross_after(cfg))

        def zeros():
            return [torch.zeros(shape, dtype=B.dtype_of(cfg), device=device)
                    for _ in range(n)]

        return cls(zeros(), zeros())

    def slot(self, i: int) -> "CrossKV":
        """Batch-1 in-place views of slot ``i``."""
        return CrossKV([k[i:i + 1] for k in self.k],
                       [v[i:i + 1] for v in self.v])

    def write_(self, ks: List[torch.Tensor], vs: List[torch.Tensor]
               ) -> None:
        for dst, src in zip(self.k + self.v, ks + vs):
            dst.copy_(src)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.k + self.v)


class Model(nn.Module):
    """The decoder, with a vision model's ``vision_proj`` or
    an encoder-decoder's ``encoder`` and per-group ``cross`` weights
    ({ln_x, wq, wk, wv, wo}) where its config has them.  Build with
    ``Model.random`` (weights from an explicit ``torch.Generator``, on a
    given device) or with ``Model.empty`` and ``load_state_dict`` (e.g.
    from ``models.convert.params_from_jax``)."""

    def __init__(self, cfg: ModelConfig, plan: PaddingPlan, embed,
                 blocks: List[Block], final_ln, lm_head=None,
                 vision_proj=None, encoder: Optional[Encoder] = None,
                 cross: Optional[List[Dict]] = None):
        super().__init__()
        if (cfg.vision is None) != (vision_proj is None):
            raise ValueError(f"{cfg.name}: vision_proj is given exactly "
                             "when the config has a vision frontend")
        if (cfg.encoder is None) != (encoder is None) \
                or (encoder is None) != (cross is None):
            raise ValueError(f"{cfg.name}: encoder and cross are given "
                             "exactly when the config has an encoder")
        self.cfg, self.plan = cfg, plan
        self.embed = _param(embed)
        self.layers = nn.ModuleList(blocks)
        self.final_ln = _param(final_ln)
        self.lm_head = None if lm_head is None else _param(lm_head)
        self.vision_proj = (None if vision_proj is None
                            else _param(vision_proj))
        self.encoder = encoder
        self.cross = (None if cross is None
                      else nn.ModuleList(_params(c) for c in cross))

    @classmethod
    def random(cls, cfg: ModelConfig, plan: PaddingPlan,
               gen: torch.Generator, *, device) -> "Model":
        """Random weights in the reference's init scheme (padded slots
        zero); ``gen`` must live on ``device``."""
        d, dt = cfg.d_model, B.dtype_of(cfg)
        vmask = (torch.arange(plan.vocab_padded, device=device)
                 < plan.vocab).to(dt)

        def normal(shape):
            return torch.randn(shape, generator=gen, device=device) * 0.02

        embed = normal((plan.vocab_padded, d)).to(dt) * vmask[:, None]
        zeros = torch.zeros((d,), dtype=dt, device=device)

        def mlp(kind):
            if not B.has_mlp(kind):
                return None
            if kind == MOE:
                return B.init_moe_mlp(gen, cfg, plan, device)
            return B.init_mlp(gen, cfg, plan, device)

        def mixer(kind):
            if kind == RGLRU:
                return B.init_rglru(gen, cfg, device)
            if kind == MLSTM:
                return B.init_mlstm(gen, cfg, device)
            if kind == SLSTM:
                return B.init_slstm(gen, cfg, device)
            return B.init_attention(gen, cfg, plan, device)

        blocks = [Block(kind, mixer(kind), mlp(kind), zeros.clone(),
                        zeros.clone() if B.has_mlp(kind) else None)
                  for kind in cfg.pattern]
        head = None
        if not cfg.tie_embeddings:
            head = normal((d, plan.vocab_padded)).to(dt) * vmask[None, :]
        vision = encoder = cross = None
        if cfg.vision is not None:
            vision = B._dense(gen, d, (d, d), dt, device)
        if cfg.encoder is not None:
            frame_proj = B._dense(gen, d, (d, d), dt, device)
            enc = [Block(ATTN, mixer(ATTN), mlp(ATTN), zeros.clone(),
                         zeros.clone())
                   for _ in range(cfg.encoder.num_layers)]
            encoder = Encoder(frame_proj, enc, zeros.clone())
            cross = [B.init_cross(gen, cfg, plan, device)
                     for _ in cross_after(cfg)]
        return cls(cfg, plan, embed, blocks, zeros.clone(), head, vision,
                   encoder, cross)

    @classmethod
    def empty(cls, cfg: ModelConfig, plan: PaddingPlan, *, device
              ) -> "Model":
        """Uninitialized weights of the right shapes (to be loaded)."""
        d, dh, dt = cfg.d_model, cfg.resolved_head_dim, B.dtype_of(cfg)
        gated = cfg.activation in ("swiglu", "geglu")
        ffp = plan.d_ff_padded
        ncol = 2 * ffp if gated else ffp

        def e(*shape):
            return torch.empty(shape, dtype=dt, device=device)

        def mlp(kind):
            if not B.has_mlp(kind):
                return None
            if kind != MOE:
                return {"wi": e(d, ncol), "wo": e(ffp, d)}
            Ep = plan.experts_padded
            out = {"router": e(d, Ep), "wi": e(Ep, d, ncol),
                   "wo": e(Ep, ffp, d)}
            if cfg.moe.shared_expert:
                out.update(shared_wi=e(d, ncol), shared_wo=e(ffp, d))
            return out

        def mixer(kind):
            if kind == RGLRU:
                return {"w_in": e(d, 2 * d), "conv_w": e(B.CONV_K, d),
                        "conv_b": e(d), "w_gx": e(d, d), "w_ga": e(d, d),
                        "a_param": torch.empty((d,), dtype=torch.float32,
                                               device=device),
                        "w_out": e(d, d)}
            if kind == MLSTM:
                up, H = 2 * d, cfg.num_heads
                return {"wq": e(d, up), "wk": e(d, up), "wv": e(d, up),
                        "w_if": e(d, 2 * H), "w_og": e(d, up),
                        "w_out": e(up, d)}
            if kind == SLSTM:
                return {"w_zifo": e(d, 4 * d), "r_diag": e(4, d),
                        "w_out": e(d, d)}
            return {"wq": e(d, plan.q_heads_padded * dh),
                    "wk": e(d, plan.kv_padded * dh),
                    "wv": e(d, plan.kv_padded * dh),
                    "wo": e(plan.q_heads_padded * dh, d)}

        blocks = [Block(kind, mixer(kind), mlp(kind), e(d),
                        e(d) if B.has_mlp(kind) else None)
                  for kind in cfg.pattern]
        head = None if cfg.tie_embeddings else e(d, plan.vocab_padded)
        vision = None if cfg.vision is None else e(d, d)
        encoder = cross = None
        if cfg.encoder is not None:
            encoder = Encoder(e(d, d), [
                Block(ATTN, mixer(ATTN), mlp(ATTN), e(d), e(d))
                for _ in range(cfg.encoder.num_layers)], e(d))
            cross = [{"ln_x": e(d), **mixer(ATTN)}
                     for _ in cross_after(cfg)]
        return cls(cfg, plan, e(plan.vocab_padded, d), blocks, e(d), head,
                   vision, encoder, cross)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- caches -----------------------------------------------------------
    def init_decode_caches(self, batch: int, max_seq: int,
                           page_tokens: int = PAGE_TOKENS,
                           layout: str = "header_centric") -> List:
        """One slot-partitioned cache per attention layer, its pool
        stored in ``layout`` (``paged.layout``; default header-centric),
        one fresh ``RecState`` per recurrent layer."""
        return [B.init_block_cache(blk.kind, self.cfg, self.plan, batch,
                                   max_seq, page_tokens, device=self.device,
                                   layout=layout)
                for blk in self.layers]

    def init_cross_cache(self, batch: int) -> Optional[CrossKV]:
        """An encoder-decoder's cross-attention memory of ``batch``
        slots (None for other models)."""
        if self.cfg.encoder is None:
            return None
        return CrossKV.make(self.cfg, self.plan, batch, device=self.device)

    # -- head -------------------------------------------------------------
    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        return lm_logits({"embed": self.embed, "final_ln": self.final_ln,
                          "lm_head": self.lm_head}, self.plan, self.cfg, x)

    def static(self) -> Dict:
        """The non-layer weights: embed, final_ln and lm_head (None when
        tied to the embedding); a vision model's ``vision_proj``; an
        encoder-decoder's ``encoder`` (``Encoder.tree``) and ``cross``
        (one dict a group)."""
        out = {"embed": self.embed, "final_ln": self.final_ln,
               "lm_head": self.lm_head}
        if self.vision_proj is not None:
            out["vision_proj"] = self.vision_proj
        if self.encoder is not None:
            out["encoder"] = self.encoder.tree()
            out["cross"] = [dict(c) for c in self.cross]
        return out

    # -- forward passes ---------------------------------------------------
    def forward_train(self, tokens: torch.Tensor,
                      frames: Optional[torch.Tensor] = None,
                      patches: Optional[torch.Tensor] = None,
                      remat: bool = True, banded: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole-sequence forward of training, the reference's
        ``forward_train``: tokens (B, S) from position 0, after a
        vision model's projected ``patches`` (B, P, d) when given; an
        encoder-decoder's ``frames`` (B, F, d) run through the encoder
        and each group's cross-attention follows its last layer.  No
        cache is read or written.  ``remat``: each block under
        activation checkpointing (its activations recomputed in the
        backward pass).  ``banded``: a windowed layer's attention
        computes only its band (``layers.banded_attention``) where the
        reference's does.  Recurrent scans run in blocks of
        ``PAGE_TOKENS`` tokens, as an engine's whole-prompt prefill with
        pages of that size does.  Returns (logits (B, P+S,
        vocab_padded) fp32, the MoE layers' summed load-balance loss,
        an fp32 scalar)."""
        cfg, plan = self.cfg, self.plan
        st = self.static()
        x, positions = embed_inputs(st, cfg, tokens, patches)
        after = cross_after(cfg)
        if after:
            if frames is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder's "
                                 "forward takes frames")
            mem_k, mem_v = encode_cross_kv(
                st["cross"], cfg, plan,
                run_encoder(st["encoder"], cfg, plan, frames, train=True))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, blk in enumerate(self.layers):
            fn = partial(B.apply_block_train, blk.kind, blk, cfg, plan,
                         positions=positions, block=PAGE_TOKENS,
                         banded=banded)
            x, a = (checkpoint(fn, x, use_reentrant=False) if remat
                    else fn(x))
            if a is not None:
                aux = aux + a
            if i in after:
                g = after[i]
                x = x + B.cross_attention(st["cross"][g], x, cfg, plan,
                                          mem_k[g], mem_v[g])
        return self.lm_logits(x), aux

    def prefill(self, tokens: torch.Tensor, caches: List,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None,
                cross: Optional[CrossKV] = None) -> torch.Tensor:
        """Whole prompt(s) from position 0. tokens: (B, S); a vision
        model's optional ``patches`` (B, P, d) go first (positions
        0..P+S-1); an encoder-decoder's ``frames`` (B, F, d) run through
        the encoder into ``cross`` (written in place), which the decoder
        then reads.  Fills every layer's cache (``write_prefill``; a
        recurrent layer's final state) and returns the last token's
        logits (B, 1, vocab_padded)."""
        cfg, plan = self.cfg, self.plan
        st = self.static()
        x, positions = embed_inputs(st, cfg, tokens, patches)
        if cfg.encoder is not None:
            if frames is None or cross is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder's "
                                 "prefill takes frames and a cross cache")
            cross.write_(*encode_cross_kv(
                st["cross"], cfg, plan,
                run_encoder(st["encoder"], cfg, plan, frames)))
        after = cross_after(cfg)
        for i, (blk, cache) in enumerate(zip(self.layers, caches)):
            x, kv = B.apply_block_seq(blk.kind, blk, cfg, plan, x,
                                      positions, cache)
            if kv is not None:
                pp.write_prefill(cache, *kv)
            if i in after:
                x = _cross(st["cross"][after[i]], cfg, plan, x, cross,
                           after[i])
        return self.lm_logits(x[:, -1:, :])

    def prefill_chunk(self, tokens: torch.Tensor, start_pos: torch.Tensor,
                      caches: List,
                      first_chunk: bool = False) -> torch.Tensor:
        """ONE page-aligned prefill chunk folded into the caches.
        tokens: (B, S); start_pos: (B,) global position of the chunk's
        first token.  Returns the last token's logits (B, 1, Vp).
        Encoder and vision models do not chunk (their memory is not
        causal), as in the reference."""
        if self.cfg.has_frontend:
            raise NotImplementedError(
                "chunked prefill covers causal decoder-only models")
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

    def decode_step(self, caches: List,
                    tokens: torch.Tensor, positions: torch.Tensor,
                    cross: Optional[CrossKV] = None) -> torch.Tensor:
        """tokens: (B,) int; positions: (B,) int32 global positions; an
        encoder-decoder's ``cross``: the batch's cross-attention memory.
        Returns logits (B, vocab_padded)."""
        cfg, plan = self.cfg, self.plan
        after = cross_after(cfg)
        if after and cross is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder's decode "
                             "step reads a cross cache")
        x = self.embed[tokens][:, None, :]           # (B,1,d)
        pos2 = positions.to(torch.int32)[:, None]
        for i, (blk, cache) in enumerate(zip(self.layers, caches)):
            x, _ = B.apply_block_decode(blk.kind, blk, cfg, plan, x, pos2,
                                        cache)
            if i in after:
                x = _cross(self.cross[after[i]], cfg, plan, x, cross,
                           after[i])
        return self.lm_logits(x)[:, 0, :]


def embed_inputs(static: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                 patches: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x (B, P+S, d), positions (B, P+S)): the tokens' embeddings,
    after a vision model's projected ``patches`` (B, P, d) when given
    (cast to the model's dtype first, as the reference casts them)."""
    x = with_patches(static["embed"][tokens], cfg, patches,
                     static.get("vision_proj"))
    Bt, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(Bt, S)
    return x, positions


def with_patches(x: torch.Tensor, cfg: ModelConfig,
                 patches: Optional[torch.Tensor],
                 vision_proj: Optional[torch.Tensor]) -> torch.Tensor:
    """The token embeddings x (B, S, d) after the projected ``patches``
    (B, P, d), cast to x's dtype first as the reference casts them; x
    itself without patches."""
    if patches is None:
        return x
    if cfg.vision is None:
        raise ValueError(f"{cfg.name} has no vision frontend: no patches")
    return torch.cat([patches.to(x.dtype) @ vision_proj, x], dim=1)


def run_encoder(enc: Dict, cfg: ModelConfig, plan: PaddingPlan,
                frames: torch.Tensor, train: bool = False) -> torch.Tensor:
    """The encoder over frame embeddings (B, F, d): ``frame_proj``, then
    each block's bidirectional self-attention (rope at positions
    0..F-1; the flash kernel's non-causal branch on the card, the plain
    ``chunked_attention`` in training: ``train``) and MLP, then
    ``final_ln``.  Returns (B, F, d)."""
    return run_encoder_workers([enc], cfg, plan, [frames], None, 1,
                               train)[0]


def run_encoder_workers(encs: List[Dict], cfg: ModelConfig,
                        plan: PaddingPlan, frames: List[Optional[torch.Tensor]],
                        mesh, tp: int, train: bool = False
                        ) -> List[Optional[torch.Tensor]]:
    """``run_encoder`` over the workers of ``mesh`` at TP ``tp`` (encs:
    each worker's encoder tree; frames: its rows, None where it holds
    none): every worker of a TP group projects the frames
    (``frame_proj`` replicated), runs its heads' bidirectional attention
    and its columns of the ungated MLP (its shards of the encoder,
    ``core.instance.shard_static``), and the group sums each sub-layer's
    partial outputs before the residual, as the decoder's sub-layers
    do.  Returns each worker's encoder output (R_w, F, d)."""
    eps = cfg.norm_eps
    xs = [None if f is None
          else f.to(B.dtype_of(cfg)) @ encs[w]["frame_proj"]
          for w, f in enumerate(frames)]
    poss = [None if x is None
            else torch.arange(x.shape[1], dtype=torch.int32,
                              device=x.device)[None].expand(x.shape[:2])
            for x in xs]

    def attn(p, h, pos):
        if train:
            return B.attention_train(p, h, cfg, plan, pos, causal=False)
        return B.attention_seq(p, h, cfg, plan, pos, causal=False)[0]

    for i in range(len(encs[0]["layers"])):
        ps = [e["layers"][i] for e in encs]
        outs = [None if x is None
                else attn(ps[w]["attn"], Lyr.rmsnorm(x, ps[w]["ln1"], eps),
                          poss[w]) for w, x in enumerate(xs)]
        xs = _residual(xs, outs, tp, mesh)
        outs = [None if x is None else B.apply_mlp(
            ps[w]["mlp"], Lyr.rmsnorm(x, ps[w]["ln2"], eps), cfg)
            for w, x in enumerate(xs)]
        xs = _residual(xs, outs, tp, mesh)
    return [None if x is None else Lyr.rmsnorm(x, e["final_ln"], eps)
            for x, e in zip(xs, encs)]


def encode_cross_kv(cross: List[Dict], cfg: ModelConfig, plan: PaddingPlan,
                    enc_out: torch.Tensor
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each decoder group's cross-attention keys and values from the
    encoder's output: two lists of (B, F, kv_slots, dh); a worker's TP
    shards of the groups' weights give its own kv slots."""
    kv = [B.cross_kv(p, enc_out, cfg, plan) for p in cross]
    return [k for k, _ in kv], [v for _, v in kv]


def _cross(p: Dict, cfg: ModelConfig, plan: PaddingPlan,
           x: torch.Tensor, cross: CrossKV, g: int) -> torch.Tensor:
    """x plus group g's cross-attention (weights ``p``) over
    ``cross``."""
    return x + B.cross_attention(p, x, cfg, plan, cross.k[g], cross.v[g])


def lm_logits(static: Dict[str, torch.Tensor], plan: PaddingPlan,
              cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head; the padding plan's extra vocabulary columns
    never win."""
    x = Lyr.rmsnorm(x, static["final_ln"], cfg.norm_eps)
    head = (static["embed"].T if static["lm_head"] is None
            else static["lm_head"])
    logits = (x @ head).float()
    return logits + vocab_mask(plan, 0, plan.vocab_padded, x.device)


def vocab_mask(plan: PaddingPlan, lo: int, n: int, device) -> torch.Tensor:
    """(n,) fp32: 0 on head columns lo..lo+n-1 that are real vocabulary,
    -inf on the plan's padding columns (they never win)."""
    col = torch.arange(lo, lo + n, device=device)
    return torch.where(col < plan.vocab, 0.0, Lyr.NEG_INF)


def build(cfg: ModelConfig, plan: PaddingPlan, seed: int, *, device
          ) -> Model:
    """``Model.random`` from an integer seed, generated on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Model.random(cfg, plan, gen, device=device)


# ---------------------------------------------------------------------------
# Per-worker layer walks (an engine spread over W workers)
# ---------------------------------------------------------------------------
#
# The counterpart of the reference's per-layer paths
# (``repro.models.model.decode_step_layers`` / ``prefill_chunk_layers``).
# Each layer's attention and MLP sit at a layout ``(sp, tp)`` of
# ``core.instance`` (an int is a TP degree) on the layer's assembly of
# workers (``WorkerLayer.mesh``) and, mid-transform, layers (and the two
# halves of a layer) may sit at different layouts, and layers on
# different assemblies (a merge or a split).  Activations of a row set
# (the decode batch, or one prefilling slot) follow the placement of the
# sub-layer about to run: every worker of replica r holds the rows of
# the replica's slots (the degree ``sp * tp`` sets the replicas).  At a
# degree or assembly boundary a worker whose own rows cover its new ones
# keeps a slice of them; the others receive the rows joined once from
# one worker of each source replica.  This is the counterpart of
# ``_boundary_put``.  A sub-layer at tp > 1 ends in an all-reduce-sum of
# the partial outputs inside each TP group, after the attention ``wo``
# and after the MLP ``wo``: groups hold different slots, or are other
# sp shards of the same slots, so their partial products never mix.
# Attention at sp > 1 runs over the whole assembly at once
# (``blocks.attention_decode_sp`` / ``attention_chunk_sp``: partial
# states exchanged and combined inside each sp group); a whole prompt
# runs the flash kernel on every shard, which writes its own pages.


def place_workers(model: "Model", mesh, lay: Layout, batch: int,
                  max_seq: int, page_tokens: int, share: bool = True
                  ) -> Tuple[List["I.WorkerLayer"], List[Dict],
                             Optional[List[CrossKV]]]:
    """``model`` (planned for the workers' padding plan, its MLP in that
    plan's Eq. 2 layout) laid out over ``mesh``'s workers at the pure-TP
    layout ``lay``, with empty caches of ``batch`` slots of ``max_seq``
    tokens: ``(layers, static, cross)``, what ``walk_layers`` takes
    (``cross``: an encoder-decoder's memory, one ``CrossKV`` a worker
    for its replica's slots and its own kv slots, else None).  At TP1 x
    W every worker holds a replica (``core.instance.place_replicas``;
    ``share``: worker 0 takes the model's tensors), at TP > 1 its tp
    position's shards (``core.instance.place_at``).  How the dry run
    places a configuration, and how an encoder-decoder, which never
    changes degree live, runs at TP > 1."""
    cfg, plan = model.cfg, model.plan

    def cache_of(kind, rows, dev):
        return B.init_block_cache(kind, cfg, plan, rows, max_seq,
                                  page_tokens, device=dev)

    layers, static = I.place_replicas(
        [b.parts() for b in model.layers], model.static(), mesh, share,
        batch, cache_of)
    if lay.tp > 1:
        static = I.place_at(layers, static, lay, plan, batch, cache_of)
    cross = None if cfg.encoder is None else [
        CrossKV.make(cfg, plan, batch // (mesh.W // lay.tp), device=dev,
                     tp=lay.tp) for dev in mesh.devices]
    return layers, static, cross


class RowSet:
    """Global slots ``rows`` (sorted) of a ``batch``-slot engine;
    ``span(layout, W, w)`` is the index range into ``rows`` that worker
    w of a W-worker assembly holds at ``layout`` (its replica's
    slots)."""

    def __init__(self, rows: Sequence[int], batch: int):
        self.rows, self.batch = list(rows), batch

    def span(self, lay: Layout, W: int, w: int) -> Tuple[int, int]:
        lo, hi = I.rows_of(lay, self.batch, W, w)
        idx = [i for i, r in enumerate(self.rows) if lo <= r < hi]
        return (idx[0], idx[-1] + 1) if idx else (0, 0)

    def views(self, layer: "I.WorkerLayer", w: int):
        """Worker w's cache for these rows: the whole cache for the full
        batch, else a batch-1 in-place view of the one slot (None when
        worker w holds none of the rows); a recurrent layer's state
        rows alike."""
        return self.view_of(layer.cache[w], layer.attn_layout,
                            layer.mesh.W, w)

    def view_of(self, cache, lay: Layout, W: int, w: int):
        """``views`` of worker w's ``cache`` (anything with
        ``slot(i)``: a pool, a recurrent state, a ``CrossKV``) holding
        its replica's slots at ``lay`` on a W-worker assembly."""
        lo, hi = self.span(lay, W, w)
        if hi == lo:
            return None
        if len(self.rows) == self.batch:
            return cache
        assert len(self.rows) == 1, "row sets are one slot or the batch"
        return cache.slot(self.rows[0] - I.rows_of(lay, self.batch, W, w)[0])


def relayout(xs: List[torch.Tensor], src: Tuple, dst: Tuple,
             rows: RowSet) -> List[torch.Tensor]:
    """Move a row set's activations from placement ``src`` to ``dst``, a
    placement being ``(layout, mesh)``: a worker of both whose rows
    cover its new ones slices its own tensor; every other worker
    receives its rows from the rows joined once (one worker of each
    source replica, in slot order).  Two layouts of one degree on the
    same workers place the rows alike."""
    (ts, ms), (td, md) = src, dst
    ds = ts.degree
    if ds == td.degree and ms.same_workers(md):
        return xs
    out, full = [], None
    for w, wk in enumerate(md.workers):
        lo, hi = rows.span(td, md.W, w)
        if wk in ms.workers:
            u = ms.workers.index(wk)
            a, b = rows.span(ts, ms.W, u)
            if a <= lo and hi <= b:
                out.append(xs[u][lo - a:hi - a])
                continue
        if full is None:
            dev = ms.devices[0]
            full = torch.cat([xs[g].to(dev) for g in range(0, ms.W, ds)])
        out.append(full[lo:hi].to(wk.device, copy=True))
    return out


def walk_layers(layers: List["I.WorkerLayer"], static: List[Dict],
                cfg: ModelConfig, plan: PaddingPlan, static_mesh,
                rows: RowSet, tokens: torch.Tensor, positions: torch.Tensor,
                mode: str, first_chunk: bool = False,
                on_layer: Optional[Callable[[int], None]] = None,
                caches: Optional[List[pp.PagedState]] = None,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None,
                cross: Optional[List[CrossKV]] = None) -> torch.Tensor:
    """One forward pass of a row set over per-worker layers.

    ``static``: the embedding, final norm and head (and a vision or
    encoder-decoder model's frontend weights, ``Model.static``), one
    dict a worker of ``static_mesh``.  tokens: (R, S), positions: (R,
    P+S) for the R rows (host tensors).  ``mode``: ``decode`` (S = 1:
    append at the cursor, paged decode kernel), ``seq`` (a whole prompt
    from position 0: flash kernel, then the cache fill) or ``chunk``
    (the chunk-prefill kernel with its scatter); at sp > 1 each through
    its sharded form.  ``on_layer(i)`` runs after layer i has been
    issued (the transform session's hook).  ``caches``: one batch-1
    state a layer that replaces the worker's view of a one-row set (a
    spilled slot's extended view, the layers at TP1).  The MLP replicas
    are in the Eq. 2 layout of ``plan.max_tp`` shards (an ungated MLP's
    shards are contiguous column blocks of its own layout: the
    reference's split).  A vision model's ``seq`` rows take their
    ``patches`` (R, P, d) first; an encoder-decoder's ``seq`` rows run
    their ``frames`` (R, F, d) through the encoder on the workers that
    hold them (``run_encoder_workers``: by heads and MLP columns over
    each TP group), into those workers' ``cross`` memory (one
    ``CrossKV`` a worker: its replica's slots, its own kv slots), which
    every group's cross-attention reads on each worker's heads before
    the group's all-reduce.  An encoder-decoder's layers, encoder and
    cross weights all sit at one pure-TP layout on the static workers
    (``core.instance.place_at``): it never changes degree live.
    Returns the last token's logits (R, vocab_padded) on
    ``static_mesh``'s worker 0."""
    eps = cfg.norm_eps
    S = plan.max_tp

    def part(x: torch.Tensor, lay: Layout, mesh, w: int) -> torch.Tensor:
        return x[slice(*rows.span(lay, mesh.W, w))].to(mesh.devices[w])

    # the embedding runs where the first layer's attention does, or on
    # every static worker (one group) when that is another assembly
    static_tp = Layout(1, static_mesh.W)
    first = (layers[0].attn_layout, layers[0].mesh) if layers else (
        static_tp, static_mesh)
    here = (first[0] if static_mesh.same_workers(first[1])
            else static_tp, static_mesh)
    xs = [embed_inputs(static[w], cfg, part(tokens, here[0], static_mesh, w),
                       None if patches is None
                       else part(patches, here[0], static_mesh, w))[0]
          for w in range(static_mesh.W)]
    after = cross_after(cfg)
    mems: List[Optional[CrossKV]] = []
    if after:
        # the frontend and the cross memory live with each TP group's own
        # slots, at the one layout of every layer, on the static workers
        lay0 = here[0]
        assert lay0.sp == 1 and all(
            l.attn_layout == lay0 and l.mlp_layout == lay0
            and l.mesh.same_workers(static_mesh) for l in layers), (
            "an encoder-decoder's layers sit at one TP layout")
        mems = [rows.view_of(cross[w], lay0, static_mesh.W, w)
                for w in range(static_mesh.W)]
        if mode == "seq":
            encs = run_encoder_workers(
                [st["encoder"] for st in static], cfg, plan,
                [None if mem is None else part(frames, lay0, static_mesh, w)
                 for w, mem in enumerate(mems)], static_mesh, lay0.tp)
            for w, mem in enumerate(mems):
                if mem is not None:
                    mem.write_(*encode_cross_kv(static[w]["cross"], cfg,
                                                plan, encs[w]))
    for i, layer in enumerate(layers):
        window = B._window_of(layer.kind, cfg)
        mesh = layer.mesh
        xs = relayout(xs, here, (layer.attn_layout, mesh), rows)
        here = (layer.attn_layout, mesh)
        lay = layer.attn_layout
        views = [rows.views(layer, w) for w in range(mesh.W)]
        if caches is not None:
            views = [None if v is None else caches[i] for v in views]
        hs = [None if v is None else Lyr.rmsnorm(xs[w], layer.ln1[w], eps)
              for w, v in enumerate(views)]
        poss = [None if v is None else part(positions, lay, mesh, w)
                for w, v in enumerate(views)]
        if layer.kind in B.RECURRENT_KINDS:
            outs = rec_workers(layer, hs, views, mode, mesh)
        elif lay.sp > 1 and mode == "decode":
            outs = B.attention_decode_sp(layer.attn, hs, cfg, plan, poss,
                                         views, lay, mesh, window=window)
        elif lay.sp > 1 and mode == "chunk":
            outs = B.attention_chunk_sp(layer.attn, hs, cfg, plan, poss,
                                        views, lay, mesh, window=window,
                                        first_chunk=first_chunk)
        else:
            outs = []
            for w, cache in enumerate(views):
                if cache is None:
                    outs.append(None)
                    continue
                h, pos, p = hs[w], poss[w], layer.attn[w]
                if mode == "decode":
                    o, _ = B.attention_decode(p, h, cfg, plan, pos, cache,
                                              window=window)
                elif mode == "seq":
                    o, (k, v) = B.attention_seq(p, h, cfg, plan, pos,
                                                window=window)
                    pp.write_prefill(cache, k, v,
                                     shard=I.shard_of(lay, w))
                else:
                    o, _ = B.attention_chunk(p, h, cfg, plan, pos, cache,
                                             window=window,
                                             first_chunk=first_chunk)
                outs.append(o)
        xs = _residual(xs, outs, lay.tp, mesh)
        if layer.has_mlp:
            xs = relayout(xs, here, (layer.mlp_layout, mesh), rows)
            here = (layer.mlp_layout, mesh)
            tp, ff = I.mlp_shards(layer.mlp_layout.tp, S, cfg.d_ff)
            hs = [None if x.shape[0] == 0
                  else Lyr.rmsnorm(x, layer.ln2[w], eps)
                  for w, x in enumerate(xs)]
            if layer.kind == MOE:
                outs = moe_workers(layer, hs, cfg, plan, tp, ff)
            elif cfg.activation in ("swiglu", "geglu"):
                outs = [None if h is None
                        else B.apply_padded_mlp(layer.mlp[w], h, cfg, tp, ff)
                        for w, h in enumerate(hs)]
            else:
                # an ungated MLP: plain products over each worker's
                # column block (the padded FFN kernel is gated only, as
                # the reference's is)
                outs = [None if h is None
                        else B.apply_mlp(layer.mlp[w], h, cfg)
                        for w, h in enumerate(hs)]
            xs = _residual(xs, outs, layer.mlp_layout.tp, mesh)
        if i in after:
            g = after[i]
            outs = [None if mem is None
                    else B.cross_attention(static[w]["cross"][g], x, cfg,
                                           plan, mem.k[g], mem.v[g])
                    for w, (x, mem) in enumerate(zip(xs, mems))]
            xs = _residual(xs, outs, here[0].tp, mesh)
        if on_layer is not None:
            on_layer(i)
    if not here[1].same_workers(static_mesh):
        xs = relayout(xs, here, (static_tp, static_mesh), rows)
        here = (static_tp, static_mesh)
    # the head runs on one worker of each replica, over its rows
    dev0 = static_mesh.devices[0]
    parts = [lm_logits(static[w], plan, cfg, xs[w][:, -1:])[:, 0].to(dev0)
             for w in range(0, static_mesh.W, here[0].degree)
             if xs[w].shape[0]]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def moe_workers(layer: "I.WorkerLayer", hs: List[Optional[torch.Tensor]],
                cfg: ModelConfig, plan: PaddingPlan, tp: int, ff: int
                ) -> List[Optional[torch.Tensor]]:
    """A MoE layer's MLP on every worker of its assembly (hs: each
    worker's normed rows (R_w, S, d), None where it holds none), routed
    as the reference routes the call: every row of the row set together,
    in global slot order.  One worker of each replica routes its rows;
    their choices are gathered onto every worker that holds rows (the
    all-gather of ``(rows, top_k)`` expert ids), which counts the buffer
    positions over the whole call and runs the experts for its own rows
    only, with the replica's weights and choices (every worker of a TP
    group uses the same ones).  The shared expert runs the padded FFN
    kernel over its ``(tp, ff)`` shard.  Returns the partial outputs
    (before the TP all-reduce)."""
    mesh, lay = layer.mesh, layer.mlp_layout
    d = cfg.d_model
    first = [w for w in range(0, mesh.W, lay.degree) if hs[w] is not None]
    routes = {w: B.moe_route(layer.mlp[w]["router"], hs[w].reshape(-1, d),
                             cfg, plan) for w in first}
    offs, n = {}, 0
    for w in first:
        offs[w] = n
        n += routes[w][1].shape[0]
    cap = B.moe_capacity(n, cfg)
    outs: List[Optional[torch.Tensor]] = []
    for w, h in enumerate(hs):
        if h is None:
            outs.append(None)
            continue
        dev, r = mesh.devices[w], w - w % lay.degree
        topv, topi = (t.to(dev) for t in routes[r])
        every = torch.cat([routes[u][1].to(dev) for u in first])
        pos, keep = B.moe_positions(every, layer.mlp[w]["wi"].shape[0], cap)
        mine = slice(offs[r], offs[r] + topi.shape[0])
        y = B.moe_experts(layer.mlp[w], h.reshape(-1, d), topv, topi,
                          pos[mine], keep[mine], cap, cfg.activation)
        y = y.reshape(h.shape)
        if "shared_wi" in layer.mlp[w]:
            y = y + B.apply_padded_mlp(
                {"wi": layer.mlp[w]["shared_wi"],
                 "wo": layer.mlp[w]["shared_wo"]}, h, cfg, tp, ff)
        outs.append(y)
    return outs


def rec_workers(layer: "I.WorkerLayer", hs: List[Optional[torch.Tensor]],
                views: List[Optional[RecState]], mode: str, mesh
                ) -> List[Optional[torch.Tensor]]:
    """A recurrent layer's mixer on every worker of its assembly (hs:
    each worker's normed rows, None where it holds none; views: their
    state rows, updated in place).  Each worker multiplies by its column
    shards of the input weights (``blocks.rec_project``: RGLRU's
    ``w_in``, MLSTM's ``wq`` / ``wk`` / ``wv``, SLSTM's ``w_zifo``), the
    TP group all-gathers the products, and every worker of the group
    runs the whole cell on them (RGLRU's conv, gates and scan; the
    mLSTM or sLSTM recurrence over every head), so its own copy of the
    state stays equal to its peers'; each then takes its own columns of
    the cell's output (gated by its ``w_og`` shard in an mLSTM) times its
    ``w_out`` row shard.  Returns the partial outputs (before the TP
    all-reduce)."""
    lay = layer.attn_layout
    us = [None if v is None else B.rec_project(layer.kind, layer.attn[w],
                                               hs[w])
          for w, v in enumerate(views)]
    if lay.tp > 1:
        us = mesh.group_all_gather(us, lay.tp, dim=-1)
    return [None if v is None
            else B.rec_mix(layer.kind, layer.attn[w], us[w], hs[w], v, mode,
                           part=(w % lay.tp, lay.tp))
            for w, v in enumerate(views)]


def _residual(xs, outs, tp: int, mesh) -> List[torch.Tensor]:
    """x + sub-layer output; at tp > 1 the partial outputs are summed
    inside each TP group first."""
    if tp > 1:
        outs = mesh.all_reduce_sum(outs, tp)
    return [x if o is None else x + o for x, o in zip(xs, outs)]
