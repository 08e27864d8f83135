"""Configuration system for the Gyges reproduction framework.

Every assigned architecture gets a ``ModelConfig`` in its own module under
``repro_torch.configs``; the registry maps ``--arch <id>`` to it.  Configs are
plain frozen dataclasses so they hash, print, and diff cleanly, and every
config knows how to produce a *reduced* smoke-test variant of the same
family (2 layers, d_model<=512, <=4 experts) as required by the task.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds used by the layer-pattern machinery (hybrid / ssm archs).
# ---------------------------------------------------------------------------
ATTN = "attn"          # full (causal) attention + dense MLP
SLIDING = "sliding"    # sliding-window attention + dense MLP
MOE = "moe"            # full attention + MoE MLP
RGLRU = "rglru"        # RG-LRU recurrent block + MLP (recurrentgemma)
MLSTM = "mlstm"        # mLSTM block (xlstm)
SLSTM = "slstm"        # sLSTM block (xlstm)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor for dispatch (tokens per expert = tokens/experts * cf)
    capacity_factor: float = 1.25
    # llama4-style always-on shared expert alongside the routed ones
    shared_expert: bool = False


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). The modality frontend
    (mel + conv) is a STUB: input_specs() provides frame embeddings."""
    num_layers: int
    num_frames: int  # sequence length of (precomputed) frame embeddings


@dataclass(frozen=True)
class VisionConfig:
    """Vision frontend stub for VLMs: input_specs() provides patch
    embeddings of shape (batch, num_patches, d_model)."""
    num_patches: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    citation: str = ""

    # attention flavor: "full" | "sliding". Hybrid archs instead use
    # layer_pattern below.
    attention: str = "full"
    window: int = 4096           # sliding-window size when attention=="sliding"

    # Repeating per-layer block pattern (hybrid / ssm archs). Empty tuple
    # means a homogeneous stack of `attention` blocks.
    layer_pattern: Tuple[str, ...] = ()

    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None

    # activation: "swiglu" (llama-style) | "geglu" (gemma) | "gelu"
    activation: str = "swiglu"
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # --- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def pattern(self) -> Tuple[str, ...]:
        """The per-layer pattern, tiled/truncated to exactly num_layers."""
        if not self.layer_pattern:
            if self.moe is not None:
                kind = MOE
            else:
                kind = SLIDING if self.attention == "sliding" else ATTN
            return (kind,) * self.num_layers
        reps = -(-self.num_layers // len(self.layer_pattern))
        return (self.layer_pattern * reps)[: self.num_layers]

    @property
    def sub_quadratic(self) -> bool:
        """True when decoding with 500k context does not need a 500k-token
        full-attention KV cache: every block is recurrent or windowed."""
        return all(kind in (SLIDING, RGLRU, MLSTM, SLSTM) for kind in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (pre-padding)."""
        d, dh = self.d_model, self.resolved_head_dim
        qkv = d * (self.num_heads * dh) + 2 * d * (self.num_kv_heads * dh)
        attn = qkv + (self.num_heads * dh) * d
        n_gates = 3 if self.activation in ("swiglu", "geglu") else 2
        mlp = n_gates * d * self.d_ff
        total = 0
        for kind in self.pattern:
            if kind in (ATTN, SLIDING):
                total += attn + mlp + 2 * d
            elif kind == MOE:
                assert self.moe is not None
                experts = self.moe.num_experts * mlp
                shared = mlp if self.moe.shared_expert else 0
                router = d * self.moe.num_experts
                total += attn + experts + shared + router + 2 * d
            elif kind == RGLRU:
                # rg-lru block: in/out proj (2*d*d) + gates (2*d) + mlp
                total += 2 * d * d + 2 * d + mlp + 2 * d
            elif kind == MLSTM:
                # q,k,v projections at 2x up dim + out + gates
                up = 2 * d
                total += 3 * d * up + up * d + 3 * up + d
            elif kind == SLSTM:
                total += 4 * d * d + 4 * d + d
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        if self.encoder is not None:
            enc_layer = attn + mlp + 2 * d
            total += self.encoder.num_layers * enc_layer
            # decoder cross-attention per layer
            total += self.num_layers * attn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        n_gates = 3 if self.activation in ("swiglu", "geglu") else 2
        mlp = n_gates * d * self.d_ff
        n_moe_layers = sum(1 for k in self.pattern if k == MOE)
        inactive = n_moe_layers * (self.moe.num_experts - self.moe.top_k) * mlp
        return self.param_count() - inactive

    # --- smoke variant ------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        head_dim = 64 if self.head_dim else 0
        pat = self.pattern[:2] if self.layer_pattern else ()
        moe = None
        if self.moe is not None:
            # high capacity factor -> no token drops, so smoke tests can
            # check prefill/decode against the full forward exactly
            moe = MoEConfig(num_experts=min(4, self.moe.num_experts),
                            top_k=min(2, self.moe.top_k),
                            capacity_factor=8.0,
                            shared_expert=self.moe.shared_expert)
        enc = None
        if self.encoder is not None:
            enc = EncoderConfig(num_layers=2, num_frames=16)
        vis = None
        if self.vision is not None:
            vis = VisionConfig(num_patches=8)
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 64),
            layer_pattern=pat,
            moe=moe,
            encoder=enc,
            vision=vis,
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def smoke_shape(kind: str) -> ShapeConfig:
    if kind == "train":
        return ShapeConfig("train_smoke", 32, 2, "train")
    if kind == "prefill":
        return ShapeConfig("prefill_smoke", 32, 2, "prefill")
    return ShapeConfig("decode_smoke", 64, 2, "decode")
