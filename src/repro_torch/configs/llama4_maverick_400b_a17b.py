"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, vocab=202048, MoE 128 experts top-1. Early-fusion multimodal in
the original; assignment specifies the language backbone.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ATTN, MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, shared_expert=True),
    layer_pattern=(ATTN, MOE),  # interleave_moe_layer_step=2 (maverick)
    activation="swiglu",
    rope_theta=500_000.0,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
