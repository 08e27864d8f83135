"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

Note: the assignment line reads "MoE 40e top-8 — 32 experts top-8"; we take
the structured field (40 experts, top-8) and record the ambiguity here.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(num_experts=40, top_k=8),
    activation="swiglu",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
