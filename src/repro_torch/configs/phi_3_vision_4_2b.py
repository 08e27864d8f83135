"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064. phi3-mini backbone + CLIP vision frontend (STUB: input_specs
provides patch embeddings). [hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    vision=VisionConfig(num_patches=576),
    activation="swiglu",
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
)
