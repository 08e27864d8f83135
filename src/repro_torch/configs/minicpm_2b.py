"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753. Llama-like arch; trained with the WSD schedule (implemented in
repro.training.schedule). [arXiv:2404.06395]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    arch_type="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    activation="swiglu",
    tie_embeddings=True,
    citation="arXiv:2404.06395",
)
