"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. Griffin pattern: (RG-LRU, RG-LRU, local attention), i.e.
attention:recurrent = 1:2, local window 2048. [arXiv:2402.19427]"""
from repro_torch.configs.base import RGLRU, SLIDING, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=(RGLRU, RGLRU, SLIDING),
    window=2048,
    activation="geglu",
    citation="arXiv:2402.19427",
)
