"""qwen2.5-32b — the paper's own evaluation model (Table 1/4, §3.1):
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, BF16 = 62.34 GB.
Used by the cost-model calibration and the Table-3 misalignment benchmark.
[paper §6.1, Table 4]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    activation="swiglu",
    rope_theta=1_000_000.0,
    citation="paper Table 4 / hf:Qwen/Qwen2.5-32B",
)
