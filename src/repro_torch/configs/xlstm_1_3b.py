"""xlstm-1.3b [ssm] — 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304.
sLSTM + mLSTM blocks; xLSTM[7:1] ratio (1 sLSTM per 8 blocks).
[arXiv:2405.04517]"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=(MLSTM,) * 7 + (SLSTM,),  # 7:1, 48 = 6 * 8
    citation="arXiv:2405.04517",
)
