from repro_torch.configs.base import (ATTN, MLSTM, RGLRU, SHAPES, SLIDING, SLSTM,
                                EncoderConfig, ModelConfig, MoEConfig,
                                ShapeConfig, VisionConfig, smoke_shape)
from repro_torch.configs.registry import ASSIGNED_ARCHS, all_configs, get_config

__all__ = [
    "ATTN", "MLSTM", "RGLRU", "SLIDING", "SLSTM", "SHAPES",
    "EncoderConfig", "ModelConfig", "MoEConfig", "ShapeConfig",
    "VisionConfig", "smoke_shape", "ASSIGNED_ARCHS", "all_configs",
    "get_config",
]
