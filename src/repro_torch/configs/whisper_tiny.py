"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
Encoder-decoder; conv/mel frontend is a STUB (input_specs provides frame
embeddings of shape (batch, 1500, d_model)). [arXiv:2212.04356]"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,              # decoder layers; encoder below
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    encoder=EncoderConfig(num_layers=4, num_frames=1500),
    activation="gelu",
    citation="arXiv:2212.04356",
)
