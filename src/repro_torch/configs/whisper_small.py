"""Whisper-small — encoder-decoder transformer; conv/mel frontend is a STUB
(input_specs supplies precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,            # decoder layers
    num_encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,          # MHA (kv == heads)
    d_ff=3072,
    vocab_size=51865,         # padded to 51968 internally (not 16-divisible)
    num_frames=1500,          # post-conv mel frame embeddings (stub frontend)
    rope_theta=10_000.0,      # learned-pos in the original; RoPE stand-in noted in DESIGN.md
    source="arXiv:2212.04356",
)
