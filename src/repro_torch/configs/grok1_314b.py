"""Grok-1-314B — 8-expert top-2 MoE. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    num_experts_per_tok=2,
    rope_theta=10_000.0,
    source="hf:xai-org/grok-1",
)
