"""Snowflake Arctic-480B — 128-expert top-2 MoE with a parallel dense
residual MLP. [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    num_experts_per_tok=2,
    moe_dense_residual=True,  # dense-MoE hybrid: dense FFN residual in parallel
    rope_theta=10_000.0,
    source="hf:Snowflake/snowflake-arctic-base",
)
