"""Mamba2-370M — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,        # padded to 50432 internally
    ssm_state=128,
    ssm_expand=2,            # d_inner = 2048
    ssm_head_dim=64,         # 32 SSD heads
    ssm_conv_width=4,
    source="arXiv:2405.21060",
)
