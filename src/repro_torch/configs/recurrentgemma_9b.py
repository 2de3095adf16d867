"""RecurrentGemma-9B — Griffin-style hybrid: RG-LRU recurrent blocks + local
attention in a 2:1 pattern (attn every third block). [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,           # MQA in the local-attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    local_window=2048,
    attn_pattern=("rglru", "rglru", "local"),  # repeated; remainder = rglru
    rope_theta=10_000.0,
    source="arXiv:2402.19427",
)
