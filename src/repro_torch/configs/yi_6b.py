"""Yi-6B — llama-architecture dense GQA transformer. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf:01-ai/Yi-6B",
)
