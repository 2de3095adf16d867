"""LLaVA-NeXT-34B — VLM: dense GQA backbone; anyres tiling frontend is a STUB
(input_specs supplies precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    num_patches=2880,  # anyres: base 576 + 4 tiles x 576 (stub frontend)
    rope_theta=5_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
