"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,  # mistral-style SWA -> sub-quadratic serving
    rope_theta=10_000.0,
    source="arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base",
)
