"""Config dataclasses for architectures and input shapes.

Every assigned architecture is expressed as a frozen ``ModelConfig``; input
shapes are ``ShapeConfig``. The FULL configs are only ever lowered via the
dry-run (ShapeDtypeStruct, no allocation); ``reduce_for_smoke`` derives a
tiny same-family config for CPU smoke tests.

Port of ``repro.configs.base`` with only its imports rewritten (the
architecture files and ``__init__`` likewise): the configs are plain
dataclasses. ``param_count`` goes through the port's model registry. The
port's models read ``attention_impl``, ``attention_chunk_q`` and
``attention_unroll`` nowhere: the device of the tensors picks the
attention path. ``remat`` and ``remat_policy`` are read where a gradient
is taken (``models.transformer._remat``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

VOCAB_PAD_MULTIPLE = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | encdec | hybrid | ssm | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_dense_residual: bool = False  # arctic: parallel dense FFN residual
    capacity_factor: float = 1.25

    # --- attention variants ---
    sliding_window: int = 0        # >0: mistral-style SWA (ring-buffer cache)
    local_window: int = 0          # >0: griffin-style local attention window
    attn_pattern: Tuple[str, ...] = ()  # hybrid block pattern, e.g. ("rglru","rglru","local")

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_groups: int = 1

    # --- enc-dec (whisper) ---
    num_encoder_layers: int = 0
    num_frames: int = 0            # stub frontend: encoder frame embeddings

    # --- VLM (llava) ---
    num_patches: int = 0           # stub frontend: patch embeddings prepended

    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    attention_impl: str = "xla"    # xla | pallas (pallas validated in interpret mode)
    attention_chunk_q: int = 512   # XLA-path q blocking (0 = dense)
    attention_unroll: bool = False  # unroll q chunks (roofline lowering only)
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots | dots_no_batch
    grad_accum: int = 1            # gradient-accumulation microbatches
    grad_accum_dtype: str = "float32"
    tie_embeddings: bool = False
    # --- beyond-paper perf knobs (§Perf) ---
    moe_serve_ep2d: bool = False   # resident experts: E over 'data', F over 'model'
    cache_dtype: str = ""          # "" = model dtype; e.g. "float8_e4m3fn"
    seq_parallel: bool = False     # Megatron-SP: inter-block activations shard seq over 'model'
    source: str = ""               # provenance note

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if serving memory/compute is sub-quadratic in context length."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def vocab_padded(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    # ----------------------- parameter counting ----------------------- #
    def param_count(self) -> int:
        """Analytic parameter count (matches init_params; used for 6·N·D)."""
        from repro_torch.models.registry import family_module

        return family_module(self.family).param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import family_module

        mod = family_module(self.family)
        if hasattr(mod, "active_param_count"):
            return mod.active_param_count(self)
        return self.param_count()

    # --------------------------- reduction ---------------------------- #
    def reduce_for_smoke(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=len(self.attn_pattern) if self.attn_pattern else 2,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=257,  # deliberately not a multiple of the pad unit
            head_dim=16 if self.num_heads else 0,
            remat=False,
            dtype="float32",  # CPU smoke: exact numerics
        )
        if self.num_experts:
            kw.update(num_experts=4, num_experts_per_tok=min(2, self.num_experts_per_tok))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_expand=2)
        if self.num_encoder_layers:
            kw.update(num_encoder_layers=2, num_frames=8)
        if self.num_patches:
            kw.update(num_patches=8)
        if self.sliding_window:
            kw.update(sliding_window=32)
        if self.local_window:
            kw.update(local_window=32)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch

    def reduce_for_smoke(self) -> "ShapeConfig":
        return ShapeConfig(
            name=self.name + "-smoke",
            seq_len=min(self.seq_len, 32),
            global_batch=min(self.global_batch, 2),
            kind=self.kind,
        )


SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch x shape) a runnable dry-run cell? Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skipped(full-attention: 500k decode needs sub-quadratic attention)"
    return True, "ok"
