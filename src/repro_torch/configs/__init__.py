"""Architecture registry: the 10 assigned architectures + input shapes.

``get_config(arch)`` returns the exact published config; the dry-run iterates
``iter_cells()`` over the 40 (arch x shape) cells.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, cell_applicable

from repro_torch.configs import (  # noqa: E402
    arctic_480b,
    grok1_314b,
    h2o_danube_1_8b,
    llama3_8b,
    llava_next_34b,
    mamba2_370m,
    recurrentgemma_9b,
    smollm_135m,
    whisper_small,
    yi_6b,
)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        yi_6b,
        smollm_135m,
        llama3_8b,
        h2o_danube_1_8b,
        arctic_480b,
        grok1_314b,
        whisper_small,
        recurrentgemma_9b,
        llava_next_34b,
        mamba2_370m,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def list_archs():
    return list(ARCHS)


def iter_cells() -> Iterator[Tuple[ModelConfig, ShapeConfig, bool, str]]:
    """All 40 (arch x shape) cells with applicability verdicts."""
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            ok, reason = cell_applicable(cfg, shape)
            yield cfg, shape, ok, reason


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "get_shape",
    "list_archs",
    "iter_cells",
    "cell_applicable",
]
