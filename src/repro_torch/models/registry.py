"""Family registry: maps ModelConfig.family -> implementation module.

Port of ``repro.models.registry``. The dense, vlm, ssm, hybrid and encdec
families are ported; moe raises ``NotImplementedError`` naming the
ROADMAP item that ports it, so no config quietly runs another family's
model.

Every ported module offers: param_shapes, init_params, param_count,
active_param_count, forward, prefill, decode_step, cache_shapes, and
``Model``, its parameter module (``models/params.py``).
"""
from __future__ import annotations

from types import ModuleType

FAMILIES = ("dense", "moe", "encdec", "hybrid", "ssm", "vlm")
UNPORTED = ("moe",)


def family_module(family: str) -> ModuleType:
    if family not in FAMILIES:
        raise KeyError(f"unknown family {family!r}")
    if family in UNPORTED:
        raise NotImplementedError(
            f"the {family} family is not ported yet: ROADMAP.md, queue 1, "
            "item 1 (the moe family)")
    from repro_torch.models import encdec, hybrid, ssm, transformer, vlm

    return {"dense": transformer, "encdec": encdec, "hybrid": hybrid,
            "ssm": ssm, "vlm": vlm}[family]


def model_api(cfg) -> ModuleType:
    return family_module(cfg.family)
