"""Family registry: maps ModelConfig.family -> implementation module.

Port of ``repro.models.registry``: every family is ported. An unknown
family raises ``KeyError``.

Every ported module offers: param_shapes, init_params, param_count,
active_param_count, forward, prefill, decode_step, cache_shapes, and
``Model``, its parameter module (``models/params.py``). The dense, vlm,
encdec and hybrid families also offer loss_fn and make_train_step;
training the ssm and moe families waits (ROADMAP.md, queue 1, item 2).
"""
from __future__ import annotations

from types import ModuleType

FAMILIES = ("dense", "moe", "encdec", "hybrid", "ssm", "vlm")


def family_module(family: str) -> ModuleType:
    if family not in FAMILIES:
        raise KeyError(f"unknown family {family!r}")
    from repro_torch.models import encdec, hybrid, moe, ssm, transformer, vlm

    return {"dense": transformer, "encdec": encdec, "hybrid": hybrid,
            "moe": moe, "ssm": ssm, "vlm": vlm}[family]


def model_api(cfg) -> ModuleType:
    return family_module(cfg.family)
