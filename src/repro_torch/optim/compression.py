"""Gradient compression for data-parallel collectives.

Port of ``repro.optim.compression``. Int8 quantization with error feedback
(EF-SGD style): the quantization residual is carried in optimizer-adjacent
state and re-added next step, so the compressed all-reduce is unbiased in
the long run. ``Int8ErrorFeedback(inner)`` wraps an optimizer and
quantizes the gradients before the inner update (the compressed
data-parallel collective, modelled numerically), on name-keyed dicts as
``optim.adamw`` takes them. The reference's ``compressed_psum`` (the
collective itself, inside ``shard_map``) waits for the port of sharding
(ROADMAP.md, queue 1, item 4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


def _quantize(x: torch.Tensor):
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    q, scale = _quantize(x.to(torch.float32))
    return q.to(torch.float32) * scale


@dataclass(frozen=True)
class Int8ErrorFeedback:
    inner: Any

    def init(self, params):
        return {
            "err": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in params.items()},
            "inner": self.inner.init(params),
        }

    def state_shapes(self, param_shapes):
        return {
            "err": {k: torch.empty(s.shape, dtype=torch.float32, device="meta")
                    for k, s in param_shapes.items()},
            "inner": self.inner.state_shapes(param_shapes),
        }

    def global_norm(self, tree):
        return self.inner.global_norm(tree)

    def update(self, grads, state, params):
        ghat, err = {}, {}
        for k, g in grads.items():
            corrected = g.to(torch.float32) + state["err"][k]
            ghat[k] = quantize_dequantize(corrected)
            err[k] = corrected - ghat[k]
        updates, inner_state = self.inner.update(ghat, state["inner"], params)
        return updates, {"err": err, "inner": inner_state}
