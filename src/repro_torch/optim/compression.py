"""Gradient compression for data-parallel collectives.

Port of ``repro.optim.compression``. Int8 quantization with error feedback
(EF-SGD style): the quantization residual is carried in optimizer-adjacent
state and re-added next step, so the compressed all-reduce is unbiased in
the long run. ``Int8ErrorFeedback(inner)`` wraps an optimizer and
quantizes the gradients before the inner update (the compressed
data-parallel collective, modelled numerically), on name-keyed dicts as
``optim.adamw`` takes them. ``compressed_psum(x, mesh, dim)`` is the
collective itself, on each rank's block (inside a ``ShardCtx.local``
body, where the reference's runs inside ``shard_map``): int8-quantize
with a per-tensor scale, the max of the scales across the mesh axis
``dim``, an int32 sum, then dequantize; it returns (sum, the number of
ranks summed) as the reference's does. The collectives are
``torch.distributed``'s functional ones.
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


def compressed_psum(x: torch.Tensor, mesh, dim: str):
    """int8 quantize -> int32 sum over the mesh axis ``dim`` -> dequantize;
    returns (sum, n)."""
    from repro_torch.distributed.sharding import all_reduce

    xf = x.to(torch.float32)
    q, scale = _quantize(xf)
    # scales differ per shard: the max scale dequantizes conservatively
    gmax = all_reduce(scale, "max", mesh, dim)
    q = torch.round(xf / gmax).to(torch.int32)
    total = all_reduce(q, "sum", mesh, dim)
    n = all_reduce(torch.ones((), dtype=torch.float32, device=x.device),
                   "sum", mesh, dim)
    return total.to(torch.float32) * gmax, n


@dataclass(frozen=True)
class Int8ErrorFeedback:
    inner: Any

    def init(self, params):
        return {
            "err": {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()},
            "inner": self.inner.init(params),
        }

    def state_shapes(self, param_shapes):
        return {
            "err": {k: torch.empty(s.shape, dtype=torch.float32, device="meta")
                    for k, s in param_shapes.items()},
            "inner": self.inner.state_shapes(param_shapes),
        }

    def state_logical(self, param_logical):
        return {"err": dict(param_logical),
                "inner": self.inner.state_logical(param_logical)}

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
