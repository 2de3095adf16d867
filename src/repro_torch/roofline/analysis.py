"""Roofline accounting from a traced dry-run step.

Port of ``repro.roofline.analysis``. Three terms per (arch x shape x
mesh), all in seconds:

  compute    = FLOPs_per_device / peak_FLOP/s
  memory     = bytes_per_device / HBM_bw
  collective = wire_bytes_per_device / link_bw

The reference lowers and compiles each cell with XLA and reads
``cost_analysis()``, ``memory_analysis()`` and the collectives parsed
from the per-device HLO. The port has no compiler: ``Trace``, a
``TorchDispatchMode``, runs the step eagerly on fake tensors (no storage)
placed on a fake process group's mesh and counts, on rank 0's blocks:

  * FLOPs: each aten op's by ``torch.utils.flop_counter``'s formulas;
    each hand-written kernel's by its own formula (the operations
    ``PERF.md``'s bounds use), told by the wrappers, which launch nothing
    on fake tensors under the trace (``kernels._build.tracing``);
  * bytes accessed: each op's inputs and outputs once (views move none),
    the kernels' included;
  * collectives: ``torch.distributed``'s functional collectives, mapped
    onto the reference's five names, with their result bytes, group size
    and ``wire_multiplier``; a group within one host of ``hw.GPUS_PER_HOST``
    cards rides NVLink, any other the link between hosts;
  * memory: the arguments' bytes (parameters, optimizer state, inputs and
    cache), the outputs', and the peak of live fake storage during the
    step less the arguments (``temp_bytes``).

``DTensor`` ops are left to ``DTensor``'s own dispatch, whose local ops
(rank 0's share) and collectives the mode then sees; the sharding
propagator's runs of each op on global-shape stand-ins are not counted.
Eager torch runs every layer, so a trace counts each (the reference's
``cost_analysis`` counts a scan body once); ``delta_total`` over
``roofline_units`` is then the whole step again, an identity the tests
hold. ``COLLECTIVE_OPS``, ``wire_multiplier``, ``total_wire_bytes``,
``CostSample``'s fields, ``delta_total``, ``roofline_terms`` and
``model_flops`` are the reference's; ``CostSample.nvlink_wire_bytes`` and
``roofline_terms``' ``nvlink_wire_dev`` are the port's (the reference's
mesh has one kind of link), and ``parse_collectives`` (HLO text) gives
way to ``Trace``.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import _build
from repro_torch.roofline import hw

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# torch's functional collectives (``_c10d_functional`` and its autograd
# twin), by the reference's names
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_FACTORIES = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided"}


def wire_multiplier(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


def total_wire_bytes(colls: Dict[str, Dict[str, float]]) -> float:
    return sum(v["wire_bytes"] for v in colls.values())


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# --------------------------------------------------------------------------- #
class Trace(TorchDispatchMode):
    """Counts rank 0's FLOPs, bytes accessed, collectives and live fake
    storage of what runs under it (see the module's note). Enter it inside
    the dry run's ``FakeTensorMode``, after ``arguments``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.formulas = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.kernels: Dict[str, int] = {}
        self.collectives = {op: {"count": 0, "result_bytes": 0.0,
                                 "wire_bytes": 0.0, "nvlink_wire_bytes": 0.0}
                            for op in COLLECTIVE_OPS}
        self._live: Dict[int, int] = {}      # storage id -> bytes
        self._args: Dict[int, int] = {}
        self.live_bytes = self.peak_bytes = 0
        self._shadow = WeakIdKeyDictionary()  # the sharding propagator's
        self._quiet = 0   # > 0 inside torch's own bookkeeping: not counted
        self._groups: Dict[str, tuple] = {}

    # ----------------------------------------------------------- storage
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def arguments(self, tree) -> int:
        """Count ``tree``'s tensors (their blocks, for ``DTensor``s) as the
        step's arguments; returns their bytes."""
        for t in _tensors(tree):
            t = _local(t)
            self._track(t)
            self._args[id(t.untyped_storage())] = t.untyped_storage().nbytes()
        return self.argument_bytes

    @property
    def argument_bytes(self) -> int:
        return sum(self._args.values())

    def output_bytes(self, tree) -> Dict[str, int]:
        """(bytes of ``tree``'s distinct storages, those of them that are
        arguments): the step's outputs and their aliases."""
        seen, alias = {}, 0
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if id(st) not in seen:
                seen[id(st)] = st.nbytes()
                alias += st.nbytes() if id(st) in self._args else 0
        return {"output_bytes": sum(seen.values()), "alias_bytes": alias}

    # ----------------------------------------------------------- kernels
    def kernel(self, name: str, flops: float, nbytes: int) -> None:
        """A hand-written kernel's call on fake tensors (``_build.traced``)."""
        self.flops += flops
        self.bytes_accessed += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1

    # ----------------------------------------------------------- collectives
    def _group(self, name: str) -> tuple:
        """(size, within one host) of the process group called ``name``."""
        got = self._groups.get(name)
        if got is None:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import _resolve_process_group

            ranks = dist.get_process_group_ranks(_resolve_process_group(name))
            hosts = {r // hw.GPUS_PER_HOST for r in ranks}
            got = self._groups[name] = (len(ranks), len(hosts) == 1)
        return got

    def _collective(self, func, args, out) -> None:
        op = _COLLECTIVES[func._opname]
        name = args[-1]
        n, intra = self._group(name) if isinstance(name, str) else (1, True)
        rb = sum(_nbytes(t) for t in _tensors(out))
        wire = rb * wire_multiplier(op, n)
        rec = self.collectives[op]
        rec["count"] += 1
        rec["result_bytes"] += rb
        rec["wire_bytes"] += wire
        if intra:
            rec["nvlink_wire_bytes"] += wire

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor's dispatch; its local ops come back
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if self._quiet or any(t in self._shadow for t in ins):
            for t in _tensors(out):
                self._shadow[t] = True
            return out
        outs = _tensors(out)
        if not outs:   # a query (a device, a size): no data moves
            return out
        for t in outs:
            self._track(t)
        if func.namespace in ("_c10d_functional", "_c10d_functional_autograd"):
            if func._opname in _COLLECTIVES:
                self._collective(func, args, out)
            return out
        f = self.formulas.get(func, self.formulas.get(func.overloadpacket))
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        if not func.is_view and func._opname not in _FACTORIES:
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(
                map(_nbytes, outs))
        return out

    def _patch(self, owner, name: str, wrap) -> None:
        """``owner.name`` replaced by ``wrap(it)`` while the trace runs
        (left alone where this torch has no such attribute)."""
        orig = owner.__dict__.get(name) if isinstance(owner, type) else \
            getattr(owner, name, None)
        if orig is None:
            return
        if isinstance(orig, staticmethod):
            new = staticmethod(wrap(orig.__func__))
        else:
            new = wrap(orig)
        setattr(owner, name, new)
        self._patches.append((owner, name, orig))

    def _shadowed(self, make):
        """The sharding propagator's maker of global-shape stand-ins: what
        it makes, and every op on it, is not rank 0's work."""
        def shadow(arg):
            self._quiet += 1
            try:
                t = make(arg)
            finally:
                self._quiet -= 1
            self._shadow[t] = True
            return t

        return shadow

    def _off_books(self, fn):
        """``fn`` on real tensors and uncounted: DTensor's planning of a
        strided shard indexes a small arange it makes, which a fake tensor
        cannot give back as numbers."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        def run(*args, **kwargs):
            self._quiet += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                self._quiet -= 1

        return run

    def __enter__(self):
        from torch.distributed.tensor import _op_schema, placement_types

        self._patches = []
        self._patch(_op_schema, "_rebuild_tensor_from_dtensor_meta",
                    self._shadowed)
        strided = getattr(placement_types, "_StridedShard", None)
        if strided is not None:
            self._patch(strided, "local_shard_size_and_offset",
                        self._off_books)
        self._kernels = _build.tracing(self.kernel).__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._kernels.__exit__(*exc)
            for owner, name, orig in reversed(self._patches):
                setattr(owner, name, orig)


# --------------------------------------------------------------------------- #
@dataclass
class CostSample:
    """What one traced step yields."""

    flops: float = 0.0                 # per device
    bytes_accessed: float = 0.0        # per device
    wire_bytes: float = 0.0            # per device
    collectives: Dict = field(default_factory=dict)
    mem: Dict = field(default_factory=dict)
    compile_seconds: float = 0.0
    nvlink_wire_bytes: float = 0.0     # the part of wire_bytes on NVLink

    @staticmethod
    def from_trace(trace: Trace, outputs, compile_seconds: float = 0.0):
        """The sample of a traced step whose results are ``outputs``."""
        colls = {op: dict(rec) for op, rec in trace.collectives.items()}
        out = trace.output_bytes(outputs)
        mem = {
            "argument_bytes": int(trace.argument_bytes),
            "output_bytes": int(out["output_bytes"]),
            "temp_bytes": int(max(trace.peak_bytes - trace.argument_bytes, 0)),
            "code_bytes": 0,
            "alias_bytes": int(out["alias_bytes"]),
        }
        return CostSample(
            flops=float(trace.flops),
            bytes_accessed=float(trace.bytes_accessed),
            wire_bytes=total_wire_bytes(colls),
            collectives=colls,
            mem=mem,
            compile_seconds=compile_seconds,
            nvlink_wire_bytes=sum(v["nvlink_wire_bytes"]
                                  for v in colls.values()),
        )


def delta_total(base: CostSample, units) -> Dict[str, float]:
    """units: list of (count, CostSample). Returns corrected totals/device."""
    flops = base.flops
    byts = base.bytes_accessed
    wire = base.wire_bytes
    for count, u in units:
        flops += count * (u.flops - base.flops)
        byts += count * (u.bytes_accessed - base.bytes_accessed)
        wire += count * (u.wire_bytes - base.wire_bytes)
    return {"flops": max(flops, 0.0), "bytes": max(byts, 0.0), "wire": max(wire, 0.0)}


def roofline_terms(flops_dev: float, bytes_dev: float, wire_dev: float,
                   nvlink_wire_dev: float = 0.0) -> Dict[str, float]:
    """The reference's terms on one H100: ``wire_dev`` less its NVLink part
    over the link between hosts, the NVLink part over NVLink."""
    compute = flops_dev / hw.PEAK_FLOPS_BF16
    memory = bytes_dev / hw.HBM_BW
    coll = ((wire_dev - nvlink_wire_dev) / hw.HOST_LINK_BW
            + nvlink_wire_dev / hw.NVLINK_BW)
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": coll}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    bound = max(compute, memory, coll)
    terms["roofline_fraction"] = compute / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D prefill, 2*N*B decode."""
    from repro_torch.models.registry import model_api

    n_active = model_api(cfg).active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch
