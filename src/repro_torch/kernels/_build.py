"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The library goes into ``build/repro_torch/`` at the
root of the checkout, named by a hash of its source, the headers it may
include (``csrc/*.cuh``) and its own flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. The
build happens once, at first use, under a lock of its own: the
executor's worker threads warm their predicates concurrently and may ask
for one library at once, and different libraries build side by side.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# hsv_color, moe_router, ssd and rglru (and its gradient) equal their
# plain versions bit for bit (or within a few ulps) only without FMA
# contraction; the attention kernels and the ssd gradient are held to a
# tolerance and contract freely.
NO_FMA = ("--fmad=false",)
LIBRARY_FLAGS = {
    "decode_attention": (),
    "empty": (),
    "flash_attention": (),
    "flash_attention_bwd": (),
    "hsv_color": NO_FMA,
    "moe_router": NO_FMA,
    "rglru": NO_FMA,
    "rglru_bwd": NO_FMA,
    "ssd": NO_FMA,
    "ssd_bwd": (),
}

# C signature of each library's entry point: (argtypes, restype). Each
# kernel takes its arguments packed into one buffer (a bytes object from
# the wrapper's struct format) and the stream: ctypes converts two
# arguments where it would convert up to ~27 (``ssd_scan`` also takes its
# scratch, a pointer or None; ``flash_attention_variant`` its bf16 design).
# ``empty`` launches a kernel that does nothing: the launch floor beside
# the kernels' times;
# ``flash_attention_route`` and ``flash_attention_bwd_route`` launch
# nothing and tell which of the forward's or the gradient's designs a call
# with those arguments takes; ``ssd_bwd_parts`` launches nothing and tells
# how many partials of dB and of dC a (b, s) the SSD gradient writes at
# (batch, seq, heads, groups, chunk).
_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
_PACKED = ([ctypes.c_char_p, _VOIDP], _INT)
SIGNATURES = {
    "decode_attention": {"decode_attention_bshd": _PACKED},
    "empty": {"empty_launch": ([_VOIDP], _INT)},
    "flash_attention": {"flash_attention_bshd": _PACKED,
                        "flash_attention_variant": (
                            [ctypes.c_char_p, _INT, _VOIDP], _INT),
                        "flash_attention_route": ([ctypes.c_char_p], _INT)},
    "flash_attention_bwd": {"flash_attention_bwd": _PACKED,
                            "flash_attention_bwd_route": (
                                [ctypes.c_char_p], _INT)},
    "hsv_color": {"hsv_color_hist": _PACKED},
    "moe_router": {"moe_router_tk": _PACKED, "moe_router_tokens": _PACKED,
                   "moe_router_bwd": _PACKED},
    "rglru": {"rglru_bsw": _PACKED, "rglru_tokens": _PACKED},
    "rglru_bwd": {"rglru_bwd": _PACKED},
    "ssd": {"ssd_scan": ([ctypes.c_char_p, _VOIDP, _VOIDP], _INT)},
    "ssd_bwd": {"ssd_bwd": _PACKED,
                "ssd_bwd_parts": ([_INT] * 5, _INT)},
}


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc wall time; 0.0 when an earlier build was reused
    log: str         # nvcc's output (ptxas registers / shared memory /
                     # spills), kept beside the library for a later reuse


_LOCKS_LOCK = threading.Lock()
_LOCKS: Dict[str, threading.Lock] = {}
_LOADED: Dict[str, Built] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def flags(name: str) -> tuple:
    """nvcc's flags for ``csrc/<name>.cu``: ``csrc/`` is on the include
    path, so a copy of a source built elsewhere finds its headers."""
    return NVCC_FLAGS + ("-I", str(CSRC)) + LIBRARY_FLAGS[name]


def _compile(name: str) -> Built:
    src = CSRC / f"{name}.cu"
    # the shared headers count as part of every source that may include them
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(flags(name)).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    seconds, log = 0.0, ""
    if out.exists():
        if log_path.exists():
            log = log_path.read_text()
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *flags(name), "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(log)
        os.replace(tmp_log, log_path)  # before the library: a reuse finds it
        os.replace(tmp, out)  # atomic: a racing process sees all or nothing
    lib = ctypes.CDLL(str(out))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return Built(lib=lib, path=out, seconds=seconds, log=log)


def f32_contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor: itself when it already is one,
    so a kernel's usual input costs no copy and no dispatch."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def raw_stream(index: int) -> int:
    """The handle of the current CUDA stream on card ``index``, as an int
    for a ctypes call: PyTorch's own raw lookup, which builds no Stream
    object (torch.cuda.current_stream(...).cuda_stream takes several
    microseconds a call on the card's host)."""
    return torch._C._cuda_getCurrentRawStream(index)


def load(name: str) -> Built:
    """The built library for ``csrc/<name>.cu``, compiling it on first use."""
    built = _LOADED.get(name)
    if built is None:
        with _LOCKS_LOCK:
            lock = _LOCKS.setdefault(name, threading.Lock())
        with lock:
            built = _LOADED.get(name)
            if built is None:
                built = _LOADED[name] = _compile(name)
    return built


# --------------------------------------------------------------------------- #
# tensors with no storage on the card                                          #
# --------------------------------------------------------------------------- #
_tracer = None   # the dry run's kernel recorder while it traces, else None


def storageless(t) -> bool:
    """Whether ``t`` is a tensor whose data does not exist: a fake tensor
    (``FakeTensorMode``; a fake CUDA tensor says ``is_cuda``) or a meta
    tensor. Its ``data_ptr()`` is no address a kernel may read."""
    return isinstance(t, torch.Tensor) and (t.is_meta
                                            or isinstance(t, FakeTensor))


def on_card(t: torch.Tensor) -> bool:
    """Whether a model-path wrapper takes its kernel's path for ``t``: a
    CUDA tensor, or a fake tensor of any device under the dry run's trace,
    which stands for the card's step (a CPU-only build of torch cannot
    differentiate fake CUDA tensors, so the dry run traces fake CPU ones
    there)."""
    return t.is_cuda or (_tracer is not None and isinstance(t, FakeTensor))


def refuse_fake(kernel: str, *tensors) -> None:
    """Raise before ``kernel`` would launch on a fake or meta tensor."""
    if any(storageless(t) for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel got a fake or meta tensor: it launches only "
            "on tensors whose data lies on the card")


def traced(kernel: str, flops: float, reads, writes) -> bool:
    """Whether a model-path launch of ``kernel`` is to be left out because
    its inputs (``reads``) are fake: False for tensors on the card (launch
    it); True under the dry run's trace (``tracing``), which is told the
    kernel's operations and the bytes it reads and writes (``writes``,
    allocated by the caller, are fake too, so the trace sees their
    memory); otherwise ``refuse_fake``'s error."""
    for t in reads:   # a plain tensor's type is exactly torch.Tensor
        if t is not None and (type(t) is not torch.Tensor or t.is_meta) \
                and storageless(t):
            break
    else:
        return False
    tensors = [t for t in (*reads, *writes) if t is not None]
    if _tracer is None or any(t.is_meta for t in tensors):
        refuse_fake(kernel, *tensors)
    _tracer(kernel, float(flops),
            sum(t.numel() * t.element_size() for t in tensors))
    return True


class tracing:
    """``with tracing(record):`` the model-path kernels on fake tensors
    call ``record(kernel, flops, bytes)`` and launch nothing (the dry
    run's trace, ``roofline/analysis.py``)."""

    def __init__(self, record):
        self.record = record

    def __enter__(self):
        global _tracer
        self.prev, _tracer = _tracer, self.record
        return self

    def __exit__(self, *exc):
        global _tracer
        _tracer = self.prev
