"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The library goes into ``build/repro_torch/`` at the
root of the checkout, named by a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. The
build happens once, at first use, under a lock: the executor's worker
threads warm their predicates concurrently and may ask for it at once.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# C signature of each library's entry point: (argtypes, restype).
_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "hsv_color": {
        "hsv_color_hist": ([_VOIDP, _VOIDP, _VOIDP, _INT, _INT, _INT, _VOIDP],
                           _INT),
    },
}


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc wall time; 0.0 when an earlier build was reused
    log: str         # nvcc's output (ptxas registers / shared memory / spills)


_LOCK = threading.Lock()
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


def _compile(name: str) -> Built:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
        os.replace(tmp, out)  # atomic: a racing process sees all or nothing
    lib = ctypes.CDLL(str(out))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return Built(lib=lib, path=out, seconds=seconds, log=log)


def load(name: str) -> Built:
    """The built library for ``csrc/<name>.cu``, compiling it on first use."""
    built = _LOADED.get(name)
    if built is None:
        with _LOCK:
            built = _LOADED.get(name)
            if built is None:
                built = _LOADED[name] = _compile(name)
    return built
