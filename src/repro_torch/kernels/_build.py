"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  The build happens at
first use, from the sources in this checkout, into
``build/repro_torch_kernels/`` at the repository root; a library's file
name carries a hash of its sources and flags, so an edited source
rebuilds and an unchanged one loads from the cache.  ``build_all``
compiles every source at once, one ``nvcc`` process each.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` (the CPU tests), where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("paged_attention", "chunk_prefill", "flash_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of every C entry point (all return a cudaError_t as int)
SIGNATURES = {
    "paged_attention": {
        "repro_paged_decode": [_P] * 9 + [_I] * 9 + [_P],
    },
    "chunk_prefill": {
        "repro_chunk_prefill_attention": [_P] * 8 + [_I] * 10 + [_P],
        "repro_chunk_scatter": [_P] * 5 + [_I] * 7 + [_P],
    },
    "flash_attention": {
        "repro_flash_attention": [_P] * 4 + [_I] * 8 + [_P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build from source on a "
            "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.suffix == ".cuh"
                                            or f.stem == name):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path]:
    """Start one nvcc into a temporary file; returns (process, tmp)."""
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))
    return log


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all() -> Dict[str, str]:
    """Compile every source that has no cached library, all in parallel,
    and load them.  Returns each built source's compiler log (the
    ``-Xptxas -v`` register and shared-memory report)."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in SOURCES if not _lib_path(n).exists()]
        procs = {n: _start(n) for n in todo}
        logs = {n: _finish(n, *pt) for n, pt in procs.items()}
        for n in SOURCES:
            if n not in _libs:
                _libs[n] = _load(n)
        return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and ``torch.cuda.synchronize`` would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
