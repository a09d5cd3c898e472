"""Build and load the port's CUDA sources.

Each source in ``eqvio_tpu_torch/csrc`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
ctypes.  The library's file name carries a hash of the source, so an edited
source rebuilds and an unchanged one loads from ``<repo>/build/kernels``.
Nothing is built when this module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels build only where it exists")


def load(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if needed and return the loaded library."""
    if source in _loaded:
        return _loaded[source]
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{src.stem}_{digest}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    build_seconds[source] = time.perf_counter() - t0
    _loaded[source] = lib
    return lib
