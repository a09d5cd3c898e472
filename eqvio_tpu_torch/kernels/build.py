"""Build and load the port's CUDA sources.

Each source in ``eqvio_tpu_torch/csrc`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
ctypes.  The library's file name carries a hash of the source, so an edited
source rebuilds and an unchanged one loads from ``<repo>/build/kernels``.
Nothing is built when this module is imported: the first launch builds.
``ptxas -v``'s report (registers, spills per kernel) is kept beside the
library as ``<name>.ptxas.txt``, so a library loaded from an earlier build
still has it (:func:`ptxas_summary`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>``'s current text is built."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def load(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if needed and return the loaded library."""
    if source in _loaded:
        return _loaded[source]
    lib_path = library_path(source)
    t0 = time.perf_counter()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{res.stdout}\n{res.stderr}")
        # the report first: a library on disk always has one beside it
        lib_path.with_suffix(".ptxas.txt").write_text(res.stdout + res.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    build_seconds[source] = time.perf_counter() - t0
    _loaded[source] = lib
    return lib


def ptxas_summary(source: str) -> dict[str, dict[str, int]]:
    """Per kernel of ``source``'s library: ``registers``, ``spill_bytes``
    (stores + loads) and static ``smem_bytes``, from the ``ptxas -v`` report
    kept beside it (empty before the first build)."""
    report = library_path(source).with_suffix(".ptxas.txt")
    out: dict[str, dict[str, int]] = {}
    props = None
    for line in (report.read_text() if report.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            props = out.setdefault(m.group(1), {"registers": 0, "spill_bytes": 0, "smem_bytes": 0})
            continue
        if props is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            props["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            props["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            props["smem_bytes"] = int(m.group(1))
    return out
