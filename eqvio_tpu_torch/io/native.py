"""The repository's host-side C++ helpers, built on first use and bound with
ctypes (counterpart of ``eqvio_tpu/io/native.py``).

:func:`build_native` compiles ``native/<name>.cpp`` with ``native/Makefile``'s
flags into ``<repo>/build/native`` (which git ignores) under a name that
carries a hash of the source, so an edited source rebuilds and the
libraries committed in ``native/`` (built for another machine) are never
loaded.  :class:`AsyncFile` is the append-only file of
``native/aofstream.cpp``, whose C++ thread flushes the lines: the CSV
writer's ``streaming=True``.  Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]  # native/Makefile

_libs: dict[str, ctypes.CDLL | None] = {}
_lock = threading.Lock()


def build_native(name: str, libs: tuple[str, ...]) -> ctypes.CDLL | None:
    """``native/<name>.cpp`` built and loaded (once per process), or None
    where it does not compile or load here (no ``g++``, a missing header
    such as ``png.h``, a library the build links that is not installed)."""
    with _lock:
        if name not in _libs:
            _libs[name] = _build(name, libs)
        return _libs[name]


def _build(name: str, libs: tuple[str, ...]) -> ctypes.CDLL | None:
    src = NATIVE_SRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXXFLAGS, "-o", str(tmp), str(src), *[f"-l{lib}" for lib in libs]]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:  # no g++
            return None
        if res.returncode != 0:
            return None
        os.replace(tmp, lib_path)
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError:  # built elsewhere against a library this machine lacks
        return None


def _aofstream() -> ctypes.CDLL | None:
    lib = build_native("aofstream", ("pthread",))
    if lib is not None and not getattr(lib, "_bound", False):
        lib.aof_open.restype = ctypes.c_void_p
        lib.aof_open.argtypes = [ctypes.c_char_p]
        lib.aof_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.aof_close.argtypes = [ctypes.c_void_p]
        lib.aof_flush_all.argtypes = []
        lib.aof_flush_all.restype = None
        lib._bound = True
    return lib


def available() -> bool:
    return _aofstream() is not None


class AsyncFile:
    """Append-only file whose writes a native thread flushes."""

    def __init__(self, path: str):
        lib = _aofstream()
        if lib is None:
            raise RuntimeError("native/aofstream.cpp does not build here")
        self._lib = lib
        self._handle = lib.aof_open(path.encode())

    def write(self, text: str) -> None:
        data = text.encode()
        self._lib.aof_write(self._handle, data, len(data))

    append = write  # so the writer treats buffers and streams alike

    def close(self) -> None:
        if self._handle is not None:
            self._lib.aof_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def flush_all() -> None:
    """Flush every open :class:`AsyncFile`; nothing where the library does not build."""
    lib = _aofstream()
    if lib is not None:
        lib.aof_flush_all()
