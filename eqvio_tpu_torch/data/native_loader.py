"""ctypes binding of the native prefetching PNG loader,
``native/imageloader.cpp`` (counterpart of
``eqvio_tpu/data/native_loader.py``).

C++ worker threads decode frames ahead of the consumer into a bounded
queue.  The library is built on first use into ``build/native``
(:func:`io.native.build_native`); it needs libpng's header, and where that
is missing :func:`available` is false and the data server decodes with the
reader's own ``load_image_u8`` instead.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..io.native import build_native


def _load() -> ctypes.CDLL | None:
    lib = build_native("imageloader", ("png", "z", "pthread"))
    if lib is not None and not getattr(lib, "_bound", False):
        lib.il_create2.restype = ctypes.c_void_p
        lib.il_create2.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.il_next_u8.restype = ctypes.c_int
        lib.il_next_u8.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.il_destroy.argtypes = [ctypes.c_void_p]
        lib._bound = True
    return lib


def available() -> bool:
    return _load() is not None


class NativeImageLoader:
    """Iterator of ``(index, grayscale uint8 frame)`` over ``paths`` in order,
    decoded by ``workers`` C++ threads (``EQVIO_DECODE_THREADS``, default 2)
    at most ``queue_size`` frames ahead; frames hold at most ``max_pixels``."""

    def __init__(self, paths: list[str], queue_size: int = 16, max_pixels: int = 4096 * 3072,
                 workers: int | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native/imageloader.cpp does not build here (g++ and png.h are needed)")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)  # copied by the C++ side
        if workers is None:
            workers = int(os.environ.get("EQVIO_DECODE_THREADS", "2"))
        self._handle = lib.il_create2(arr, len(self._paths), queue_size, workers)
        self._buf = np.empty(max_pixels, dtype=np.uint8)

    def __iter__(self):
        return self

    def __next__(self):
        h, w = ctypes.c_int(), ctypes.c_int()
        idx = self._lib.il_next_u8(self._handle, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                                   self._buf.size, ctypes.byref(h), ctypes.byref(w))
        if idx < 0:
            raise StopIteration
        if h.value == 0 or w.value == 0:
            raise IOError(f"native PNG decode failed for frame {idx}: {self._paths[idx].decode()}")
        return idx, self._buf[: h.value * w.value].reshape(h.value, w.value).copy()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.il_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
