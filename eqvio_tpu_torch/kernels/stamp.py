"""The op ``eqvio_tpu_torch::frame_stamp``: a clock in nanoseconds into one
slot of an int64 row (:mod:`eqvio_tpu_torch.stamps` places the calls).

On a CUDA row it launches ``frame_stamp_kernel`` (``csrc/stamp_cuda.cu``),
which reads the card's ``%globaltimer`` on the current stream, so it runs
after the kernels enqueued before it; a CUDA graph captures it as one node.
On a CPU row it writes the host clock, so a run on the CPU stamps too.
Under a dispatch mode it is one op of its own, and
:func:`eqvio_tpu_torch.cost.count` counts it as no work.  This module is
imported at the first stamping block; the library builds at the first
launch.  :func:`clock_offset` maps the card's timer to the host clock.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..stamps import host_ns
from . import build

_SOURCE = "stamp_cuda.cu"
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or \
    (lambda index: torch.cuda.current_stream(index).cuda_stream)


@functools.cache
def _fn():
    """The bound C entry point ``frame_stamp`` (builds the library)."""
    fn = build.load(_SOURCE).frame_stamp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("eqvio_tpu_torch::frame_stamp", mutates_args=("row",), device_types="cpu")
def frame_stamp(row: torch.Tensor, slot: int) -> None:
    """The op's CPU implementation: the host clock into ``row[slot]``."""
    row.select(0, slot).fill_(host_ns())


@frame_stamp.register_kernel("cuda")
def _frame_stamp_cuda(row, slot):
    if row.dtype != torch.int64 or row.dim() != 1 or not row.is_contiguous() or not 0 <= slot < row.numel():
        raise ValueError(f"a stamp row is a contiguous 1-d int64 tensor with slot {slot}: "
                         f"{row.dtype}, shape {tuple(row.shape)}")
    fn = _fn()
    with torch.cuda.device(row.device):
        rc = fn(row.data_ptr(), slot, _raw_stream(row.device.index))
    if rc != 0:
        raise RuntimeError(f"frame_stamp launch failed: CUDA error {rc}")


@frame_stamp.register_fake
def _frame_stamp_fake(row, slot):
    return None


def clock_offset(device: torch.device, tries: int = 16) -> tuple[int, int]:
    """``(offset_ns, width_ns)``: a stamp taken on ``device`` plus
    ``offset_ns`` is on the host clock (:data:`host_ns`).  Of ``tries`` stamps,
    each launched on an idle device between two host reads around a
    synchronise, the narrowest bracket gives the offset (its midpoint) and
    ``width_ns`` (its width: the offset's uncertainty is half of it).  On the
    CPU a stamp is the host clock: ``(0, 0)``."""
    if device.type != "cuda":
        return 0, 0
    row = torch.zeros(1, dtype=torch.int64, device=device)
    frame_stamp(row, 0)  # loads the library
    best = None
    for _ in range(tries):
        torch.cuda.synchronize(device)
        h0 = host_ns()
        frame_stamp(row, 0)
        torch.cuda.synchronize(device)
        h1 = host_ns()
        if best is None or h1 - h0 < best[1]:
            best = ((h0 + h1) // 2 - int(row.item()), h1 - h0)
    return best
