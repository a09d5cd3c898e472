"""The tracker's epipolar RANSAC gate: the CUDA kernel's wrapper and its plain version.

:func:`ransac_mask` refines the tracked mask of one sequence or of lanes of
sequences: ``prev`` and ``curr`` are ``[*L, N, 2]`` pixel positions, ``mask``
``[*L, N]``, ``key`` the threefry key ``[2]`` (one for every lane) or
``[*L, 2]``, and ``next_id`` the tracker's id counter ``[]`` or ``[*L]``.  It
is the custom op ``eqvio_tpu_torch::ransac_epipolar_mask``: on CUDA tensors
it launches ``csrc/ransac_cuda.cu`` once for all lanes (see the source's
header); on CPU tensors it runs :func:`ransac_mask_plain`, which folds
``next_id`` into the key (:func:`frontend.prng.fold_in`) and calls
:func:`frontend.ransac.ransac_epipolar_mask`, lane by lane.  A CUDA tensor
never takes the plain path: the kernel launches or the op raises.  The op's
vmap rule moves each batched dim to the front, so ``torch.func.vmap``
(nested too) reaches the one launch.

The kernel replaces no TPU kernel (the JAX package's gate is plain JAX).
:func:`ransac_work` is the work the plain version's ops count under
:mod:`eqvio_tpu_torch.cost`'s rules, which the counter gives the op.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..frontend.prng import fold_in
from ..frontend.ransac import ransac_epipolar_mask
from . import build

_SOURCE = "ransac_cuda.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The raw handle of the current stream (kernels/klt.py says why)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or \
    (lambda index: torch.cuda.current_stream(index).cuda_stream)


def smem_bytes(n: int, k: int) -> int:
    """Dynamic shared memory of one block (``csrc/ransac_cuda.cu:smem_bytes``):
    both normalised point sets, the mask, the constraint rows, the ``k x n``
    draws and costs, the hypotheses, their costs and samples."""
    return 4 * (14 * n + k * n + 10 * k) + 4 * 8 * k


def ransac_mask_plain(prev, curr, mask, key, next_id, threshold: float, hypotheses: int, min_points: int,
                      min_inliers: int) -> torch.Tensor:
    """The gate of :func:`ransac_mask` in plain PyTorch: ``fold_in(key,
    next_id)`` and :func:`frontend.ransac.ransac_epipolar_mask`, lane by
    lane, so each lane's numbers are those of a single call."""
    lead = tuple(prev.shape[:-2])
    if not lead:
        return ransac_epipolar_mask(prev, curr, mask, fold_in(key, next_id), threshold, hypotheses, min_points,
                                    min_inliers)
    n = prev.shape[-2]
    keys = key.reshape(-1, 2).expand(math.prod(lead), 2)
    ids = next_id.reshape(-1).expand(math.prod(lead))
    lanes = [ransac_mask_plain(p, c, m, k, i, threshold, hypotheses, min_points, min_inliers)
             for p, c, m, k, i in zip(prev.reshape(-1, n, 2), curr.reshape(-1, n, 2), mask.reshape(-1, n), keys, ids)]
    return torch.stack(lanes).reshape(*lead, n)


# The plain version's count under cost.count, per (hypothesis, track) pair,
# hypothesis, track and call: (operations, bytes).  It depends on the shapes
# alone and is bilinear in them from two hypotheses on;
# tests/test_torch_cost.py holds these to the counter.
_WORK_PAIR = (230, 3492)  # the threefry draw, the score's mask, Sampson, truncation and sum
_WORK_HYPOTHESIS = (3533, 25880)  # the sample gather, the 8-point solve and rank-2 projection
_WORK_TRACK = (270, 926)  # normalisation, the refit's Gram matrix, its Sampson, the refined mask
_WORK_CALL = (2445, 30038)  # fold_in, the refit's solve, the guards


def ransac_work(hypotheses: int, n: int, lanes: int = 1) -> tuple[int, int]:
    """``(bytes, operations)`` that :func:`ransac_mask_plain` counts under
    :func:`eqvio_tpu_torch.cost.count` for ``lanes`` sequences of ``n``
    tracks and ``hypotheses`` (at least 2) hypotheses: the work the torch
    path's kernels did, which the counter gives the op.  The kernel itself
    reads the inputs and writes the mask; its bound is latency (the
    source's header)."""
    k = hypotheses
    ops, nbytes = (a * k * n + b * k + c * n + d for a, b, c, d in
                   zip(_WORK_PAIR, _WORK_HYPOTHESIS, _WORK_TRACK, _WORK_CALL))
    return lanes * nbytes, lanes * ops


@functools.cache
def _fn():
    """The bound C entry point ``ransac_gate_lanes_f32`` (builds the library)."""
    fn = build.load(_SOURCE).ransac_gate_lanes_f32
    fn.argtypes = [_P, _P, _P, _P, _L, _P, _L, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> float:
    """Build (or load) the kernel library; returns the seconds it took."""
    _fn()
    return build.build_seconds[_SOURCE]


@functools.cache
def _smem_limit(index: int) -> int:
    """Dynamic shared memory a block may ask for on the card (Hopper's 227 kB
    where torch does not say), less 1 kB for the kernel's static arrays."""
    props = torch.cuda.get_device_properties(index)
    return getattr(props, "shared_memory_per_block_optin", 232448) - 1024


def _check_cuda_inputs(prev, curr, mask, key, next_id, hypotheses: int) -> tuple[int, int, int]:
    """Raise on inputs the kernel does not take; returns ``(lanes, key lane
    stride, next_id lane stride)`` (0: one for every lane)."""
    dev = prev.device
    lead = tuple(prev.shape[:-2])
    for name, t, dtype, shape in (("prev", prev, torch.float32, None), ("curr", curr, torch.float32, prev.shape),
                                  ("mask", mask, torch.bool, prev.shape[:-1]),
                                  ("key", key, torch.int64, None), ("next_id", next_id, torch.int64, None)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}, got {t.dtype} on {t.device}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, not {tuple(shape)}")
    if prev.dim() < 2 or prev.shape[-1] != 2:
        raise ValueError(f"prev must have shape [..., N, 2], got {tuple(prev.shape)}")
    if tuple(key.shape) not in ((2,), lead + (2,)) or tuple(next_id.shape) not in ((), lead):
        raise ValueError(f"key {tuple(key.shape)} and next_id {tuple(next_id.shape)} must be [2] and [] or lead "
                         f"with the lanes {lead}")
    n = prev.shape[-2]
    if hypotheses < 1:
        raise ValueError(f"the kernel needs at least one hypothesis, got {hypotheses}")
    limit = _smem_limit(dev.index)
    if smem_bytes(n, hypotheses) > limit:
        raise ValueError(f"{hypotheses} hypotheses over {n} tracks need {smem_bytes(n, hypotheses)} bytes of shared "
                         f"memory, more than the {limit} a block can have")
    return math.prod(lead), 0 if key.dim() == 1 else 2, 0 if next_id.dim() == 0 else 1


@torch.library.custom_op("eqvio_tpu_torch::ransac_epipolar_mask", mutates_args=(), device_types="cpu")
def _ransac_op(prev: torch.Tensor, curr: torch.Tensor, mask: torch.Tensor, key: torch.Tensor,
               next_id: torch.Tensor, threshold: float, hypotheses: int, min_points: int,
               min_inliers: int) -> torch.Tensor:
    """The op's CPU implementation: the plain version, lanes and all."""
    return ransac_mask_plain(prev, curr, mask, key, next_id, threshold, hypotheses, min_points, min_inliers)


@_ransac_op.register_kernel("cuda")
def _ransac_cuda(prev, curr, mask, key, next_id, threshold, hypotheses, min_points, min_inliers):
    """The op's CUDA implementation: one launch, one block per lane; raises
    on what the kernel does not take."""
    if prev.device.type != "cuda":
        raise ValueError(f"prev on {prev.device}, other inputs on the card: all inputs must share a device")
    lanes, key_stride, id_stride = _check_cuda_inputs(prev, curr, mask, key, next_id, hypotheses)
    out = torch.empty_like(mask)
    n = mask.shape[-1]
    if lanes * n == 0:
        return out
    fn = _fn()
    args = (prev.data_ptr(), curr.data_ptr(), mask.data_ptr(), key.data_ptr(), key_stride, next_id.data_ptr(),
            id_stride, out.data_ptr(), lanes, n, hypotheses, float(threshold) ** 2, max(int(min_points), 8),
            int(min_inliers))
    dev = prev.device
    stream = _raw_stream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        ransac_mask.captured += 1  # a node of the graph being captured: its replays launch it
    else:
        ransac_mask.launches += 1
    return out


@_ransac_op.register_fake
def _ransac_fake(prev, curr, mask, key, next_id, threshold, hypotheses, min_points, min_inliers):
    return torch.empty_like(mask)


def _lane_arg(t: torch.Tensor, d, lead: tuple, tail: int) -> torch.Tensor:
    """``key`` (``tail`` 1) or ``next_id`` (``tail`` 0) for the lanes
    ``lead`` (the batched dim first): kept as it is where no lane dim
    batches it, else ``[*lead, *tail]``, contiguous."""
    if d is None and t.dim() == tail:
        return t
    t = t.movedim(d, 0) if d is not None else t.unsqueeze(0)
    t = t.reshape(t.shape[0], *([1] * (len(lead) - t.dim() + tail)), *t.shape[1:])
    return t.expand(*lead, *t.shape[len(lead):]).contiguous()


def _ransac_vmap(info, in_dims, prev, curr, mask, key, next_id, threshold, hypotheses, min_points, min_inliers):
    """vmap rule: the batched dim to the front (the unbatched point sets and
    masks expanded; a key or counter no lane batches stays shared), and the
    op called again on plain tensors, so one launch serves every lane."""
    def front(t, d):
        t = t.unsqueeze(0).expand(info.batch_size, *t.shape) if d is None else t.movedim(d, 0)
        return t.contiguous()

    prev_d, curr_d, mask_d, key_d, id_d = in_dims[:5]
    prev, curr, mask = front(prev, prev_d), front(curr, curr_d), front(mask, mask_d)
    lead = tuple(prev.shape[:-2])
    out = _ransac_op(prev, curr, mask, _lane_arg(key, key_d, lead, 1), _lane_arg(next_id, id_d, lead, 0),
                     threshold, hypotheses, min_points, min_inliers)
    return out, 0


torch.library.register_vmap(_ransac_op, _ransac_vmap)


def ransac_mask(prev, curr, mask, key, next_id, threshold: float = 1.0, hypotheses: int = 64, min_points: int = 8,
                min_inliers: int = 8) -> torch.Tensor:
    """Refine ``mask [*L, N]`` by epipolar-consistency RANSAC between
    ``prev`` and ``curr`` ``[*L, N, 2]``, drawing the hypotheses from
    ``fold_in(key, next_id)``; the arguments as
    :func:`frontend.ransac.ransac_epipolar_mask`'s, and its result.

    CPU tensors take the plain version.  CUDA tensors launch the kernel once
    for all lanes on the current stream and count the launch in
    ``ransac_mask.launches``; a call during a CUDA graph capture records the
    kernel into the graph and counts in ``ransac_mask.captured`` instead.
    """
    return _ransac_op(prev, curr, mask, key, next_id, float(threshold), int(hypotheses), int(min_points),
                      int(min_inliers))


ransac_mask.launches = 0
ransac_mask.captured = 0
