"""Pyramidal Lucas-Kanade: the CUDA kernel's wrapper and its plain version.

:func:`klt_track_pyramid` tracks N features through all pyramid levels,
coarse to fine, for one sequence or for lanes of sequences: every argument
may carry the same leading lane dims (levels ``[*L, H_l, W_l]``, positions
and guesses ``[*L, N, 2]``).  It is the custom op
``eqvio_tpu_torch::klt_track_pyramid``: on CUDA tensors it launches
``csrc/klt_cuda.cu`` once for all lanes and levels (see the source's
header); on CPU tensors it runs :func:`klt_track_pyramid_plain`, the
vectorised gather path that the kernel is checked against.  A CUDA tensor
never takes the plain path: the kernel launches or the op raises.  The op's
vmap rule moves each batched dim to the front and expands the unbatched
arguments, so ``torch.func.vmap`` (nested too) reaches the one launch.

The kernel replaces ``eqvio_tpu/frontend/pallas_klt.py:_klt_kernel_body``.
Beside the plain version sit a Python mirror of the kernel's shared-memory
tile geometry (:func:`tile_corner`, :func:`window_in_tile`,
:func:`bilinear_tiled`), which the CPU tests hold to :func:`bilinear`, and
:func:`klt_work`, the bytes and operations that set the kernel's bound.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..runtime import const
from . import build

_SOURCE = "klt_cuda.cu"
MAX_LEVELS = 8


# ---------------------------------------------------------------------------
# Plain PyTorch version (the gather path of eqvio_tpu/frontend/klt.py)
# ---------------------------------------------------------------------------


def bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img [*L, H, W]`` at ``xy [*L, ..., 2]`` (x, y),
    each sample clamped to ``[0, W - 1.001] x [0, H - 1.001]``; the lane
    dims ``L`` (if any) lead both."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    base = y0 * W + x0
    if lead:
        flat = img.reshape(*lead, H * W)
        at = lambda k: torch.gather(flat, -1, k.reshape(*lead, -1)).reshape(k.shape)  # noqa: E731
    else:
        flat = img.reshape(-1)
        at = lambda k: flat[k]  # noqa: E731
    i00 = at(base)
    i01 = at(base + 1)
    i10 = at(base + W)
    i11 = at(base + W + 1)
    return i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy) + i10 * (1 - fx) * fy + i11 * fx * fy


def _window_offsets(win: int, dtype, device) -> torch.Tensor:
    """``[win, win, 2]`` offsets: sample (row j, column i) at (i - r, j - r)."""
    offs = torch.arange(win, dtype=dtype, device=device) - (win - 1) / 2.0
    ox = offs[None, :].expand(win, win)
    oy = offs[:, None].expand(win, win)
    return torch.stack([ox, oy], dim=-1)


def track_level(img_prev, img_next, pos_prev, guess, win: int, iters: int):
    """One pyramid level of LK for all features ``[*L, N, 2]`` (images
    ``[*L, H, W]``); returns ``(positions [*L, N, 2], err [*L, N])``."""
    dtype = pos_prev.dtype
    offs = _window_offsets(win, dtype, pos_prev.device)
    coords = pos_prev[..., :, None, None, :] + offs
    template = bilinear(img_prev, coords)
    ex = const((1.0, 0.0), dtype, pos_prev.device)
    ey = const((0.0, 1.0), dtype, pos_prev.device)
    gx = bilinear(img_prev, coords + ex) - bilinear(img_prev, coords - ex)
    gy = bilinear(img_prev, coords + ey) - bilinear(img_prev, coords - ey)
    gxx = torch.sum(gx * gx, dim=(-2, -1))
    gxy = torch.sum(gx * gy, dim=(-2, -1))
    gyy = torch.sum(gy * gy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)

    p = guess
    err = torch.full_like(gxx, float("inf"))
    for _ in range(iters):
        diff = bilinear(img_next, p[..., :, None, None, :] + offs) - template
        bx = torch.sum(diff * gx, dim=(-2, -1))
        by = torch.sum(diff * gy, dim=(-2, -1))
        dx = (gyy * bx - gxy * by) / det
        dy = (gxx * by - gxy * bx) / det
        p = p - torch.stack([dx, dy], dim=-1)
        err = torch.mean(torch.abs(diff), dim=(-2, -1))
    return p, err


def klt_track_pyramid_plain(pyr_prev, pyr_next, positions, guesses, win: int = 21, iters: int = 8):
    """Coarse-to-fine LK over all levels: ``(positions [*L, N, 2], err
    [*L, N])``, ``err`` from the finest level; lane dims ``L`` as in
    :func:`klt_track_pyramid`."""
    levels = len(pyr_prev)
    p = guesses / 2.0 ** (levels - 1)
    err = positions.new_zeros(positions.shape[:-1])
    for lvl in range(levels - 1, -1, -1):
        if lvl < levels - 1:
            p = p * 2.0
        p, err = track_level(pyr_prev[lvl], pyr_next[lvl], positions / 2.0**lvl, p, win, iters)
    return p, err


# ---------------------------------------------------------------------------
# The kernel's tile geometry, mirrored for the CPU tests
# ---------------------------------------------------------------------------


def tile_corner(cx: float, cy: float, reach: float, extent: int, width: int, height: int):
    """``(x0, y0, w, h)`` of the kernel's staged tile (``csrc/klt_cuda.cu:tile_at``):
    pitch ``extent``, covering the footprints of samples within ``reach`` px
    of ``(cx, cy)``, corner clamped into the ``width x height`` image; the
    arithmetic is float32 as on the card.  The kernel's prev tile has
    ``reach = r + 1`` and ``extent = win + 3``, with ``r = (win - 1) / 2``."""
    x0 = int(np.floor(np.float32(cx) - np.float32(reach)))
    y0 = int(np.floor(np.float32(cy) - np.float32(reach)))
    return (max(0, min(x0, width - extent)), max(0, min(y0, height - extent)),
            min(extent, width), min(extent, height))


def stage_tile(img: torch.Tensor, corner, extent: int) -> torch.Tensor:
    """The ``[extent, extent]`` tile the kernel copies to shared memory
    (pixels outside the image part stay unwritten; zeros here)."""
    x0, y0, w, h = corner
    tile = torch.zeros(extent, extent, dtype=img.dtype)
    tile[:h, :w] = img[y0:y0 + h, x0:x0 + w]
    return tile


def window_in_tile(corner, lo, hi, width: int, height: int) -> bool:
    """Whether the clamped 2x2 footprints of all samples with coordinates in
    ``[lo, hi]`` (x, y) lie in the tile (``csrc/klt_cuda.cu:span_in``):
    clamp and floor are monotone, so the two extreme samples decide."""
    x0, y0, w, h = corner

    def span(a, b, vmax, t0, extent):
        vmax = np.float32(vmax)
        fa = int(np.floor(min(max(np.float32(a), np.float32(0)), vmax))) - t0
        fb = int(np.floor(min(max(np.float32(b), np.float32(0)), vmax))) - t0
        return fa >= 0 and fb <= extent - 2

    return span(lo[0], hi[0], width - 1.001, x0, w) and span(lo[1], hi[1], height - 1.001, y0, h)


def bilinear_tiled(img: torch.Tensor, tile: torch.Tensor, corner, xy: torch.Tensor):
    """:func:`bilinear` of one window ``xy [..., 2]`` as the kernel reads it:
    from the staged tile when every sample's clamped 2x2 footprint lies in
    it (:func:`window_in_tile` on the extreme samples), else from the image.
    Returns ``(values, from_tile)``."""
    H, W = img.shape
    flat = xy.reshape(-1, 2)
    lo, hi = flat.min(0).values.tolist(), flat.max(0).values.tolist()
    if not window_in_tile(corner, lo, hi, W, H):
        return bilinear(img, xy), False
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    xf, yf = torch.floor(x), torch.floor(y)
    fx, fy = x - xf, y - yf
    pitch = tile.shape[1]
    base = (yf.to(torch.int64) - corner[1]) * pitch + (xf.to(torch.int64) - corner[0])
    t = tile.reshape(-1)
    i00, i01, i10, i11 = t[base], t[base + 1], t[base + pitch], t[base + pitch + 1]
    return i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy) + i10 * (1 - fx) * fy + i11 * fx * fy, True


# ---------------------------------------------------------------------------
# Work of one call, for the bound
# ---------------------------------------------------------------------------

# float32 operations per window sample and level: the template stage (two
# centre coordinates, four shifted ones, five bilinear samples of 21 each:
# 4 clamp, 2 floor, 2 fraction, 2 one-minus, 8 multiply, 3 add; two gradient
# differences; three products and three sums for the normal matrix)
_OPS_TEMPLATE = 2 + 4 + 5 * 21 + 2 + 6
# and per Gauss-Newton step: two coordinates, one bilinear sample, the
# residual, and three products-and-sums (|d| counted as one operation)
_OPS_STEP = 2 + 21 + 1 + 2 + 2 + 2
# per feature and level: two centre divisions, the determinant (3) and its
# floor test, and per step the 2x2 solve (8), the update (2) and err (1)
_OPS_LEVEL = 2 + 4
_OPS_LEVEL_STEP = 8 + 2 + 1


def klt_work(n: int, level_shapes, win: int, iters: int, lanes: int = 1) -> tuple[int, int]:
    """``(bytes, float32 operations)`` that tracking ``n`` features in each
    of ``lanes`` sequences through pyramids of ``level_shapes [(H, W), ...]``
    needs, the count a bound is taken from: ``lanes x n`` features.  Bytes: per feature and level the prev neighbourhood of
    ``(win + 3)^2`` pixels and one next-image window footprint of
    ``(win + 1)^2``, both cut to the image, read once; positions and guesses
    read, positions and err written.  Operations: those of the plain
    version's arithmetic, fixed for fixed ``iters`` (the loop has no early
    exit)."""
    per_feature_bytes = 2 * 8 + 12
    for h, w in level_shapes:
        per_feature_bytes += 4 * (min(win + 3, w) * min(win + 3, h) + min(win + 1, w) * min(win + 1, h))
    samples = win * win
    per_level_ops = (samples * (_OPS_TEMPLATE + iters * _OPS_STEP)
                     + _OPS_LEVEL + iters * _OPS_LEVEL_STEP)
    n = n * lanes
    return n * per_feature_bytes, n * len(level_shapes) * per_level_ops


# NVIDIA H100 SXM peaks (data sheet): HBM3 bytes/s, float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


def bound_ms(n: int, level_shapes, win: int, iters: int, lanes: int = 1) -> tuple[float, str]:
    """The least time an H100 SXM could take for :func:`klt_work`:
    ``(ms, "bytes" | "operations")``."""
    nbytes, ops = klt_work(n, level_shapes, win, iters, lanes)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# ctypes level arrays by (pointers, lane strides, shapes): the tracker
# alternates between a few pyramid buffers, so a frame's call finds its
# arrays here
_level_args: dict[tuple, tuple] = {}
_LEVEL_ARGS_KEEP = 16
# The raw handle of the current stream: torch.cuda.current_stream(dev)
# builds a Stream object per call, about 10 us on the H100's host (PERF.md).
# The private call is missing from CPU-only builds and may leave later
# torch versions, so the public one stands in.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or \
    (lambda index: torch.cuda.current_stream(index).cuda_stream)


@functools.cache
def _fn():
    """The bound C entry point ``klt_track_pyramid_lanes_f32`` (builds the library)."""
    fn = build.load(_SOURCE).klt_track_pyramid_lanes_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> float:
    """Build (or load) the kernel library; returns the seconds it took."""
    _fn()
    return build.build_seconds[_SOURCE]


def _lane_stride(t: torch.Tensor, lead) -> int | None:
    """The one stride (in elements) from a lane's ``[H, W]`` image to the
    next when the lane dims ``lead`` of ``t`` are flattened, or None when
    they do not flatten to one stride (0: every lane reads one image)."""
    stride, span = None, 1
    for size, st in reversed(list(zip(lead, t.stride()[:len(lead)]))):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != stride * span:
            return None
        span *= size
    return stride or 0


def _check_cuda_inputs(pyr_prev, pyr_next, positions, guesses) -> tuple:
    """Raise on inputs the kernel does not take; returns ``(lanes, key,
    copies)``: the key (data pointers, lane strides and shapes of the
    pyramids) of :data:`_level_args`, and the copies made of levels whose
    lane dims do not flatten to one stride (a nested vmap can leave such
    views), which the caller keeps until the launch is enqueued."""
    levels = len(pyr_prev)
    if levels < 1 or levels > MAX_LEVELS or len(pyr_next) != levels:
        raise ValueError(f"need 1..{MAX_LEVELS} levels in both pyramids, got {levels}/{len(pyr_next)}")
    dev = positions.device
    f32 = torch.float32
    lead = tuple(positions.shape[:-2])
    for name, t in (("positions", positions), ("guesses", guesses)):
        if t.device != dev or t.dtype != f32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")
        if t.dim() < 2 or t.shape[-1] != 2 or t.shape != positions.shape:
            raise ValueError(f"{name} must have shape [..., N, 2] like positions, got {tuple(t.shape)}")
    on_dev = (lambda t: t.is_cuda and t.get_device() == dev.index) if dev.type == "cuda" else \
        (lambda t: t.device == dev)
    key, copies = [], []
    for lvl, (a, b) in enumerate(zip(pyr_prev, pyr_next)):
        shape = a.shape
        if not (on_dev(a) and on_dev(b) and a.dtype == f32 and b.dtype == f32):
            raise ValueError(f"pyramid level {lvl} must be float32 on {dev}")
        if len(shape) != len(lead) + 2 or tuple(shape[:-2]) != lead or b.shape != shape or \
                shape[-2] < 2 or shape[-1] < 2:
            raise ValueError(f"pyramid level {lvl} shapes differ, are too small or do not lead with the "
                             f"positions' lanes {lead}: {tuple(a.shape)} vs {tuple(b.shape)}")
        h, w = shape[-2:]
        ptrs = []
        for t in (a, b):
            if t.stride()[-2:] != (w, 1):
                raise ValueError(f"pyramid level {lvl} must have contiguous [H, W] images")
            stride = _lane_stride(t, lead)
            if stride is None:
                t = t.contiguous()
                stride = h * w
                copies.append(t)
            ptrs.append((t.data_ptr(), stride))
        key += (ptrs[0][0], ptrs[1][0], ptrs[0][1], ptrs[1][1], h, w)
    return math.prod(lead), tuple(key), copies


def _level_arrays(key: tuple) -> tuple:
    """``(prev pointers, next pointers, prev lane strides, next lane
    strides, heights, widths)`` as ctypes arrays."""
    args = _level_args.get(key)
    if args is None:
        levels = len(key) // 6
        u64, i64, i32 = ctypes.c_uint64 * levels, ctypes.c_longlong * levels, ctypes.c_int * levels
        args = (u64(*key[0::6]), u64(*key[1::6]), i64(*key[2::6]), i64(*key[3::6]), i32(*key[4::6]),
                i32(*key[5::6]))
        if len(_level_args) >= _LEVEL_ARGS_KEEP:
            _level_args.clear()
        _level_args[key] = args
    return args


@torch.library.custom_op("eqvio_tpu_torch::klt_track_pyramid", mutates_args=(), device_types="cpu")
def _klt_op(pyr_prev: list[torch.Tensor], pyr_next: list[torch.Tensor], positions: torch.Tensor,
            guesses: torch.Tensor, win: int, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The op's CPU implementation: the plain version, lanes and all."""
    return klt_track_pyramid_plain(pyr_prev, pyr_next, positions, guesses, win, iters)


@_klt_op.register_kernel("cuda")
def _klt_cuda(pyr_prev, pyr_next, positions, guesses, win, iters):
    """The op's CUDA implementation: one launch for every lane, level and
    feature; raises on what the kernel does not take."""
    if positions.device.type != "cuda":
        raise ValueError(f"positions on {positions.device}, pyramids on the card: all inputs must share a device")
    lanes, key, copies = _check_cuda_inputs(pyr_prev, pyr_next, positions, guesses)
    if win * win > 1024 or win < 1 or iters < 1:
        raise ValueError(f"kernel takes 1 <= win*win <= 1024 and iters >= 1 (win={win}, iters={iters})")
    n = positions.shape[-2]
    out_pos = torch.empty_like(positions)
    out_err = positions.new_empty(positions.shape[:-1])
    if n * lanes == 0:
        return out_pos, out_err
    fn = _fn()
    args = (*_level_arrays(key), len(pyr_prev), lanes, positions.data_ptr(), guesses.data_ptr(),
            out_pos.data_ptr(), out_err.data_ptr(), n, win, iters)
    dev = positions.device
    stream = _raw_stream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    del copies  # enqueued: the stream orders any reuse of their memory after the kernel
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    if not torch.cuda.is_current_stream_capturing():
        # under capture the call records a graph node and launches nothing
        klt_track_pyramid.launches += 1
    return out_pos, out_err


@_klt_op.register_fake
def _klt_fake(pyr_prev, pyr_next, positions, guesses, win, iters):
    return torch.empty_like(positions), positions.new_empty(positions.shape[:-1])


def _klt_vmap(info, in_dims, pyr_prev, pyr_next, positions, guesses, win, iters):
    """vmap rule: each batched dim to the front, the unbatched arguments
    expanded (a pyramid shared by every lane as a stride-0 view), and the op
    called again on plain tensors, so one launch serves every lane."""
    def front(t, d):
        return t.unsqueeze(0).expand(info.batch_size, *t.shape) if d is None else t.movedim(d, 0)

    def levels(pyr, dims):
        dims = dims if isinstance(dims, (list, tuple)) else [dims] * len(pyr)
        return [front(t, d) for t, d in zip(pyr, dims)]

    prev_d, next_d, pos_d, guess_d = in_dims[:4]
    out = _klt_op(levels(pyr_prev, prev_d), levels(pyr_next, next_d), front(positions, pos_d).contiguous(),
                  front(guesses, guess_d).contiguous(), win, iters)
    return out, (0, 0)


torch.library.register_vmap(_klt_op, _klt_vmap)


def klt_track_pyramid(pyr_prev, pyr_next, positions, guesses, win: int = 21, iters: int = 8):
    """Track ``positions [*L, N, 2]`` (full-resolution x, y) from
    ``pyr_prev`` to ``pyr_next`` (levels ``[*L, H_l, W_l]``) starting at
    ``guesses``; returns ``(positions, err [*L, N])``.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    once for all lanes on the current stream and count the launch in
    ``klt_track_pyramid.launches``; a call during a CUDA graph capture only
    records the kernel into the graph and is not counted (the graph's
    replays launch it; the profiler counts those).
    """
    return _klt_op(list(pyr_prev), list(pyr_next), positions, guesses, win, iters)


klt_track_pyramid.launches = 0
