"""Pyramidal Lucas-Kanade: the CUDA kernel's wrapper and its plain version.

:func:`klt_track_pyramid` tracks N features through all pyramid levels,
coarse to fine.  On CUDA tensors it launches ``csrc/klt_cuda.cu`` (one launch
for every level, see the source's header); on CPU tensors it runs
:func:`klt_track_pyramid_plain`, the vectorised gather path that the kernel
is checked against.  A CUDA tensor never takes the plain path: the kernel
launches or the wrapper raises.

The kernel replaces ``eqvio_tpu/frontend/pallas_klt.py:_klt_kernel_body``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_SOURCE = "klt_cuda.cu"
MAX_LEVELS = 8


# ---------------------------------------------------------------------------
# Plain PyTorch version (the gather path of eqvio_tpu/frontend/klt.py)
# ---------------------------------------------------------------------------


def bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img [H, W]`` at ``xy [..., 2]`` (x, y), each
    sample clamped to ``[0, W - 1.001] x [0, H - 1.001]``."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    flat = img.reshape(-1)
    base = y0 * W + x0
    i00 = flat[base]
    i01 = flat[base + 1]
    i10 = flat[base + W]
    i11 = flat[base + W + 1]
    return i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy) + i10 * (1 - fx) * fy + i11 * fx * fy


def _window_offsets(win: int, dtype, device) -> torch.Tensor:
    """``[win, win, 2]`` offsets: sample (row j, column i) at (i - r, j - r)."""
    offs = torch.arange(win, dtype=dtype, device=device) - (win - 1) / 2.0
    ox = offs[None, :].expand(win, win)
    oy = offs[:, None].expand(win, win)
    return torch.stack([ox, oy], dim=-1)


def track_level(img_prev, img_next, pos_prev, guess, win: int, iters: int):
    """One pyramid level of LK for all features ``[N, 2]``; returns
    ``(positions [N, 2], err [N])``."""
    dtype = pos_prev.dtype
    offs = _window_offsets(win, dtype, pos_prev.device)
    coords = pos_prev[:, None, None, :] + offs
    template = bilinear(img_prev, coords)
    ex = torch.tensor([1.0, 0.0], dtype=dtype, device=pos_prev.device)
    ey = torch.tensor([0.0, 1.0], dtype=dtype, device=pos_prev.device)
    gx = bilinear(img_prev, coords + ex) - bilinear(img_prev, coords - ex)
    gy = bilinear(img_prev, coords + ey) - bilinear(img_prev, coords - ey)
    gxx = torch.sum(gx * gx, dim=(1, 2))
    gxy = torch.sum(gx * gy, dim=(1, 2))
    gyy = torch.sum(gy * gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)

    p = guess
    err = torch.full_like(gxx, float("inf"))
    for _ in range(iters):
        diff = bilinear(img_next, p[:, None, None, :] + offs) - template
        bx = torch.sum(diff * gx, dim=(1, 2))
        by = torch.sum(diff * gy, dim=(1, 2))
        dx = (gyy * bx - gxy * by) / det
        dy = (gxx * by - gxy * bx) / det
        p = p - torch.stack([dx, dy], dim=-1)
        err = torch.mean(torch.abs(diff), dim=(1, 2))
    return p, err


def klt_track_pyramid_plain(pyr_prev, pyr_next, positions, guesses, win: int = 21, iters: int = 8):
    """Coarse-to-fine LK over all levels: ``(positions [N, 2], err [N])``,
    ``err`` from the finest level."""
    levels = len(pyr_prev)
    p = guesses / 2.0 ** (levels - 1)
    err = torch.zeros(positions.shape[0], dtype=positions.dtype, device=positions.device)
    for lvl in range(levels - 1, -1, -1):
        if lvl < levels - 1:
            p = p * 2.0
        p, err = track_level(pyr_prev[lvl], pyr_next[lvl], positions / 2.0**lvl, p, win, iters)
    return p, err


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _lib():
    lib = build.load(_SOURCE)
    fn = lib.klt_track_pyramid_f32
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, ctypes.c_int, P, P, P, P,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, P]
        fn.restype = ctypes.c_int
    return lib


def build_kernel() -> float:
    """Build (or load) the kernel library; returns the seconds it took."""
    _lib()
    return build.build_seconds[_SOURCE]


def _check_cuda_inputs(pyr_prev, pyr_next, positions, guesses):
    levels = len(pyr_prev)
    if levels < 1 or levels > MAX_LEVELS or len(pyr_next) != levels:
        raise ValueError(f"need 1..{MAX_LEVELS} levels in both pyramids, got {levels}/{len(pyr_next)}")
    dev = positions.device
    for name, t in (("positions", positions), ("guesses", guesses)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")
        if t.dim() != 2 or t.shape[1] != 2 or t.shape[0] != positions.shape[0]:
            raise ValueError(f"{name} must have shape [N, 2], got {tuple(t.shape)}")
    for lvl, (a, b) in enumerate(zip(pyr_prev, pyr_next)):
        for t in (a, b):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"pyramid level {lvl} must be contiguous float32 on {dev}")
            if t.dim() != 2 or t.shape != a.shape or min(t.shape) < 2:
                raise ValueError(f"pyramid level {lvl} shapes differ or are too small: "
                                 f"{tuple(a.shape)} vs {tuple(b.shape)}")


def klt_track_pyramid(pyr_prev, pyr_next, positions, guesses, win: int = 21, iters: int = 8):
    """Track ``positions [N, 2]`` (full-resolution x, y) from ``pyr_prev`` to
    ``pyr_next`` starting at ``guesses``; returns ``(positions, err)``.

    CPU tensors take the plain version.  CUDA tensors launch the kernel on
    the current stream and count the launch in ``klt_track_pyramid.launches``.
    """
    if positions.device.type == "cpu":
        return klt_track_pyramid_plain(pyr_prev, pyr_next, positions, guesses, win, iters)
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    _check_cuda_inputs(pyr_prev, pyr_next, positions, guesses)
    if win * win > 1024 or win < 1 or iters < 1:
        raise ValueError(f"kernel takes 1 <= win*win <= 1024 and iters >= 1 (win={win}, iters={iters})")
    n = positions.shape[0]
    out_pos = torch.empty_like(positions)
    out_err = torch.empty(n, dtype=torch.float32, device=positions.device)
    if n == 0:
        return out_pos, out_err
    levels = len(pyr_prev)
    u64 = ctypes.c_uint64 * levels
    i32 = ctypes.c_int * levels
    prev_ptrs = u64(*[t.data_ptr() for t in pyr_prev])
    next_ptrs = u64(*[t.data_ptr() for t in pyr_next])
    heights = i32(*[t.shape[0] for t in pyr_prev])
    widths = i32(*[t.shape[1] for t in pyr_prev])
    fn = _lib().klt_track_pyramid_f32
    with torch.cuda.device(positions.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(prev_ptrs, next_ptrs, heights, widths, levels,
                positions.data_ptr(), guesses.data_ptr(), out_pos.data_ptr(), out_err.data_ptr(),
                n, win, iters, stream)
    if rc != 0:
        raise RuntimeError(f"klt_track_pyramid_f32 launch failed: CUDA error {rc}")
    klt_track_pyramid.launches += 1
    return out_pos, out_err


klt_track_pyramid.launches = 0
