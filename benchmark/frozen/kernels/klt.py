"""Pyramidal Lucas-Kanade, plain version: a frozen copy of the gather path
of ``eqvio_tpu_torch/kernels/klt.py`` (the version its CUDA kernel is
checked against), with :func:`klt_work` and :func:`bound_ms`, the bytes and
operations that set the kernel's least time on an H100.  No kernel here:
:func:`klt_track_pyramid` is the plain version on every device."""

from __future__ import annotations

import math

import torch

from ..runtime import const

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


# the plain version is the reference's tracker, on every device
klt_track_pyramid = klt_track_pyramid_plain
