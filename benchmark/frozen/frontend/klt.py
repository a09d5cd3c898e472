"""Pyramidal Lucas-Kanade feature tracking, batched over features
(counterpart of ``eqvio_tpu/frontend/klt.py``).

The tracking itself is :func:`eqvio_tpu_torch.kernels.klt.klt_track_pyramid`:
the hand-written CUDA kernel on the card, its plain gather-path version on
the CPU.  This module adds the tracked-feature gate.  The TPU's matmul
("mxu") interpolation path has no counterpart: gathers are cheap here.
"""

from __future__ import annotations

import torch

from ..kernels.klt import klt_track_pyramid


def track_features(
    pyr_prev: list[torch.Tensor],
    pyr_next: list[torch.Tensor],
    positions: torch.Tensor,
    mask: torch.Tensor,
    predicted: torch.Tensor | None = None,
    win: int = 21,
    iters: int = 8,
    max_error: float = 0.05,
):
    """Track all features ``positions [N, 2]`` from ``pyr_prev`` to ``pyr_next``.

    Returns ``(new_positions [N, 2], tracked [N])``; ``tracked`` clears
    features that left the image margin or whose mean residual reached
    ``max_error`` (GIFT ``maxError``).
    """
    guesses = positions if predicted is None else predicted
    new_pos, errs = klt_track_pyramid(
        list(pyr_prev), list(pyr_next), positions.contiguous(), guesses.contiguous(), win, iters
    )
    return new_pos, tracked_mask(new_pos, errs, mask, pyr_prev[0].shape, win, max_error)


def tracked_mask(new_pos, errs, mask, image_shape, win: int = 21, max_error: float = 0.05) -> torch.Tensor:
    """The tracked-feature gate of :func:`track_features`: ``mask`` where
    ``new_pos [N, 2]`` stays inside the image margin of ``image_shape (H,
    W)`` and the mean residual ``errs [N]`` is below ``max_error``."""
    H, W = image_shape
    margin = (win - 1) / 2 + 2
    inside = (
        (new_pos[:, 0] >= margin)
        & (new_pos[:, 0] < W - margin)
        & (new_pos[:, 1] >= margin)
        & (new_pos[:, 1] < H - margin)
    )
    return mask & inside & (errs < max_error)
