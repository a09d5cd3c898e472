"""Image pyramids for coarse-to-fine tracking (counterpart of
``eqvio_tpu/frontend/pyramid.py``).

The 5-tap binomial blur with 2x decimation is a zero-padded strided
convolution, run as its two separable passes (rows, then columns) without
renormalisation at the borders: exactly the banded matrix product
``V @ img @ H^T`` of the reference.  Output size is ``ceil(n / 2)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime import const

_TAPS = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)


def blur_downsample(img: torch.Tensor) -> torch.Tensor:
    """``[H, W] -> [ceil(H/2), ceil(W/2)]``."""
    taps = const(_TAPS, img.dtype, img.device)
    x = F.conv2d(img[None, None], taps.view(1, 1, 5, 1), stride=(2, 1), padding=(2, 0))
    x = F.conv2d(x, taps.view(1, 1, 1, 5), stride=(1, 2), padding=(0, 2))
    return x[0, 0]


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """``levels`` images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(blur_downsample(pyr[-1]))
    return pyr


def pyramid_shapes(height: int, width: int, levels: int) -> list[tuple[int, int]]:
    shapes = [(height, width)]
    for _ in range(levels - 1):
        h, w = shapes[-1]
        shapes.append((-(-h // 2), -(-w // 2)))
    return shapes
