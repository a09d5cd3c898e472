"""Corner detection: Shi-Tomasi response, non-max suppression, top-K
selection (counterpart of ``eqvio_tpu/frontend/detector.py``).

Separable filters run as two zero-padded ``conv2d`` passes (rows, then
columns), the order of the reference's banded products ``V @ img @ H^T``.
Candidate ranking uses an explicit stable ``(-score, index)`` order, so ties
go to the lower flat index as in ``lax.top_k``; ``torch.topk`` gives no tie
order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime import const


def _sep_filter(img: torch.Tensor, v_taps: tuple, h_taps: tuple) -> torch.Tensor:
    kv = const(v_taps, img.dtype, img.device)
    kh = const(h_taps, img.dtype, img.device)
    rv, rh = (len(v_taps) - 1) // 2, (len(h_taps) - 1) // 2
    x = F.conv2d(img[None, None], kv.view(1, 1, -1, 1), padding=(rv, 0))
    x = F.conv2d(x, kh.view(1, 1, 1, -1), padding=(0, rh))
    return x[0, 0]


def sobel_gradients(img: torch.Tensor):
    smooth = (0.25, 0.5, 0.25)
    diff = (-0.5, 0.0, 0.5)
    return _sep_filter(img, smooth, diff), _sep_filter(img, diff, smooth)


def harris_score(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Shi-Tomasi (minimum eigenvalue) corner response ``[H, W]``."""
    Ix, Iy = sobel_gradients(img)
    box = tuple([1.0 / window] * window)
    Ixx = _sep_filter(Ix * Ix, box, box)
    Iyy = _sep_filter(Iy * Iy, box, box)
    Ixy = _sep_filter(Ix * Iy, box, box)
    half_tr = 0.5 * (Ixx + Iyy)
    disc = torch.sqrt(torch.clamp((0.5 * (Ixx - Iyy)) ** 2 + Ixy * Ixy, min=0.0))
    return half_tr - disc


def _max_pool_same(x: torch.Tensor, size: int) -> torch.Tensor:
    """Separable ``size x size`` max filter with -inf padding (odd ``size``)."""
    r = size // 2
    row = F.max_pool2d(x[None, None], (1, size), stride=1, padding=(0, r))
    return F.max_pool2d(row, (size, 1), stride=1, padding=(r, 0))[0, 0]


def detect_features(
    img: torch.Tensor,
    max_features: int,
    min_dist: int = 20,
    quality: float = 0.05,
    border: int = 21,
    exclude: torch.Tensor | None = None,
    exclude_mask: torch.Tensor | None = None,
    exclude_dist: float = 20.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to ``max_features`` corners ``(positions [K, 2] (x, y), valid [K])``,
    at least ``exclude_dist`` from the live tracks ``exclude [M, 2]``."""
    H, W = img.shape
    score = harris_score(img)
    peak = torch.max(score)
    is_max = (score >= _max_pool_same(score, 2 * min_dist + 1) - 1e-12) & (score > quality * peak)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inside = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    cand_score = torch.where(is_max & inside, score, torch.full_like(score, -float("inf")))

    K2 = max_features * 3 if exclude is not None else max_features
    vals, lin = torch.sort(cand_score.reshape(-1), descending=True, stable=True)
    vals, lin = vals[:K2], lin[:K2]
    pos = torch.stack([(lin % W).to(img.dtype), (lin // W).to(img.dtype)], dim=-1)
    valid = torch.isfinite(vals) & (vals > 0)

    if exclude is not None:
        ex = torch.where(exclude_mask[:, None], exclude, torch.full_like(exclude, -1e6))
        d2 = torch.sum((pos[:, None, :] - ex[None, :, :]) ** 2, dim=-1)
        valid = valid & (torch.min(d2, dim=1).values > exclude_dist**2)
        # compact the first max_features surviving candidates, stably
        order = torch.argsort((~valid).to(torch.int32), stable=True)
        pos = pos[order][:max_features]
        valid = valid[order][:max_features]
    return pos, valid


def equalize_histogram(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Histogram equalisation of a [0, 1] float32 image (GIFT
    ``equaliseImageHistogram``).

    The histogram is an out-of-place ``scatter_add`` into ``bins`` float32
    bins (the in-place form cannot take a lane axis under ``torch.func.vmap``),
    never ``torch.bincount``, which sizes its output on the host.  Counts are whole
    numbers below 2^24, so the float32 sums and their cumulative sum are
    exact in any order."""
    flat = torch.clamp(img.reshape(-1), 0.0, 1.0)
    idx = torch.clamp((flat * (bins - 1)).to(torch.int64), 0, bins - 1)
    hist = torch.zeros(bins, dtype=img.dtype, device=img.device).scatter_add(0, idx, torch.ones_like(flat))
    cdf = torch.cumsum(hist, dim=0)
    cdf = (cdf - cdf[0]) / torch.clamp(cdf[-1] - cdf[0], min=1.0)
    return cdf[idx].reshape(img.shape)
