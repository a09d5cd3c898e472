"""Slot-based point-feature tracker (counterpart of
``eqvio_tpu/frontend/tracker.py``): optional histogram equalisation, KLT
tracking, the epipolar RANSAC gate, the median-flow gate, gated Shi-Tomasi
re-detection and slot refill under the fixed-capacity slot protocol the
filter shares.

The detector gate (``featureSearchThreshold``) is decided on the device, so
a step has no host sync and a CUDA graph can capture it: the detector runs
on every frame and its candidates count only on frames whose live tracks
fell below the threshold.  That is what ``jax.vmap`` makes of the JAX
package's ``lax.cond``, and the refill is the same as with the branch.  A
threshold of 1 or more always searches and one of 0 or less never runs the
detector; both are fixed by the config.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import torch

from ..kernels import ransac as ransac_kernel
from ..stamps import GATE_BEGIN, GATE_END, stamp
from .detector import detect_features, equalize_histogram
from .klt import track_features
from .prng import prng_key
from .pyramid import build_pyramid, pyramid_shapes


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_features: int = 30  # also the slot capacity
    feature_dist: int = 20  # NMS radius for new detections
    min_harris_quality: float = 0.05
    tracked_feature_dist: float = 20.0  # keep-away radius around live tracks
    win_size: int = 21
    max_level: int = 3
    max_error: float = 0.05
    feature_search_threshold: float = 1.0
    equalize_histogram: bool = False
    flow_outlier_threshold: float = 0.0  # median-flow gate (px); 0 disables
    ransac_inlier_threshold: float = 0.0  # Sampson px; 0 disables the gate
    ransac_hypotheses: int = 64
    ransac_min_inliers: int = 8


class TrackerState(NamedTuple):
    positions: torch.Tensor  # [N, 2] float32 (x, y)
    ids: torch.Tensor  # [N] int64, -1 when free
    mask: torch.Tensor  # [N] bool
    next_id: torch.Tensor  # 0-dim int64
    pyramid: tuple  # previous frame pyramid, float32 levels
    searched: torch.Tensor  # 0-dim bool: did the last step run the detector?


def tracker_init(config: TrackerConfig, image_shape, device) -> TrackerState:
    N = config.max_features
    H, W = image_shape
    f32 = torch.float32
    pyr = tuple(
        torch.zeros(s, dtype=f32, device=device)
        for s in pyramid_shapes(H, W, config.max_level + 1)
    )
    return TrackerState(
        positions=torch.zeros(N, 2, dtype=f32, device=device),
        ids=torch.full((N,), -1, dtype=torch.int64, device=device),
        mask=torch.zeros(N, dtype=torch.bool, device=device),
        next_id=torch.zeros((), dtype=torch.int64, device=device),
        pyramid=pyr,
        searched=torch.ones((), dtype=torch.bool, device=device),
    )


def ransac_seed() -> int:
    """Seed of the RANSAC hypothesis stream (``EQVIO_RANSAC_SEED``, default 7)."""
    return int(os.environ.get("EQVIO_RANSAC_SEED", "7")) & 0xFFFFFFFF


def tracker_step(
    state: TrackerState,
    image: torch.Tensor,
    config: TrackerConfig,
    predicted: torch.Tensor | None = None,
) -> TrackerState:
    """Process one float32 frame ``[H, W]`` in [0, 1]: track live slots, drop
    failures, refill free slots with new corners under fresh ids."""
    device = image.device
    if config.equalize_histogram:
        image = equalize_histogram(image)
    pyr = build_pyramid(image, config.max_level + 1)

    new_pos, tracked = track_features(
        state.pyramid, pyr, state.positions, state.mask,
        predicted=predicted, win=config.win_size, max_error=config.max_error,
    )
    stamp(GATE_BEGIN)
    if config.ransac_inlier_threshold > 0:
        # one launch on the card; the plain gate (frontend/ransac.py) on the CPU
        tracked = ransac_kernel.ransac_mask(
            state.positions, new_pos, tracked, prng_key(ransac_seed(), device), state.next_id,
            threshold=config.ransac_inlier_threshold,
            hypotheses=config.ransac_hypotheses,
            min_inliers=config.ransac_min_inliers,
        )
    if config.flow_outlier_threshold > 0:
        tracked = _median_flow_gate(state.positions, new_pos, tracked, config.flow_outlier_threshold)
    stamp(GATE_END)
    positions = torch.where(tracked[:, None], new_pos, state.positions)
    ids = torch.where(tracked, state.ids, torch.full_like(state.ids, -1))
    mask = tracked

    N = config.max_features
    if config.feature_search_threshold <= 0.0:
        searching = torch.zeros((), dtype=torch.bool, device=device)
        cand_pos = torch.zeros(N, 2, dtype=positions.dtype, device=device)
        cand_valid = torch.zeros(N, dtype=torch.bool, device=device)
    else:
        cand_pos, cand_valid = detect_features(
            image,
            max_features=N,
            min_dist=config.feature_dist,
            quality=config.min_harris_quality,
            border=config.win_size,
            exclude=positions,
            exclude_mask=mask,
            exclude_dist=config.tracked_feature_dist,
        )
        searching = torch.ones((), dtype=torch.bool, device=device)
        if config.feature_search_threshold < 1.0:
            searching = torch.sum(mask) < config.feature_search_threshold * N
            cand_valid = cand_valid & searching
            cand_pos = torch.where(searching, cand_pos, torch.zeros_like(cand_pos))

    # fill free slots in order with valid candidates; unassigned entries
    # target the spare row N of an N+1 buffer, which is then cut off
    free = ~mask
    k = torch.arange(N, dtype=torch.int64, device=device)
    spare = torch.full_like(k, N)
    free_slots = torch.sort(torch.where(free, k, spare)).values
    cand_idx = torch.sort(torch.where(cand_valid, k, spare)).values
    n_assign = torch.minimum(torch.sum(free), torch.sum(cand_valid))
    assign = k < n_assign
    target = torch.where(assign, free_slots, spare)
    src = torch.clamp(cand_idx, 0, N - 1)
    new_ids = state.next_id + k

    pos_buf = torch.cat([positions, positions.new_zeros(1, 2)])
    pos_buf[target] = cand_pos[src]
    ids_buf = torch.cat([ids, ids.new_full((1,), -1)])
    ids_buf[target] = torch.where(assign, new_ids, torch.full_like(new_ids, -1))
    mask_buf = torch.cat([mask, mask.new_zeros(1)])
    mask_buf[target] = assign

    return TrackerState(
        positions=pos_buf[:N],
        ids=ids_buf[:N],
        mask=mask_buf[:N],
        next_id=state.next_id + n_assign,
        pyramid=tuple(pyr),
        searched=searching,
    )


def _median_flow_gate(prev: torch.Tensor, new: torch.Tensor, tracked: torch.Tensor, threshold: float):
    """Drop tracks whose flow lies ``threshold`` px or more from the tracked
    tracks' per-axis median flow (upper median; kept whole under 4 tracks).
    The median is read from the sorted flow at a device index."""
    flow = new - prev
    big = torch.full_like(flow[:, 0], 1e9)
    n_tr = torch.sum(tracked)
    med_idx = torch.clamp(n_tr // 2, 0, flow.shape[0] - 1).reshape(1)
    med = torch.cat([torch.sort(torch.where(tracked, flow[:, i], big)).values.index_select(0, med_idx)
                     for i in range(2)])
    dev = torch.linalg.norm(flow - med, dim=-1)
    return tracked & ((dev < threshold) | (n_tr < 4))
